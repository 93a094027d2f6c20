"""Packed dense-block batch layout, NumPy build + torch transfer.

Port of ``hl_hgat_tpu/complex/dense.py``: several small graphs share one
[S, S] tile with block-diagonal operators, and ``n_gid``/``s_gid`` carry
each row's graph id (padding rows point at ``num_graphs``, the dump
bucket).  Every sparse op of the model becomes a batched dense matmul on
[G, S, *] tiles.  A pooled sample's coarsened levels are packed into the
same blocks as level 0, and each coarsening step becomes a pair of dense
averaging operators (`DensePool`).

A graph larger than one block spans consecutive blocks (spill mode, the
large-graph layout of TSP-500 instances): within-block entries stay dense,
entries that couple a block to its neighbour (column block = row block ± 1)
go to the two band operators of a `BlockDiagMatrix` and the rest to a COO
spill over the flattened block rows.  ``reorder_sample`` (BFS locality
order) keeps most cross-block entries in the bands.

Datasets whose samples all share one structure (the brain family) take
``collate_dense_shared``: one graph a block, the operators built once with
a leading axis of 1 ([1, S, S]) and broadcast over the [G, S, C] features.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.batch import ComplexBatch, CooMatrix
from hl_hgat_tpu_torch.complex.build import GraphSample, boundary_dense


def _to(v, device):
    if v is None:
        return None
    if isinstance(v, (CooMatrix, BlockDiagMatrix)):
        return v.to(device)
    return torch.as_tensor(v).to(device)


@dataclasses.dataclass
class BlockDiagMatrix:
    """Dense block-diagonal operator plus its cross-block entries, for
    batches with a graph over one block.

    ``blocks`` [G, S, S] holds the within-block entries.  ``band_up`` /
    ``band_dn`` [G, S, S] hold the entries of row block g in column block
    g + 1 / g − 1 (batched matmuls over block-shifted operands).  ``spill``
    is a `CooMatrix` over the flattened G·S rows and columns holding the
    entries two or more blocks off the diagonal.  Absent parts are None.
    """

    blocks: Any  # [G, S, S]
    spill: Any = None  # CooMatrix over (G*S, G*S) flat slots
    band_up: Any = None  # [G, S, S]: row block g, column block g+1
    band_dn: Any = None  # [G, S, S]: row block g, column block g-1

    def to(self, device) -> "BlockDiagMatrix":
        return BlockDiagMatrix(*(_to(getattr(self, f.name), device)
                                 for f in dataclasses.fields(self)))


def shift_blocks(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[g] = x[g + k] for k = ±1, zero past the ends (block axis 0): the
    operand alignment of a band, ``band_up`` (k = 1) or ``band_dn`` (k = −1)."""
    zero = torch.zeros_like(x[:1])
    if k == 1:
        return torch.cat([x[1:], zero], dim=0)
    return torch.cat([zero, x[:-1]], dim=0)


@dataclasses.dataclass
class DenseLevel:
    """One level in packed dense-block layout (NumPy arrays or tensors).
    ``l0``/``l1`` are [G, S, S] arrays, or `BlockDiagMatrix` where a graph
    spans blocks; B1's cross-block entries ride ``b1_bu``/``b1_bd`` (node
    rows of block g against edge columns of block g ± 1) and ``b1_sp``."""

    l0: Any  # [G, S, S] or BlockDiagMatrix
    l1: Any  # [G, E, E] or BlockDiagMatrix
    b1: Any  # [G, S, E] signed incidence (−1 src, +1 dst)
    node_mask: Any  # [G, S]
    edge_mask: Any  # [G, E]
    deg: Any  # [G, S]
    num_graphs: int
    # [G, S] / [G, E] int32 graph id of each row, padding rows = num_graphs;
    # None in the shared layout (``collate_dense_shared``: one graph a block)
    n_gid: Any = None
    s_gid: Any = None
    b1_sp: Any = None  # CooMatrix (G*S, G*E): B1 entries two or more blocks off
    b1_bu: Any = None  # [G, S, E]: node rows of block g, edge columns of g+1
    b1_bd: Any = None  # [G, S, E]: the same against edge columns of g-1

    def to(self, device) -> "DenseLevel":
        return dataclasses.replace(
            self,
            **{
                f.name: _to(getattr(self, f.name), device)
                for f in dataclasses.fields(self)
                if f.name != "num_graphs"
            },
        )


@dataclasses.dataclass
class DensePool:
    """Fine→coarse averaging operators of one coarsening step, row-stochastic
    over each coarse row's members.  ``p_t_sp``/``p_s_sp`` carry the
    entries whose coarse and fine rows lie in different blocks (spill
    mode), already divided by the member count, so dense and spill sum to
    the scatter mean."""

    p_t: Any  # [G, S_c, S_f]
    p_s: Any  # [G, E_c, E_f]
    p_t_sp: Any = None  # CooMatrix over (G*S_c, G*S_f)
    p_s_sp: Any = None  # CooMatrix over (G*E_c, G*E_f)

    def to(self, device) -> "DensePool":
        return DensePool(*(_to(getattr(self, f.name), device)
                           for f in dataclasses.fields(self)))


@dataclasses.dataclass
class DenseBatch:
    x_t: Any  # [G, S, Ft]
    x_s: Any  # [G, E, Fs]
    y: Any  # [num_graphs, ...], or [G, E, ...] per edge
    levels: tuple[DenseLevel, ...]
    num_graphs: int
    pools: tuple[DensePool, ...] = ()

    @property
    def level0(self) -> DenseLevel:
        return self.levels[0]

    def replace(self, **kw) -> "DenseBatch":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "DenseBatch":
        """Every array as a tensor on ``device``."""
        return DenseBatch(
            x_t=_to(self.x_t, device),
            x_s=_to(self.x_s, device),
            y=_to(self.y, device),
            levels=tuple(lvl.to(device) for lvl in self.levels),
            num_graphs=self.num_graphs,
            pools=tuple(p.to(device) for p in self.pools),
        )


# Either layout of a batch: what the models and the trainer take.
Batch = DenseBatch | ComplexBatch


# Deterministic FFD sort keys, best-of kept.  Must stay identical to
# hl_hgat_tpu/complex/dense.py::_PACK_SORT_KEYS (same orders, same tie-break)
# so both packages place every graph in the same slot.
_PACK_SORT_KEYS = (
    lambda n, e: max(n, e),
    lambda n, e: n + e,
    lambda n, e: e,
    lambda n, e: n,
)


def pack_plan(
    samples: list[GraphSample], node_cap: int, edge_cap: int, *,
    allow_span: bool = True,
) -> tuple[list[list[int]], dict[int, int]]:
    """First-fit-decreasing bin packing by level-0 (nodes, edges), tried
    under each sort key in ``_PACK_SORT_KEYS``; the fewest bins win, the
    earliest key on ties.  Returns (bins, spans).

    A graph over either cap becomes a bin of its own spanning
    ``max(⌈n/node_cap⌉, ⌈e/edge_cap⌉)`` consecutive blocks (``spans[i]``);
    spanning bins come first.  With ``allow_span=False`` such a graph
    raises instead.
    """
    spans: dict[int, int] = {}
    packable: list[int] = []
    for i, s in enumerate(samples):
        n, e = s.num_nodes, s.num_edges
        if n > node_cap or e > edge_cap:
            if not allow_span:
                raise ValueError(
                    f"graph {i} ({n} nodes, {e} edges) exceeds pack caps "
                    f"({node_cap}, {edge_cap})"
                )
            spans[i] = max(-(-n // node_cap), -(-e // edge_cap))
        else:
            packable.append(i)

    def ffd(order: list[int]) -> list[list[int]]:
        bins: list[list[int]] = []
        rem_n: list[int] = []
        rem_e: list[int] = []
        for i in order:
            n, e = samples[i].num_nodes, samples[i].num_edges
            for b in range(len(rem_n)):
                if rem_n[b] >= n and rem_e[b] >= e:
                    bins[b].append(i)
                    rem_n[b] -= n
                    rem_e[b] -= e
                    break
            else:
                bins.append([i])
                rem_n.append(node_cap - n)
                rem_e.append(edge_cap - e)
        return bins

    best: list[list[int]] | None = None
    for key in _PACK_SORT_KEYS:
        order = sorted(
            packable,
            key=lambda i: (-key(samples[i].num_nodes, samples[i].num_edges), i),
        )
        bins = ffd(order)
        if best is None or len(bins) < len(best):
            best = bins
    return [[i] for i in spans] + best, spans


def pack_graphs(samples: list[GraphSample], node_cap: int, edge_cap: int) -> list[list[int]]:
    """The bins of ``pack_plan`` for graphs that each fit one block; a graph
    over the caps raises."""
    return pack_plan(samples, node_cap, edge_cap, allow_span=False)[0]


def bfs_node_order(src, dst, num_nodes: int) -> np.ndarray:
    """BFS relabelling (old → new id) so that neighbours land in nearby
    slots: seeds in id order, a FIFO queue, and each node's neighbours in
    the order of the JAX package's linked adjacency lists (the (dst, src)
    incidences from the last edge back, then the (src, dst) ones), so both
    packages give every graph the same order."""
    e = len(src)
    owner = np.concatenate([np.asarray(src), np.asarray(dst)]).astype(np.int64)
    other = np.concatenate([np.asarray(dst), np.asarray(src)]).astype(np.int64)
    # a list is walked from its newest insertion back
    order = np.lexsort((-np.arange(2 * e), owner))
    nbrs = other[order].tolist()
    starts = np.searchsorted(owner[order], np.arange(num_nodes + 1)).tolist()
    seen = [False] * num_nodes
    visit: list[int] = []
    for seed in range(num_nodes):
        if seen[seed]:
            continue
        seen[seed] = True
        queue = collections.deque([seed])
        while queue:
            u = queue.popleft()
            visit.append(u)
            for v in nbrs[starts[u]:starts[u + 1]]:
                if not seen[v]:
                    seen[v] = True
                    queue.append(v)
    out = np.empty(num_nodes, np.int64)
    out[np.asarray(visit, np.int64)] = np.arange(num_nodes)
    return out


def reorder_sample(sample: GraphSample, *, y_per_edge: bool = False) -> GraphSample:
    """Locality-permute level 0: BFS node order, edges sorted by their
    (new) endpoints.  Edge orientations, and so B1's signs, are kept; the
    model's per-graph outputs are unchanged and per-simplex outputs move
    with their features and labels.  Only level 0 is permuted; the first
    pool assignment is re-indexed."""
    st = sample.levels[0]
    n, e = st.num_nodes, st.num_edges
    nperm = bfs_node_order(st.src, st.dst, n)  # old → new
    new_src = nperm[st.src]
    new_dst = nperm[st.dst]
    ekey = np.minimum(new_src, new_dst) * (n + 1) + np.maximum(new_src, new_dst)
    e_order = np.argsort(ekey, kind="stable")  # new position → old index
    eperm = np.empty(e, np.int64)  # old → new
    eperm[e_order] = np.arange(e)
    new_level = dataclasses.replace(
        st,
        src=new_src[e_order].astype(np.int32),
        dst=new_dst[e_order].astype(np.int32),
        l0_rows=nperm[st.l0_rows].astype(np.int32),
        l0_cols=nperm[st.l0_cols].astype(np.int32),
        l1_rows=eperm[st.l1_rows].astype(np.int32),
        l1_cols=eperm[st.l1_cols].astype(np.int32),
    )
    n_new2old = np.empty(n, np.int64)
    n_new2old[nperm] = np.arange(n)
    pools = list(sample.pools)
    if pools:
        c_node, c_edge = pools[0]
        pools[0] = (np.asarray(c_node).reshape(-1)[n_new2old],
                    np.asarray(c_edge).reshape(-1)[e_order])
    return dataclasses.replace(
        sample, x_t=sample.x_t[n_new2old], x_s=sample.x_s[e_order],
        y=sample.y[e_order] if y_per_edge else sample.y,
        levels=[new_level] + list(sample.levels[1:]), pools=pools,
    )


# Block rows round up to this multiple; a spill's nnz pads up to the other
# (the JAX package's defaults, so both packages pack to the same shapes).
_ROW_MULTIPLE = 8
_SPILL_PAD_MULTIPLE = 256


def _make_spill(rows, cols, vals, shape, *, symmetric=False):
    """A spill entry list as a `CooMatrix`, its nnz padded up to a multiple
    of ``_SPILL_PAD_MULTIPLE`` with (0, 0, 0.0) entries; None when empty."""
    nnz = rows.shape[0]
    if nnz == 0:
        return None
    pad = -(-nnz // _SPILL_PAD_MULTIPLE) * _SPILL_PAD_MULTIPLE - nnz
    return CooMatrix(
        rows=np.pad(rows.astype(np.int32), (0, pad)),
        cols=np.pad(cols.astype(np.int32), (0, pad)),
        vals=np.pad(vals.astype(np.float32), (0, pad)),
        shape=shape, symmetric=symmetric,
    )


def collate_dense_packed(
    samples: list[GraphSample],
    *,
    node_cap: int = 128,
    edge_cap: int = 128,
    y_per_edge: bool = False,
    bins: list[list[int]] | None = None,
    spans: dict[int, int] | None = None,
    num_blocks: int | None = None,
    level_caps: list[tuple[int, int]] | None = None,
) -> DenseBatch:
    """Pack several graphs per dense block (block-diagonal operators), as
    ``hl_hgat_tpu.complex.dense.collate_dense_packed``.

    Level-0 blocks have (node_cap, edge_cap) rows, each rounded up to a
    multiple of ``_ROW_MULTIPLE``; the graph→block plan is ``bins``/
    ``spans``, or ``pack_plan``'s.  Coarser levels reuse level 0's
    assignment with the caps of their largest bin (rounded up), or
    ``level_caps`` [(nodes, edges)] per level ≥ 1; a bin over its caps
    raises.

    A graph over the caps spans consecutive blocks (spill mode: every level
    then takes level 0's caps).  Its operator entries within one block stay
    dense, those of neighbouring blocks go to the band operators and the
    rest to COO spills (nnz padded to ``_SPILL_PAD_MULTIPLE``); a level's
    L0 / L1 becomes a `BlockDiagMatrix` only where it has such entries.
    Per coarsening step a `DensePool` holds the row-stochastic averaging
    operators (each coarse row averages its fine members; deleted edges
    and padding belong to no row), with spills of their own.

    ``y_per_edge`` lays the labels out like x_s, [G, E, ...], 0 on padding.
    ``num_blocks`` pads the block count to a fixed number (the extra blocks
    all padding), for shapes that stay the same from batch to batch; a
    plan that needs more blocks raises.
    """
    if bins is None:
        bins, spans = pack_plan(samples, node_cap, edge_cap)
    elif spans is None:
        spans = {}
    ng = len(samples)
    depth = len(samples[0].levels)
    rnd = lambda x: max(-(-x // _ROW_MULTIPLE) * _ROW_MULTIPLE, _ROW_MULTIPLE)  # noqa: E731
    spill_mode = bool(spans)

    def spanning(members):
        return len(members) == 1 and members[0] in spans

    # first block of each bin (a spanning bin takes several)
    block_of_bin: list[int] = []
    nb = 0
    for members in bins:
        block_of_bin.append(nb)
        nb += spans[members[0]] if spanning(members) else 1
    if num_blocks is not None:
        if nb > num_blocks:
            raise ValueError(f"packing needs {nb} blocks > cap {num_blocks}")
        nb = num_blocks

    # per level: the block shape and every graph's global (node, edge) slot
    caps: list[tuple[int, int]] = []
    offs: list[dict[int, tuple[int, int]]] = []
    for lv in range(depth):
        fill = [(sum(samples[i].levels[lv].num_nodes for i in members),
                 sum(samples[i].levels[lv].num_edges for i in members))
                for members in bins if not spanning(members)] or [(0, 0)]
        max_n, max_e = max(n for n, _ in fill), max(e for _, e in fill)
        if lv == 0 or spill_mode:
            s_lv, e_lv = rnd(node_cap), rnd(edge_cap)
        elif level_caps is not None:
            cn, ce = level_caps[lv - 1]
            if max_n > cn or max_e > ce:
                raise ValueError(f"level {lv} bin ({max_n}, {max_e}) exceeds caps ({cn}, {ce})")
            s_lv, e_lv = rnd(cn), rnd(ce)
        else:
            s_lv, e_lv = rnd(max_n), rnd(max_e)
        if max_n > s_lv or max_e > e_lv:
            raise ValueError(f"bin overflow at level {lv}: ({max_n}, {max_e}) > ({s_lv}, {e_lv})")
        caps.append((s_lv, e_lv))
        placement: dict[int, tuple[int, int]] = {}
        for b, members in enumerate(bins):
            no = eo = 0
            for i in members:
                placement[i] = (block_of_bin[b] * s_lv + no, block_of_bin[b] * e_lv + eo)
                no += samples[i].levels[lv].num_nodes
                eo += samples[i].levels[lv].num_edges
        offs.append(placement)

    def finish(spill, shape, symmetric=False):
        if not spill[0]:
            return None
        return _make_spill(*(np.concatenate(part) for part in spill), shape,
                           symmetric=symmetric)

    levels = []
    for lv in range(depth):
        s_pad, e_pad = caps[lv]
        l0 = np.zeros((nb, s_pad, s_pad), np.float32)
        l1 = np.zeros((nb, e_pad, e_pad), np.float32)
        b1 = np.zeros((nb, s_pad, e_pad), np.float32)
        nm = np.zeros((nb * s_pad,), np.float32)
        em = np.zeros((nb * e_pad,), np.float32)
        deg = np.zeros((nb * s_pad,), np.float32)
        n_gid = np.full((nb * s_pad,), ng, np.int32)
        s_gid = np.full((nb * e_pad,), ng, np.int32)
        spills = {key: ([], [], []) for key in ("l0", "l1", "b1")}
        bands: dict[str, np.ndarray] = {}  # allocated on first use

        def put(dense, r_gl, c_gl, v, s_r, s_c, key):
            """Entries at global (row, col) slots: same block → ``dense``,
            neighbouring column block → a band, the rest → the spill."""
            br, bc = r_gl // s_r, c_gl // s_c
            r, c = r_gl % s_r, c_gl % s_c
            same = br == bc
            dense[br[same], r[same], c[same]] = v[same]
            if same.all():
                return
            for side, sel in (("u", bc == br + 1), ("d", bc == br - 1)):
                if sel.any():
                    band = bands.setdefault(key + side, np.zeros((nb, s_r, s_c), np.float32))
                    band[br[sel], r[sel], c[sel]] = v[sel]
            far = np.abs(bc - br) >= 2
            if far.any():
                for part, arr in zip(spills[key], (r_gl, c_gl, v)):
                    part.append(arr[far])

        for i, s in enumerate(samples):
            st = s.levels[lv]
            ns, es = offs[lv][i]
            n, e = st.num_nodes, st.num_edges
            put(l0, ns + st.l0_rows.astype(np.int64), ns + st.l0_cols.astype(np.int64),
                st.l0_vals, s_pad, s_pad, "l0")
            put(l1, es + st.l1_rows.astype(np.int64), es + st.l1_cols.astype(np.int64),
                st.l1_vals, e_pad, e_pad, "l1")
            ecols = es + np.arange(e, dtype=np.int64)
            put(b1, ns + st.src.astype(np.int64), ecols, -np.ones(e, np.float32),
                s_pad, e_pad, "b1")
            put(b1, ns + st.dst.astype(np.int64), ecols, np.ones(e, np.float32),
                s_pad, e_pad, "b1")
            nm[ns : ns + n] = 1.0
            em[es : es + e] = 1.0
            np.add.at(deg, ns + st.src, 1.0)
            np.add.at(deg, ns + st.dst, 1.0)
            n_gid[ns : ns + n] = i
            s_gid[es : es + e] = i

        def operator(blocks, key, rows):
            spill = finish(spills[key], (nb * rows, nb * rows), symmetric=True)
            up, dn = bands.get(key + "u"), bands.get(key + "d")
            if spill is None and up is None and dn is None:
                return blocks
            return BlockDiagMatrix(blocks, spill, up, dn)

        levels.append(DenseLevel(
            l0=operator(l0, "l0", s_pad),
            l1=operator(l1, "l1", e_pad),
            b1=b1,
            node_mask=nm.reshape(nb, s_pad),
            edge_mask=em.reshape(nb, e_pad),
            deg=deg.reshape(nb, s_pad),
            num_graphs=ng,
            n_gid=n_gid.reshape(nb, s_pad),
            s_gid=s_gid.reshape(nb, e_pad),
            b1_sp=finish(spills["b1"], (nb * s_pad, nb * e_pad)),
            b1_bu=bands.get("b1u"),
            b1_bd=bands.get("b1d"),
        ))

    pools = []
    for lv in range(depth - 1):
        mats = []
        for which in (0, 1):  # nodes, edges
            rows_c, rows_f = caps[lv + 1][which], caps[lv][which]
            p = np.zeros((nb, rows_c, rows_f), np.float32)
            cnt = np.zeros(nb * rows_c, np.float64)
            ents = []
            for i, s in enumerate(samples):
                assign = np.asarray(s.pools[lv][which]).reshape(-1)
                members = np.nonzero(assign >= 0)[0]
                r_gl = offs[lv + 1][i][which] + assign[members].astype(np.int64)
                c_gl = offs[lv][i][which] + members.astype(np.int64)
                np.add.at(cnt, r_gl, 1.0)
                ents.append((r_gl, c_gl))
            spill = ([], [], [])
            for r_gl, c_gl in ents:
                # each coarse row averages its members over the whole graph
                v = (1.0 / np.maximum(cnt[r_gl], 1.0)).astype(np.float32)
                br, bc = r_gl // rows_c, c_gl // rows_f
                same = br == bc
                p[br[same], r_gl[same] % rows_c, c_gl[same] % rows_f] = v[same]
                if not same.all():
                    for part, arr in zip(spill, (r_gl, c_gl, v)):
                        part.append(arr[~same])
            mats += [p, finish(spill, (nb * rows_c, nb * rows_f))]
        pools.append(DensePool(p_t=mats[0], p_s=mats[2], p_t_sp=mats[1], p_s_sp=mats[3]))

    (s0, e0), ft, fs = caps[0], samples[0].x_t.shape[1], samples[0].x_s.shape[1]
    x_t = np.zeros((nb * s0, ft), np.float32)
    x_s = np.zeros((nb * e0, fs), np.float32)
    for i, s in enumerate(samples):
        ns, es = offs[0][i]
        x_t[ns : ns + s.num_nodes] = s.x_t
        x_s[es : es + s.num_edges] = s.x_s
    if y_per_edge:
        tail = np.asarray(samples[0].y).shape[1:]
        y = np.zeros((nb * e0,) + tail, np.float32)
        for i, s in enumerate(samples):
            es = offs[0][i][1]
            y[es : es + s.num_edges] = s.y
        y = y.reshape((nb, e0) + tail)
    else:
        y = np.stack([np.asarray(s.y, np.float32).reshape(-1) for s in samples])
    return DenseBatch(
        x_t=x_t.reshape(nb, s0, ft),
        x_s=x_s.reshape(nb, e0, fs),
        y=y,
        levels=tuple(levels),
        num_graphs=ng,
        pools=tuple(pools),
    )


def collate_dense_shared(samples: list[GraphSample]) -> DenseBatch:
    """Dense layout for shared-skeleton datasets
    (``hl_hgat_tpu/complex/dense.py::collate_dense_shared``): every sample
    must carry the same structure, operator values and pooling assignments
    at every level (else ValueError), so ``l0``/``l1``/``b1`` and the pools
    are built once from ``samples[0]`` with a leading axis of 1 ([1, S, S],
    [1, S_c, S_f]) and every mat-vec is one [S, S] @ [S, G·C] product over
    all subjects.  Features, masks and degrees are per graph, [G, S, *],
    one graph a block with its rows in the samples' own simplex order (no
    BFS reorder) and no padding rows, so flatten readouts see the reference
    ordering.  The levels carry no graph ids (``n_gid``/``s_gid`` are
    None)."""
    g = len(samples)
    ref = samples[0]
    depth = len(ref.levels)
    for smp in samples[1:]:
        for lv in range(depth):
            a, b = ref.levels[lv], smp.levels[lv]
            if not (np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst)):
                raise ValueError("collate_dense_shared requires identical structure "
                                 f"across samples (level {lv} differs)")
            if not (np.array_equal(a.l0_vals, b.l0_vals) and np.array_equal(a.l1_vals, b.l1_vals)):
                raise ValueError("collate_dense_shared requires identical operator values "
                                 f"across samples (level {lv} L0/L1 differ)")
        for lv, (pa, pb) in enumerate(zip(ref.pools, smp.pools)):
            if not (np.array_equal(pa[0], pb[0]) and np.array_equal(pa[1], pb[1])):
                raise ValueError("collate_dense_shared requires identical pooling "
                                 f"assignments across samples (pool {lv} differs)")

    levels = []
    for st in ref.levels:
        n, e = st.num_nodes, st.num_edges
        l0 = np.zeros((1, n, n), np.float32)
        l1 = np.zeros((1, e, e), np.float32)
        l0[0, st.l0_rows, st.l0_cols] = st.l0_vals
        l1[0, st.l1_rows, st.l1_cols] = st.l1_vals
        b1 = boundary_dense(st.src, st.dst, n)[None].astype(np.float32)
        nm = np.ones((g, n), np.float32)
        em = np.ones((g, e), np.float32)
        deg = np.zeros((g, n), np.float32)
        np.add.at(deg[0], st.src, 1.0)
        np.add.at(deg[0], st.dst, 1.0)
        deg[1:] = deg[0]
        levels.append(DenseLevel(l0=l0, l1=l1, b1=b1, node_mask=nm, edge_mask=em, deg=deg,
                                 num_graphs=g))

    pools = []
    for lv in range(depth - 1):
        fine, coarse = ref.levels[lv], ref.levels[lv + 1]
        mats = []
        for assign, rows, cols in ((ref.pools[lv][0], coarse.num_nodes, fine.num_nodes),
                                   (ref.pools[lv][1], coarse.num_edges, fine.num_edges)):
            p = np.zeros((1, rows, cols), np.float32)
            a = np.asarray(assign).reshape(-1)
            idx = np.nonzero(a >= 0)[0]
            p[0, a[idx], idx] = 1.0
            p[0] /= np.maximum(p[0].sum(axis=1, keepdims=True), 1.0)
            mats.append(p)
        pools.append(DensePool(p_t=mats[0], p_s=mats[1]))

    x_t = np.stack([smp.x_t for smp in samples]).astype(np.float32)
    x_s = np.stack([smp.x_s for smp in samples]).astype(np.float32)
    y = np.stack([np.asarray(smp.y, np.float32).reshape(-1) for smp in samples])
    return DenseBatch(x_t=x_t, x_s=x_s, y=y, levels=tuple(levels), num_graphs=g,
                      pools=tuple(pools))
