"""Native packed collate: per-epoch batch assembly without per-graph NumPy
loops (``hl_hgat_tpu/data/fast_collate.py``).

`complex/dense.py::collate_dense_packed` is the reference: it scatters each
graph's Laplacian COO, boundary, masks, degrees, features and pooling
operators into block-diagonal dense blocks with ~15 small NumPy calls per
graph.  Here

* `FlatSamples` flattens the dataset (or a serving request,
  ``serving.RequestPacker``) once into contiguous arenas (concatenated COO,
  edge and feature arrays with prefix offsets) of what its transfer reads,
* `pack_indices` plans the bins (first-fit-decreasing under four sort
  keys) in one C call (``csrc/hlhgat_pack.cpp::ffd_pack``),
* `collate_packed_fast` fills a batch with three C calls per level
  (``csrc/hlhgat_native.cpp::packed_fill_*``, through ``native.py``); Python
  only turns the bins into slot offsets,
* `collate_packed_compact` emits the same placements in the compact
  transfer format of ``complex/compact.py`` (vectorised NumPy), which the
  trainer densifies on the card, and
* `PackedBatches` makes a loader bucket's or a request's batches under one
  set of pinned shapes.

`collate_packed_fast` equals `collate_dense_packed` array for array (the
tests assert it); there is no NumPy branch inside it: a caller that wants
the NumPy collate calls it by name.
"""

from __future__ import annotations

import dataclasses
import math
import operator

import numpy as np

from hl_hgat_tpu_torch import native
from hl_hgat_tpu_torch.complex.build import GraphSample
from hl_hgat_tpu_torch.complex.dense import _ROW_MULTIPLE, DenseBatch, DenseLevel, DensePool


def _rnd(x: int, m: int) -> int:
    """``x`` rounded up to a multiple of ``m``, at least ``m``."""
    return max(-(-int(x) // m) * m, m)


def _prefix(counts) -> np.ndarray:
    counts = np.asarray(counts, np.int64)
    off = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    return off


@dataclasses.dataclass
class _FlatLevel:
    """One level's arenas; the ``l0_*``/``l1_*`` COO fields are None in
    arenas made for the derived transfer."""

    num_nodes: np.ndarray  # [N] int32
    num_edges: np.ndarray  # [N] int32
    l0_off: np.ndarray  # [N+1] int64
    l0_rows: np.ndarray
    l0_cols: np.ndarray
    l0_vals: np.ndarray
    l1_off: np.ndarray
    l1_rows: np.ndarray
    l1_cols: np.ndarray
    l1_vals: np.ndarray
    e_off: np.ndarray  # [N+1] int64 (src/dst)
    src: np.ndarray
    dst: np.ndarray
    max_eig: np.ndarray  # [N] float64, λmax of the unscaled L0 per graph


_SAMPLE_FIELDS = operator.attrgetter("levels", "x_t", "x_s", "y")
_LEVEL_FIELDS = operator.attrgetter("num_nodes", "num_edges", "src", "dst", "max_eig")
_COO_FIELDS = operator.attrgetter("l0_rows", "l0_cols", "l0_vals", "l1_rows", "l1_cols",
                                  "l1_vals")


class FlatSamples:
    """Contiguous arenas of a sample list, level by level: once a dataset
    for the training loader, once a request for the Predictor's packer.
    ``transfer`` names the collate that reads them: ``"dense"`` (the
    default) reads every arena; ``"compact"`` reads no feature arena
    (``x_t``/``x_s`` None) and ``"derived"`` no L0/L1 COO arena either
    (their ``l0_*``/``l1_*`` fields None).  Each sample's feature rows stay
    where they are: the compact collate gathers them once, straight into
    its batch (`feature_rows`)."""

    def __init__(self, samples: list[GraphSample], *, transfer: str = "dense"):
        self.depth = len(samples[0].levels)
        self.levels: list[_FlatLevel] = []
        i32 = lambda a: np.ascontiguousarray(a, np.int32)  # noqa: E731
        f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
        cat = np.concatenate
        # one pass over each object's fields (a serving request's samples
        # are cold in the cache), the columns then concatenated
        levels, x_t, x_s, ys = zip(*map(_SAMPLE_FIELDS, samples))
        for lv in range(self.depth):
            sts = [lvls[lv] for lvls in levels]
            num_nodes, num_edges, src, dst, max_eig = zip(*map(_LEVEL_FIELDS, sts))
            ops = dict.fromkeys(f"{op}_{part}" for op in ("l0", "l1")
                                for part in ("off", "rows", "cols", "vals"))
            if transfer != "derived":
                l0_rows, l0_cols, l0_vals, l1_rows, l1_cols, l1_vals = zip(
                    *map(_COO_FIELDS, sts))
                ops.update(
                    l0_off=_prefix([r.size for r in l0_rows]), l0_rows=i32(cat(l0_rows)),
                    l0_cols=i32(cat(l0_cols)), l0_vals=f32(cat(l0_vals)),
                    l1_off=_prefix([r.size for r in l1_rows]), l1_rows=i32(cat(l1_rows)),
                    l1_cols=i32(cat(l1_cols)), l1_vals=f32(cat(l1_vals)))
            self.levels.append(_FlatLevel(
                num_nodes=i32(num_nodes), num_edges=i32(num_edges),
                e_off=_prefix([e.size for e in src]), src=i32(cat(src)), dst=i32(cat(dst)),
                max_eig=np.asarray(max_eig, np.float64), **ops))
        self.n_off = _prefix(self.levels[0].num_nodes)
        self.feature_dims = (x_t[0].shape[1], x_s[0].shape[1])
        self._features = {"x_t": x_t, "x_s": x_s}
        dense = transfer == "dense"
        self.x_t = f32(cat(x_t)) if dense else None
        self.x_s = f32(cat(x_s)) if dense else None
        # pools[k]: flattened fine→coarse assignments (−1 = dropped)
        self.c_node: list[np.ndarray] = []
        self.c_edge: list[np.ndarray] = []
        self.cn_off: list[np.ndarray] = []
        self.ce_off: list[np.ndarray] = []
        for lv in range(self.depth - 1):
            cns = [np.asarray(s.pools[lv][0]).reshape(-1) for s in samples]
            ces = [np.asarray(s.pools[lv][1]).reshape(-1) for s in samples]
            self.c_node.append(np.ascontiguousarray(cat(cns), np.int64))
            self.c_edge.append(np.ascontiguousarray(cat(ces), np.int64))
            self.cn_off.append(_prefix([c.size for c in cns]))
            self.ce_off.append(_prefix([c.size for c in ces]))
        # the labels flattened in one call, seen in both layouts below
        y_flat = cat(ys, axis=None, dtype=np.float32)
        self.y_trailing = np.shape(ys[0])[1:]
        # ragged labels (per edge) have no per-graph table
        self.y_graph = (y_flat.reshape(len(ys), -1)
                        if len({np.size(y) for y in ys}) == 1 else None)
        # per-edge labels share the level-0 edge arena's layout
        self.y_edge = y_flat.reshape(-1, math.prod(self.y_trailing))
        self.y_edge_feat = self.y_edge.shape[1]
        self.count = len(samples)

    def __len__(self) -> int:
        return self.count

    def feature_rows(self, name: str, sample_idx: np.ndarray, out: np.ndarray) -> None:
        """Samples ``sample_idx``'s rows of ``name`` (``"x_t"`` or
        ``"x_s"``), one sample after another, written into ``out``."""
        parts = self._features[name]
        np.concatenate([parts[i] for i in sample_idx.tolist()], out=out)

    @property
    def nbytes(self) -> int:
        """Bytes the arenas hold (a buffer shared by two of them counted once)."""
        arrays = [a for fl in self.levels for a in vars(fl).values()]
        arrays += [self.n_off, self.x_t, self.x_s, self.y_graph, self.y_edge, *self.c_node,
                   *self.c_edge, *self.cn_off, *self.ce_off]
        buffers = {}
        for a in arrays:
            if a is not None:
                owner = a if a.base is None else a.base
                buffers[id(owner)] = owner.nbytes
        return sum(buffers.values())


def _segment_sums(flags: np.ndarray, off: np.ndarray) -> np.ndarray:
    """Per segment [off[i], off[i+1]) of ``flags``, its count of True."""
    c = np.concatenate([[0], np.cumsum(flags.astype(np.int64))])
    return c[off[1:]] - c[off[:-1]]


# Deterministic FFD sort keys, the same as complex/dense.py::_PACK_SORT_KEYS
# (and so as the JAX package's): max(n, e), n + e, e, n.
def _sort_keys(n: np.ndarray, e: np.ndarray):
    return (np.maximum(n, e), n + e, e, n)


def pack_indices(flat: FlatSamples, indices: np.ndarray, node_cap: int,
                 edge_cap: int) -> list[list[int]]:
    """First-fit-decreasing bin packing of ``flat``'s graphs ``indices``
    under each sort key, the fewest bins kept (the earliest key on ties):
    the bins of `complex/dense.py::pack_plan`, as positions into
    ``indices``, each bin's in first-fit order.  Planned by the host
    library (``csrc/hlhgat_pack.cpp::ffd_pack``) in one call for all keys.
    A graph over the caps raises."""
    n = np.ascontiguousarray(flat.levels[0].num_nodes[indices], np.int64)
    e = np.ascontiguousarray(flat.levels[0].num_edges[indices], np.int64)
    if int(n.max()) > node_cap or int(e.max()) > edge_cap:
        bad = int(np.argmax((n > node_cap) | (e > edge_cap)))
        raise ValueError(f"graph ({n[bad]} nodes, {e[bad]} edges) exceeds pack caps "
                         f"({node_cap}, {edge_cap})")
    keys = _sort_keys(n, e)
    orders = np.stack([np.argsort(-key, kind="stable") for key in keys]).astype(np.int64)
    order, bin_of = np.empty(n.size, np.int64), np.empty(n.size, np.int64)
    nb = int(native.load().ffd_pack(n.size, n, e, len(keys), orders, node_cap, edge_cap,
                                    order, bin_of))
    # bin-major, each bin's members in visiting order
    members = order[np.argsort(bin_of, kind="stable")].tolist()
    ends = np.cumsum(np.bincount(bin_of, minlength=nb)).tolist()
    return [members[a:b] for a, b in zip([0] + ends[:-1], ends)]


@dataclasses.dataclass
class _Placements:
    """Bin-major slot layout of one packed batch (shared by the dense and
    compact collates)."""

    nb: int
    ng: int
    sample_idx: np.ndarray  # dataset index per slot
    gid: np.ndarray  # slot -> position in the batch's order
    bin_of: np.ndarray
    caps: list[tuple[int, int]]  # (node rows, edge rows) per level
    offs_n: list[np.ndarray]  # per level, node offset of each slot within its bin
    offs_e: list[np.ndarray]


def _placements(flat, indices, bins, node_cap, edge_cap, num_blocks, level_caps) -> _Placements:
    if bins is None:
        bins = pack_indices(flat, indices, node_cap, edge_cap)
    nb = len(bins)
    if num_blocks is not None:
        if nb > num_blocks:
            raise ValueError(f"packing needs {nb} blocks > cap {num_blocks}")
        nb = num_blocks
    rnd = lambda x: max(-(-x // _ROW_MULTIPLE) * _ROW_MULTIPLE, _ROW_MULTIPLE)  # noqa: E731

    # Slots are bin-major (bin order, member order), so the fills write each
    # block contiguously; gid keeps each graph's position in the batch order.
    order = np.asarray([p for members in bins for p in members], np.int64)
    sample_idx = indices[order]
    sizes = np.asarray([len(members) for members in bins], np.int64)
    bin_of = np.ascontiguousarray(np.repeat(np.arange(len(bins), dtype=np.int32), sizes))
    starts = np.cumsum(sizes) - sizes
    caps: list[tuple[int, int]] = []
    offs_n: list[np.ndarray] = []
    offs_e: list[np.ndarray] = []
    for lv in range(flat.depth):
        fills = []
        for counts in (flat.levels[lv].num_nodes, flat.levels[lv].num_edges):
            sz = counts[sample_idx].astype(np.int64)
            run = np.cumsum(sz)
            # offset within the bin: the running sum minus the bin's start
            off = run - sz - np.repeat(np.concatenate([[0], run])[starts], sizes)
            fills.append((off, int((off + sz).max()) if sz.size else 0))
        (no, max_n), (eo, max_e) = fills
        if lv == 0:
            caps.append((rnd(node_cap), rnd(edge_cap)))
        elif level_caps is not None:
            cn, ce = level_caps[lv - 1]
            if max_n > cn or max_e > ce:
                raise ValueError(f"level {lv} bin ({max_n}, {max_e}) exceeds caps ({cn}, {ce})")
            caps.append((rnd(cn), rnd(ce)))
        else:
            caps.append((rnd(max_n), rnd(max_e)))
        offs_n.append(np.ascontiguousarray(no, np.int32))
        offs_e.append(np.ascontiguousarray(eo, np.int32))
    return _Placements(nb=nb, ng=len(indices), sample_idx=sample_idx,
                       gid=order.astype(np.int32), bin_of=bin_of, caps=caps,
                       offs_n=offs_n, offs_e=offs_e)


def collate_packed_fast(
    flat: FlatSamples,
    indices,
    *,
    node_cap: int = 128,
    edge_cap: int = 128,
    y_per_edge: bool = False,
    num_blocks: int | None = None,
    level_caps: list[tuple[int, int]] | None = None,
    bins: list[list[int]] | None = None,
) -> DenseBatch:
    """``collate_dense_packed([samples[i] for i in indices], ...)``, filled
    by the host library.  ``bins`` (positions into ``indices``) may come
    from `pack_indices` beforehand, as the loader does to round the block
    count."""
    lib = native.load()
    indices = np.ascontiguousarray(indices, np.int64)
    pl = _placements(flat, indices, bins, node_cap, edge_cap, num_blocks, level_caps)
    nb, ng, nslots = pl.nb, pl.ng, len(pl.sample_idx)
    levels = []
    for lv in range(flat.depth):
        fl = flat.levels[lv]
        s_pad, e_pad = pl.caps[lv]
        l0 = np.zeros((nb, s_pad, s_pad), np.float32)
        l1 = np.zeros((nb, e_pad, e_pad), np.float32)
        b1 = np.zeros((nb, s_pad, e_pad), np.float32)
        nm = np.zeros((nb, s_pad), np.float32)
        em = np.zeros((nb, e_pad), np.float32)
        deg = np.zeros((nb, s_pad), np.float32)
        n_gid = np.full((nb, s_pad), ng, np.int32)
        s_gid = np.full((nb, e_pad), ng, np.int32)
        # bin-major slots write the same disjoint places as the NumPy
        # collate's batch order; the gids carry the batch position
        lib.packed_fill_level(
            nslots, pl.sample_idx, pl.bin_of, pl.offs_n[lv], pl.offs_e[lv],
            fl.num_nodes, fl.num_edges,
            fl.l0_off, fl.l0_rows, fl.l0_cols, fl.l0_vals,
            fl.l1_off, fl.l1_rows, fl.l1_cols, fl.l1_vals,
            fl.e_off, fl.src, fl.dst, pl.gid, s_pad, e_pad,
            l0, l1, b1, nm, em, deg, n_gid, s_gid)
        levels.append(DenseLevel(l0=l0, l1=l1, b1=b1, node_mask=nm, edge_mask=em, deg=deg,
                                 num_graphs=ng, n_gid=n_gid, s_gid=s_gid))

    pools = []
    for lv in range(flat.depth - 1):
        (sf, ef), (sc, ec) = pl.caps[lv], pl.caps[lv + 1]
        p_t = np.zeros((nb, sc, sf), np.float32)
        p_s = np.zeros((nb, ec, ef), np.float32)
        lib.packed_fill_pool(
            nslots, pl.sample_idx, pl.bin_of,
            pl.offs_n[lv], pl.offs_e[lv], pl.offs_n[lv + 1], pl.offs_e[lv + 1],
            flat.cn_off[lv], flat.c_node[lv], flat.ce_off[lv], flat.c_edge[lv],
            nb, sc, sf, ec, ef, p_t, p_s)
        pools.append(DensePool(p_t=p_t, p_s=p_s))

    (s0, e0), lvl0 = pl.caps[0], flat.levels[0]

    def rows(arena, off, slot_off, pad):
        out = np.zeros((nb, pad, arena.shape[1]), np.float32)
        lib.packed_fill_rows(nslots, pl.sample_idx, pl.bin_of, slot_off, off, arena,
                             arena.shape[1], pad, out)
        return out

    x_t = rows(flat.x_t, flat.n_off, pl.offs_n[0], s0)
    x_s = rows(flat.x_s, lvl0.e_off, pl.offs_e[0], e0)
    if y_per_edge:
        y = rows(flat.y_edge, lvl0.e_off, pl.offs_e[0], e0).reshape(
            (nb, e0) + flat.y_trailing)
    else:
        y = flat.y_graph[indices]
    return DenseBatch(x_t=x_t, x_s=x_s, y=y, levels=tuple(levels), num_graphs=ng,
                      pools=tuple(pools))


def collate_packed_compact(
    flat: FlatSamples,
    indices,
    *,
    node_cap: int = 128,
    edge_cap: int = 128,
    y_per_edge: bool = False,
    num_blocks: int | None = None,
    level_caps: list[tuple[int, int]] | None = None,
    bins: list[list[int]] | None = None,
    nnz_caps=None,
    pool_caps: list[int] | None = None,
    operators: str = "coo",
    row_caps: tuple[int, int] | None = None,
):
    """The packed batch of `collate_packed_fast` in the compact transfer
    format (``complex/compact.py``): the same placements, the operators as
    COO triplets that ``compact.inflate`` densifies on the batch's device;
    ``inflate(collate_packed_compact(...))`` equals
    ``collate_packed_fast(...)``.

    ``operators='derived'`` ships only B1 and per-graph 2/λmax and rebuilds
    L0, L1 and the degrees on the device (≤ 1 ulp from the host values).
    No masks cross (derived from the gids on the device), id columns are
    int16 where the range fits, and only the real feature rows ship, with
    their flat destinations (the JAX ``slim`` and ``pack_rows``).  Exact.
    ``nnz_caps``, ``pool_caps`` and ``row_caps`` pin the shapes across
    batches (else each rounds up to ``compact.NNZ_MULTIPLE`` or
    ``ROW_MULTIPLE``).  Vectorised NumPy."""
    from hl_hgat_tpu_torch.complex.compact import (
        NNZ_MULTIPLE, ROW_MULTIPLE, CompactBatch, CompactPool, _gather_ranges, _pad_ids,
        _round_cap, compact_operators, flat_positions)

    indices = np.ascontiguousarray(indices, np.int64)
    pl = _placements(flat, indices, bins, node_cap, edge_cap, num_blocks, level_caps)
    nb, ng, sample_idx, bin_of = pl.nb, pl.ng, pl.sample_idx, pl.bin_of
    levels = compact_operators(flat, sample_idx, pl.gid, bin_of, pl.offs_n, pl.offs_e,
                               pl.caps, nb, ng, nnz_caps=nnz_caps, operators=operators)

    lvl0 = flat.levels[0]
    (s0, e0) = pl.caps[0]
    rows0 = flat_positions(bin_of, pl.offs_n[0], lvl0.num_nodes[sample_idx], s0)
    cols0 = flat_positions(bin_of, pl.offs_e[0], lvl0.num_edges[sample_idx], e0)
    ft, fs = flat.feature_dims
    n_flat, e_flat = nb * s0, nb * e0
    if row_caps is not None:
        ncap, ecap = row_caps
    else:
        # finer than the nnz caps (features are wide), never beyond the
        # dense row count
        ncap = min(_round_cap(rows0.size, ROW_MULTIPLE), n_flat)
        ecap = min(_round_cap(cols0.size, ROW_MULTIPLE), e_flat)
    if rows0.size > ncap or cols0.size > ecap:
        raise ValueError(f"feature rows ({rows0.size}, {cols0.size}) exceed row_caps "
                         f"({ncap}, {ecap})")
    # each slot's rows, gathered straight into the padded arrays
    x_t = np.zeros((ncap, ft), np.float32)
    flat.feature_rows("x_t", sample_idx, x_t[: rows0.size])
    x_s = np.zeros((ecap, fs), np.float32)
    flat.feature_rows("x_s", sample_idx, x_s[: cols0.size])
    # padding entries point one past the last row: the dump row
    x_t_rows = _pad_ids(rows0, ncap, n_flat, n_flat)
    x_s_rows = _pad_ids(cols0, ecap, e_flat, e_flat)

    pools = []
    for lv in range(flat.depth - 1):
        (sf, ef), (sc, ec) = pl.caps[lv], pl.caps[lv + 1]
        ents = []
        for c_arr, c_off, fine_off, coarse_off in (
                (flat.c_node[lv], flat.cn_off[lv], pl.offs_n[lv], pl.offs_n[lv + 1]),
                (flat.c_edge[lv], flat.ce_off[lv], pl.offs_e[lv], pl.offs_e[lv + 1])):
            assign = c_arr[_gather_ranges(c_off, sample_idx)]
            sz = (c_off[sample_idx + 1] - c_off[sample_idx]).astype(np.int64)
            local = np.arange(int(sz.sum()), dtype=np.int64) - np.repeat(np.cumsum(sz) - sz, sz)
            b = np.repeat(bin_of, sz)
            r = assign + np.repeat(coarse_off.astype(np.int64), sz)
            c = local + np.repeat(fine_off.astype(np.int64), sz)
            keep = assign >= 0
            ents.append((b[keep], r[keep], c[keep]))
        (tb, tr, tc), (sb, sr, sc_col) = ents
        cap = (pool_caps[lv] if pool_caps is not None
               else _round_cap(max(tb.size, sb.size), NNZ_MULTIPLE))
        if tb.size > cap or sb.size > cap:
            raise ValueError(f"pool {lv} entries ({tb.size}, {sb.size}) exceed cap {cap}")
        pools.append(CompactPool(
            t_b=_pad_ids(tb, cap, nb, nb), t_r=_pad_ids(tr, cap, 0, sc),
            t_c=_pad_ids(tc, cap, 0, sf),
            s_b=_pad_ids(sb, cap, nb, nb), s_r=_pad_ids(sr, cap, 0, ec),
            s_c=_pad_ids(sc_col, cap, 0, ef),
            sc=sc, sf=sf, ec=ec, ef=ef))

    if y_per_edge:
        # edge-level labels pack with the edge rows (sharing x_s_rows)
        ye_rows = flat.y_edge[_gather_ranges(lvl0.e_off, sample_idx)]
        y = np.zeros((x_s.shape[0],) + flat.y_trailing, np.float32)
        y.reshape(x_s.shape[0], -1)[: cols0.size] = ye_rows.reshape(cols0.size, -1)
    else:
        y = flat.y_graph[indices]
    return CompactBatch(x_t=x_t, x_s=x_s, y=y, levels=tuple(levels), pools=tuple(pools),
                        num_graphs=ng, x_t_rows=x_t_rows, x_s_rows=x_s_rows,
                        y_packed=y_per_edge)


def batch_row_pad(counts: np.ndarray, batch_size: int) -> int:
    """The rows a batch of ``batch_size`` of these graphs may need: the sum
    of the ``batch_size`` largest ``counts``, a set smaller than a batch
    filled with its smallest, rounded up to ``_ROW_MULTIPLE``."""
    counts = np.asarray(counts, np.int64)
    k = min(batch_size, counts.size)
    top = np.partition(counts, counts.size - k)[counts.size - k:]
    return _rnd(int(top.sum()) + (batch_size - k) * int(top.min()), _ROW_MULTIPLE)


def filler_index(num_nodes: np.ndarray, num_edges: np.ndarray) -> int:
    """The graph that fills a short final batch: the smallest by nodes +
    edges, the first such."""
    return int(np.argmin(np.asarray(num_nodes, np.int64) + num_edges))


class PackedBatches:
    """Packed batches of ``flat``'s graphs under one set of shapes: a
    training loader's bucket, or one serving request.  Called with a
    batch's indices into ``flat``, it plans the bins (`pack_indices`) and
    collates them in ``transfer``'s format: ``"dense"`` with the block count
    rounded up to a multiple of 16, ``"compact"`` / ``"derived"`` with the
    block count and entry caps pinned (seeded from the first batch with a
    margin, raised only where a batch exceeds them) and the feature rows
    fixed by ``row_pads``, the worst-case level-0 (node, edge) row totals
    (`batch_row_pad`).  Coarse levels are packed on level 0's caps, which
    bound them."""

    def __init__(self, flat: FlatSamples, *, transfer: str, node_cap: int, edge_cap: int,
                 y_per_edge: bool, row_pads: tuple[int, int]):
        from hl_hgat_tpu_torch.complex.compact import ROW_MULTIPLE

        if transfer not in ("dense", "compact", "derived"):
            raise ValueError(f"unknown transfer {transfer!r}")
        self.flat, self.transfer, self.y_per_edge = flat, transfer, y_per_edge
        self.node_cap, self.edge_cap = node_cap, edge_cap
        self.row_caps = tuple(_rnd(x, ROW_MULTIPLE) for x in row_pads)
        self.pins: dict | None = None
        if transfer != "dense":
            # per-sample counts of kept pool entries (assignment >= 0)
            self.pool_kept = [
                tuple(_segment_sums(c >= 0, off) for c, off in (
                    (flat.c_node[lv], flat.cn_off[lv]), (flat.c_edge[lv], flat.ce_off[lv])))
                for lv in range(flat.depth - 1)]

    def caps(self, idx: np.ndarray, n_bins: int):
        """The pinned (num_blocks, nnz_caps, pool_caps) of a batch of
        ``n_bins`` bins; an operator arena ``flat`` lacks (a derived
        request's) needs no entries."""
        from hl_hgat_tpu_torch.complex.compact import NNZ_MULTIPLE

        need = {"blocks": n_bins, "nnz": [], "pool": []}
        for fl in self.flat.levels:
            need["nnz"].append(tuple(0 if off is None else int((off[idx + 1] - off[idx]).sum())
                                     for off in (fl.l0_off, fl.l1_off, fl.e_off)))
        for t, s in self.pool_kept:
            need["pool"].append(max(int(t[idx].sum()), int(s[idx].sum())))
        margin = lambda x, m: _rnd(x + max(x // 16, m // 2), m)  # noqa: E731
        pins = self.pins
        if pins is None:
            self.pins = pins = {
                "blocks": _rnd(need["blocks"] + 4, 4),
                "nnz": [tuple(margin(x, NNZ_MULTIPLE) for x in tri) for tri in need["nnz"]],
                "pool": [margin(x, NNZ_MULTIPLE) for x in need["pool"]]}
        else:  # raise any exceeded field
            if need["blocks"] > pins["blocks"]:
                pins["blocks"] = _rnd(need["blocks"] + 4, 4)
            pins["nnz"] = [tuple(margin(x, NNZ_MULTIPLE) if x > c else c
                                 for x, c in zip(tri, cur))
                           for tri, cur in zip(need["nnz"], pins["nnz"])]
            pins["pool"] = [margin(x, NNZ_MULTIPLE) if x > c else c
                            for x, c in zip(need["pool"], pins["pool"])]
        return pins["blocks"], pins["nnz"], pins["pool"]

    def __call__(self, idx: np.ndarray):
        flat = self.flat
        bins = pack_indices(flat, idx, self.node_cap, self.edge_cap)
        kw = dict(node_cap=self.node_cap, edge_cap=self.edge_cap, y_per_edge=self.y_per_edge,
                  bins=bins, level_caps=[(self.node_cap, self.edge_cap)] * (flat.depth - 1))
        if self.transfer == "dense":
            return collate_packed_fast(flat, idx, num_blocks=_rnd(len(bins), 16), **kw)
        num_blocks, nnz_caps, pool_caps = self.caps(idx, len(bins))
        return collate_packed_compact(
            flat, idx, num_blocks=num_blocks, nnz_caps=nnz_caps, pool_caps=pool_caps,
            operators="derived" if self.transfer == "derived" else "coo",
            row_caps=self.row_caps, **kw)
