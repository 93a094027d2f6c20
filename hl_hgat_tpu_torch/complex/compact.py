"""Compact transfer format of packed dense batches and its inflate on the
card (``hl_hgat_tpu/complex/compact.py``).

A packed `DenseBatch` holds every operator as dense [B, S, S] float32 blocks,
~95 % of its bytes and ~99 % of them zeros (a ZINC-sized graph has ~73 L0
entries in a 16384-slot tile).  The loader can ship a `CompactBatch`
instead: only the real feature rows with their flat destinations, the
graph ids (the masks are derived from them on the device), the operators
as fixed-size COO triplets, every id column int16 where its range fits;
`inflate` scatters them into the dense blocks on the batch's device at
step entry (the trainer does so).  The scatter is one pass of writes;
equality with the dense collate is held by the tests.  These are the JAX
module's defaults (``slim``, ``pack_rows``), here the only behaviour.

Three places where this differs from the JAX module, none in the result:
torch has no ``mode="drop"`` scatter, so every scatter here writes into one
extra dump block (padding entries carry block id ``nb``) or one extra dump
row (padding feature rows point at ``nb·S``) that is sliced off; int16
ids cross the link as int16 and widen to int64 on the device; the
derived mode's Gram products are one ``torch.bmm`` each (0/±1 entries and
small integer sums, exact in TF32 and float32 alike), then one multiply by
the per-graph scale, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.dense import DenseBatch, DenseLevel, DensePool


def _to(v, device):
    return None if v is None else torch.as_tensor(v).to(device)


def _fields_to(obj, device):
    """``obj`` with every array field as a tensor on ``device``."""
    return dataclasses.replace(obj, **{
        f.name: _to(getattr(obj, f.name), device) for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), (np.ndarray, torch.Tensor))})


@dataclasses.dataclass
class CompactLevel:
    """One level: dense row metadata and COO operators (block-local indices).

    Padding entries carry block id ``num_blocks``; `inflate` writes them
    into a dump block it drops.

    **Derived mode** (``operators='derived'``): the L0/L1 triplets and the
    degrees are None and only B1 and per-graph spectral scales cross the
    link; `inflate` rebuilds L0 = (B1·B1ᵀ)·(2/λmax) and L1 = (B1ᵀ·B1)·(2/λmax)
    with two batched products on the device (the products are small exact
    integers, so the only rounding is the final multiply: ≤ 1 ulp from the
    host values, which multiply in float64 first).
    """

    # COO of the block-diagonal L0 [nnz0_cap]: block, row, col, value (None
    # in derived mode)
    l0_b: Any
    l0_r: Any
    l0_c: Any
    l0_v: Any
    # COO of L1 [nnz1_cap] (None in derived mode)
    l1_b: Any
    l1_r: Any
    l1_c: Any
    l1_v: Any
    # boundary pairs [e_cap]: block, src row, dst row, edge column
    e_b: Any
    e_src: Any
    e_dst: Any
    e_col: Any
    deg: Any  # None in derived mode (|B1| row sums on the device)
    # graph ids per row [B, S] / [B, E], int16 where the range fits (as
    # every id column); a row is real iff its gid is < num_graphs, so no
    # mask crosses the link
    n_gid: Any
    s_gid: Any
    # per-graph 2/λmax indexed by gid, a trailing 0 for the padding bucket:
    # [num_graphs + 1] float32 (None outside derived mode)
    g_scale: Any
    num_graphs: int
    s_pad: int
    e_pad: int

    @property
    def num_blocks(self) -> int:
        return self.n_gid.shape[0]

    def to(self, device) -> "CompactLevel":
        return _fields_to(self, device)


@dataclasses.dataclass
class CompactPool:
    """Fine→coarse assignment triplets [cap]: block, coarse row, fine
    column; `inflate` row-normalises them to means."""

    t_b: Any
    t_r: Any
    t_c: Any
    s_b: Any
    s_r: Any
    s_c: Any
    sc: int
    sf: int
    ec: int
    ef: int

    def to(self, device) -> "CompactPool":
        return _fields_to(self, device)


@dataclasses.dataclass
class CompactBatch:
    """Row-packed features: ``x_t`` is [row_cap, F] holding only real rows
    and ``x_t_rows``/``x_s_rows`` give each row's flat destination in the
    dense [B·S, F] layout (padding entries point one past the end, at the
    dump row).  ``y`` packs the same way, with ``x_s_rows``, when it has a
    row per level-0 edge (``y_packed``)."""

    x_t: Any
    x_s: Any
    y: Any
    levels: tuple[CompactLevel, ...]
    pools: tuple[CompactPool, ...]
    num_graphs: int
    x_t_rows: Any
    x_s_rows: Any
    y_packed: bool = False

    def to(self, device) -> "CompactBatch":
        """Every array as a tensor on ``device``, ids in their transfer
        dtype (int16 where the range fits)."""
        return dataclasses.replace(
            self, x_t=_to(self.x_t, device), x_s=_to(self.x_s, device),
            y=_to(self.y, device), x_t_rows=_to(self.x_t_rows, device),
            x_s_rows=_to(self.x_s_rows, device),
            levels=tuple(lv.to(device) for lv in self.levels),
            pools=tuple(p.to(device) for p in self.pools))


def _real_rows(gid, num_graphs: int):
    real = gid < num_graphs
    return real.float() if isinstance(real, torch.Tensor) else real.astype(np.float32)


def level_node_mask(lv):
    """[B, S] float32 validity mask (array or tensor, as the level holds),
    derived from the gids."""
    return _real_rows(lv.n_gid, lv.num_graphs)


def level_edge_mask(lv):
    return _real_rows(lv.s_gid, lv.num_graphs)


def _scatter3(nb: int, rows: int, cols: int, b, r, c, v) -> torch.Tensor:
    """Dense [nb, rows, cols] from COO; entries of block ``nb`` (padding)
    land in a dump block that is dropped."""
    out = torch.zeros((nb + 1) * rows * cols, dtype=torch.float32, device=b.device)
    out[(b.long() * rows + r.long()) * cols + c.long()] = v
    return out.view(nb + 1, rows, cols)[:nb]


def _scatter_rows(packed: torch.Tensor, rows, nb: int, pad: int) -> torch.Tensor:
    """Row-packed features → dense [nb, pad, *]; padding rows (index
    nb·pad) go to a dump row that is dropped."""
    flat = packed.new_zeros((nb * pad + 1,) + tuple(packed.shape[1:]))
    flat[rows.long()] = packed
    return flat[: nb * pad].view((nb, pad) + tuple(packed.shape[1:]))


def inflate(batch: CompactBatch) -> DenseBatch:
    """CompactBatch → DenseBatch, as torch ops on the batch's device."""
    lv0 = batch.levels[0]
    nb0 = lv0.num_blocks
    x_t = _scatter_rows(batch.x_t, batch.x_t_rows, nb0, lv0.s_pad)
    x_s = _scatter_rows(batch.x_s, batch.x_s_rows, nb0, lv0.e_pad)
    y = batch.y
    if batch.y_packed:  # edge-level labels pack with the edge rows
        y = _scatter_rows(y, batch.x_s_rows, nb0, lv0.e_pad)
    levels = []
    for lv in batch.levels:
        nb, ng = lv.num_blocks, lv.num_graphs
        n_gid, s_gid = lv.n_gid.int(), lv.s_gid.int()
        node_mask, edge_mask = level_node_mask(lv), level_edge_mask(lv)
        # the (src, -1) entries first, then (dst, +1), as the JAX scatters
        e_b = torch.cat([lv.e_b, lv.e_b])
        e_r = torch.cat([lv.e_src, lv.e_dst])
        e_c = torch.cat([lv.e_col, lv.e_col])
        sign = torch.cat([torch.full(lv.e_b.shape, -1.0, device=e_b.device),
                          torch.ones(lv.e_b.shape, device=e_b.device)])
        b1 = _scatter3(nb, lv.s_pad, lv.e_pad, e_b, e_r, e_c, sign)
        if lv.l0_v is not None:
            l0 = _scatter3(nb, lv.s_pad, lv.s_pad, lv.l0_b, lv.l0_r, lv.l0_c, lv.l0_v)
            l1 = _scatter3(nb, lv.e_pad, lv.e_pad, lv.l1_b, lv.l1_r, lv.l1_c, lv.l1_v)
            deg = lv.deg
        else:
            # derived: L0/L1 from B1.  The Gram products are small integers;
            # only the ×(2/λmax) rounds.  Padding rows of B1 are zero and
            # the dump bucket's scale is 0, so padding stays zero.
            g_scale = lv.g_scale
            l0 = torch.bmm(b1, b1.transpose(1, 2)) * g_scale[n_gid.long()][..., None]
            l1 = torch.bmm(b1.transpose(1, 2), b1) * g_scale[s_gid.long()][..., None]
            deg = b1.abs().sum(dim=2)
        levels.append(DenseLevel(l0=l0, l1=l1, b1=b1, node_mask=node_mask,
                                 edge_mask=edge_mask, deg=deg, num_graphs=ng,
                                 n_gid=n_gid, s_gid=s_gid))
    pools = []
    nb = levels[0].b1.shape[0]
    for pl in batch.pools:
        p_t = _scatter3(nb, pl.sc, pl.sf, pl.t_b, pl.t_r, pl.t_c, 1.0)
        p_s = _scatter3(nb, pl.ec, pl.ef, pl.s_b, pl.s_r, pl.s_c, 1.0)
        p_t = p_t / p_t.sum(dim=2, keepdim=True).clamp_min(1.0)
        p_s = p_s / p_s.sum(dim=2, keepdim=True).clamp_min(1.0)
        pools.append(DensePool(p_t=p_t, p_s=p_s))
    return DenseBatch(x_t=x_t, x_s=x_s, y=y, levels=tuple(levels), num_graphs=batch.num_graphs,
                      pools=tuple(pools))


def maybe_inflate(batch):
    """Inflate a compact batch; pass any other batch through (trainer hook)."""
    return inflate(batch) if isinstance(batch, CompactBatch) else batch


# ---------------------------------------------------------------------------
# host-side compaction (vectorised over the FlatSamples arenas)
# ---------------------------------------------------------------------------


def _gather_ranges(off: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Concatenated [off[i], off[i+1]) ranges for i in idx."""
    counts = (off[idx + 1] - off[idx]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    starts = np.repeat(off[idx], counts)
    seg_starts = np.repeat(np.cumsum(counts) - counts, counts)
    return starts + (np.arange(total, dtype=np.int64) - seg_starts)


def _ids_dtype(maxval: int):
    return np.int16 if int(maxval) < 2**15 else np.int32


def _pad_ids(a: np.ndarray, cap: int, fill: int, maxval: int) -> np.ndarray:
    """``a`` padded to ``cap`` with ``fill``, int16 when the value range
    fits, else int32."""
    out = np.full(cap, fill, _ids_dtype(max(int(maxval), int(fill))))
    out[: a.size] = a
    return out


def _pad_f32(a: np.ndarray, cap: int) -> np.ndarray:
    out = np.zeros(cap, np.float32)
    out[: a.size] = a
    return out


# Fixed-size COO and feature-row arrays round up to these multiples unless
# the caller pins their sizes (the JAX package's defaults).
NNZ_MULTIPLE = 2048
ROW_MULTIPLE = 256


def _round_cap(n: int, multiple: int) -> int:
    return max(-(-n // multiple) * multiple, multiple)


def flat_positions(bin_of: np.ndarray, offs: np.ndarray, sizes: np.ndarray,
                   pad: int) -> np.ndarray:
    """Flat [nb·pad] destination of every row: slot g's rows land at
    bin_of[g]·pad + offs[g] + (0..sizes[g])."""
    sizes = sizes.astype(np.int64)
    local = np.arange(int(sizes.sum()), dtype=np.int64) - np.repeat(np.cumsum(sizes) - sizes,
                                                                      sizes)
    return (np.repeat(bin_of.astype(np.int64), sizes) * pad
            + np.repeat(offs.astype(np.int64), sizes) + local)


def compact_operators(
    flat,
    sample_idx: np.ndarray,
    gid: np.ndarray,
    bin_of: np.ndarray,
    offs_n: list[np.ndarray],
    offs_e: list[np.ndarray],
    caps: list[tuple[int, int]],
    nb: int,
    ng: int,
    nnz_caps: list[tuple[int, int, int]] | None = None,
    operators: str = "coo",
) -> list[CompactLevel]:
    """The compact levels of a packed batch (placements from
    ``data/fast_collate.py``); ``nnz_caps`` pins the (L0, L1, edge) entry
    counts per level, else each rounds up to ``NNZ_MULTIPLE``.

    ``operators='derived'`` ships only B1 and per-graph 2/λmax.  No masks;
    every id column int16 where its range fits.  Exact."""
    if operators not in ("coo", "derived"):
        raise ValueError(f"unknown operators mode {operators!r}")
    derived = operators == "derived"
    levels = []
    for lv in range(flat.depth):
        fl = flat.levels[lv]
        s_pad, e_pad = caps[lv]
        gid_dt = _ids_dtype(ng)
        deg = np.zeros((nb, s_pad), np.float32)
        n_gid = np.full((nb, s_pad), ng, gid_dt)
        s_gid = np.full((nb, e_pad), ng, gid_dt)
        n_sz = fl.num_nodes[sample_idx].astype(np.int64)
        e_sz = fl.num_edges[sample_idx].astype(np.int64)
        rows_flat = flat_positions(bin_of, offs_n[lv], n_sz, s_pad)
        n_gid.reshape(-1)[rows_flat] = np.repeat(gid, n_sz).astype(gid_dt)
        cols_flat = flat_positions(bin_of, offs_e[lv], e_sz, e_pad)
        s_gid.reshape(-1)[cols_flat] = np.repeat(gid, e_sz).astype(gid_dt)

        # operators as COO with block-local indices
        coo = {}
        if not derived:
            for which, off, rws, cls, vls, offs in (
                    ("l0", fl.l0_off, fl.l0_rows, fl.l0_cols, fl.l0_vals, offs_n[lv]),
                    ("l1", fl.l1_off, fl.l1_rows, fl.l1_cols, fl.l1_vals, offs_e[lv])):
                g = _gather_ranges(off, sample_idx)
                cnt = (off[sample_idx + 1] - off[sample_idx]).astype(np.int64)
                o = np.repeat(offs, cnt)
                coo[which] = (np.repeat(bin_of, cnt), rws[g] + o, cls[g] + o, vls[g])
        ge = _gather_ranges(fl.e_off, sample_idx)
        e_b = np.repeat(bin_of, e_sz)
        no_e = np.repeat(offs_n[lv], e_sz)
        e_src = fl.src[ge] + no_e
        e_dst = fl.dst[ge] + no_e
        e_col = (cols_flat - np.repeat(bin_of.astype(np.int64), e_sz) * e_pad).astype(np.int32)
        if not derived:
            # degree: one increment per edge endpoint
            base = np.repeat(bin_of.astype(np.int64), e_sz) * s_pad
            np.add.at(deg.reshape(-1), base + e_src, 1.0)
            np.add.at(deg.reshape(-1), base + e_dst, 1.0)

        nnz0 = 0 if derived else coo["l0"][3].size
        nnz1 = 0 if derived else coo["l1"][3].size
        if nnz_caps is not None:
            cap0, cap1, cape = nnz_caps[lv]
        else:
            cap0 = 0 if derived else _round_cap(nnz0, NNZ_MULTIPLE)
            cap1 = 0 if derived else _round_cap(nnz1, NNZ_MULTIPLE)
            cape = _round_cap(e_col.size, NNZ_MULTIPLE)
        if nnz0 > cap0 or nnz1 > cap1 or e_col.size > cape:
            raise ValueError(f"level {lv} nnz ({nnz0}, {nnz1}, {e_col.size}) exceeds caps "
                             f"({cap0}, {cap1}, {cape})")
        if derived:
            g_scale = np.zeros(ng + 1, np.float32)
            g_scale[gid] = (2.0 / fl.max_eig[sample_idx]).astype(np.float32)
            op_fields = dict(l0_b=None, l0_r=None, l0_c=None, l0_v=None, l1_b=None,
                             l1_r=None, l1_c=None, l1_v=None, deg=None, g_scale=g_scale)
        else:
            op_fields = dict(deg=deg, g_scale=None)
            for which, cap, size in (("l0", cap0, s_pad), ("l1", cap1, e_pad)):
                b, r, c, v = coo[which]
                op_fields.update({
                    f"{which}_b": _pad_ids(b, cap, nb, nb),
                    f"{which}_r": _pad_ids(r, cap, 0, size),
                    f"{which}_c": _pad_ids(c, cap, 0, size), f"{which}_v": _pad_f32(v, cap)})
        levels.append(CompactLevel(
            e_b=_pad_ids(e_b, cape, nb, nb), e_src=_pad_ids(e_src, cape, 0, s_pad),
            e_dst=_pad_ids(e_dst, cape, 0, s_pad), e_col=_pad_ids(e_col, cape, 0, e_pad),
            n_gid=n_gid, s_gid=s_gid, num_graphs=ng, s_pad=s_pad, e_pad=e_pad,
            **op_fields))
    return levels
