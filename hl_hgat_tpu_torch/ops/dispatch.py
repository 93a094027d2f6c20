"""Layout-polymorphic graph primitives (``hl_hgat_tpu/ops/dispatch.py``).

Every model op exists in two layouts sharing one call site:

* **flat** (`ComplexLevel`, `CooMatrix`): gathers and segment sums on
  [N, C] rows.  A symmetric `CooMatrix` that carries ELL arrays multiplies
  through the hand-written row-gather kernel (``ops/ell_spmm.py``), forward
  and backward; without ELL arrays it takes the COO scatter
  (``ops/spmm.py``).
* **dense-block** (`DenseLevel`, [G, S, S] tensors, or [1, S, S] shared
  by every graph of a ``collate_dense_shared`` batch): batched matmuls on
  [G, S, *] tiles; outside the Laguerre kernels these are plain GEMMs, left
  to ``torch.matmul`` as the JAX package left them to XLA.  A matmul
  accumulates in float32 and rounds its result to the activation dtype.
  Where a graph spans blocks (a `BlockDiagMatrix`, ``b1_bu``/``b1_bd``/
  ``b1_sp``, the pool spills), the band operators add two batched matmuls
  over block-shifted operands and the far entries a gather and one
  ``index_add`` over the flattened rows: the JAX package's XLA route, with
  no Pallas kernel there either.

A level of one complex sharded over the ranks of a graph group
(`parallel.graph_parallel.ShardedLevel`, its operators `HaloShard`s) sends
each op that crosses the row partition through a collective here: the
mat-vecs and boundary couplings through the halo exchange, the readouts and
the pooling through an ``all_reduce`` (``parallel/graph_parallel.py``).

Modules call these functions and never branch themselves.
"""

from __future__ import annotations

import dataclasses

import torch

from hl_hgat_tpu_torch.complex.batch import ComplexLevel, CooMatrix, PoolMap
from hl_hgat_tpu_torch.complex.dense import BlockDiagMatrix, shift_blocks
from hl_hgat_tpu_torch.ops import boundary as B
from hl_hgat_tpu_torch.ops.ell_spmm import spmm_ell_symmetric
from hl_hgat_tpu_torch.ops.segment import segment_mean, segment_mean_onehot
from hl_hgat_tpu_torch.ops.spmm import spmm_coo
from hl_hgat_tpu_torch.ops.tensor_cache import TensorCache, tensor_version
from hl_hgat_tpu_torch.parallel.graph_parallel import (
    HaloShard,
    ShardedLevel,
    halo_matvec,
    sharded_mean,
    sharded_pool,
)


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[g] @ b[g] in b's dtype (float32 accumulation inside the GEMM).  A
    shared operator a [1, M, S] against b [G, S, C] (``collate_dense_shared``)
    is one [M, S] @ [S, G·C] GEMM over all graphs, as the JAX package's
    broadcast einsum: the graph axis is folded into the columns and back."""
    a = a.to(b.dtype)
    if a.shape[0] == 1 and b.shape[0] != 1:
        g, s = b.shape[:2]
        cols = b.movedim(0, 1).reshape(s, -1)
        return torch.matmul(a[0], cols).reshape(a.shape[1], g, *b.shape[2:]).movedim(1, 0)
    return torch.matmul(a, b)


def _t2s_mm(b1: torch.Tensor, x_t: torch.Tensor) -> torch.Tensor:
    # einsum('gse,gsf->gef'): B1ᵀ-style contraction over the row axis
    return _bmm(b1.transpose(1, 2), x_t)


def _band_add(y, bu, bd, x, *, transpose: bool = False, absolute: bool = False):
    """y plus the nearest-neighbour block coupling of a band pair
    (`BlockDiagMatrix.band_up`/``band_dn``, ``b1_bu``/``b1_bd``; None
    where absent), the operators taken in x's dtype (their absolute values
    with ``absolute``).

    Forward: y[g] += U[g] @ x[g+1] + D[g] @ x[g-1].
    Transpose: y[g] += U[g-1]ᵀ @ x[g-1] + D[g+1]ᵀ @ x[g+1].
    """
    def prep(m):
        return (m.abs() if absolute else m).to(x.dtype)

    if not transpose:
        if bu is not None:
            y = y + _bmm(prep(bu), shift_blocks(x, 1))
        if bd is not None:
            y = y + _bmm(prep(bd), shift_blocks(x, -1))
        return y
    if bu is not None:
        y = y + shift_blocks(_t2s_mm(prep(bu), x), -1)
    if bd is not None:
        y = y + shift_blocks(_t2s_mm(prep(bd), x), 1)
    return y


def _spill_add(y, spill: CooMatrix | None, x, *, transpose: bool = False,
               absolute: bool = False):
    """y + (S, Sᵀ with ``transpose``, |S| with ``absolute``) @ x over the
    flattened block rows: x and y are [G, S, C] tensors, the spill indexes
    their G·S rows.  Each entry's product is formed in x's dtype and added
    into a copy of y's buffer in y's dtype by one ``index_add`` (padding
    entries are (0, 0, 0.0)); autograd transposes it into the mirror
    gather and ``index_add``.  On the card the additions land in no fixed
    order, so bfloat16 sums may round differently from call to call."""
    if spill is None:
        return y
    flat = x.reshape(-1, x.shape[-1])
    rows, cols = (spill.cols, spill.rows) if transpose else (spill.rows, spill.cols)
    vals = spill.vals.abs() if absolute else spill.vals
    contrib = vals.to(flat.dtype)[:, None] * flat.index_select(0, cols)
    out = y.reshape(-1, y.shape[-1]).index_add(0, rows, contrib.to(y.dtype))
    return out.reshape(y.shape)


def lap_matvec(lap, x: torch.Tensor) -> torch.Tensor:
    """L @ x for a `CooMatrix` (flat x [N, ...], trailing axes flattened
    for the product), dense blocks (lap [G, S, S], x [G, S, C]) or a
    `BlockDiagMatrix` (blocks, bands, spill), or a `HaloShard` (this rank's
    rows of a graph-sharded operator, x its [c_local, ...] rows)."""
    if isinstance(lap, CooMatrix):
        flat = x.reshape(x.shape[0], -1)
        if lap.ell_cols is not None and lap.symmetric:
            out = spmm_ell_symmetric(lap.ell_cols, lap.ell_vals, flat)
        else:
            out = spmm_coo(lap.rows, lap.cols, lap.vals, flat, lap.shape[0])
        return out.reshape(x.shape)
    if isinstance(lap, BlockDiagMatrix):
        out = _band_add(_bmm(lap.blocks, x), lap.band_up, lap.band_dn, x)
        return _spill_add(out, lap.spill, x)
    if isinstance(lap, HaloShard):
        return halo_matvec(lap, x)
    return _bmm(lap, x)


def abs_b1_s2t(level, x_s: torch.Tensor) -> torch.Tensor:
    """|B1| @ x_s (each node gathers its incident edges)."""
    if isinstance(level, ShardedLevel):
        return halo_matvec(level.b1_abs, x_s)
    if isinstance(level, ComplexLevel):
        return B.boundary_abs_s2t(
            x_s, level.src, level.dst, level.num_nodes, edge_mask=level.edge_mask)
    out = _band_add(_bmm(level.b1.abs(), x_s), level.b1_bu, level.b1_bd, x_s, absolute=True)
    return _spill_add(out, level.b1_sp, x_s, absolute=True)


def abs_b1_t2s(level, x_t: torch.Tensor) -> torch.Tensor:
    """|B1|ᵀ @ x_t (each edge sums its endpoints)."""
    if isinstance(level, ShardedLevel):
        return halo_matvec(level.b1t_abs, x_t)
    if isinstance(level, ComplexLevel):
        return B.boundary_abs_t2s(x_t, level.src, level.dst, edge_mask=level.edge_mask)
    out = _band_add(_t2s_mm(level.b1.abs(), x_t), level.b1_bu, level.b1_bd, x_t,
                    transpose=True, absolute=True)
    return _spill_add(out, level.b1_sp, x_t, transpose=True, absolute=True)


def b1_t2s(level, x_t: torch.Tensor) -> torch.Tensor:
    """B1ᵀ @ x_t (signed endpoint difference)."""
    if isinstance(level, ShardedLevel):
        return halo_matvec(level.b1t, x_t)
    if isinstance(level, ComplexLevel):
        return B.boundary_t2s(x_t, level.src, level.dst, edge_mask=level.edge_mask)
    out = _band_add(_t2s_mm(level.b1, x_t), level.b1_bu, level.b1_bd, x_t, transpose=True)
    return _spill_add(out, level.b1_sp, x_t, transpose=True)


# The one-hot readout matrix costs 6 B per (row, graph) pair in the JAX
# package (an f32 and a bf16 copy); above this budget it takes the scatter.
_MATMUL_READOUT_MAX_BYTES = 48 * 1024 * 1024
_MATMUL_READOUT_BYTES_PER_ELEM = 6


def _packed_mean(x, gid, mask, num_graphs):
    flat = x.reshape(-1, x.shape[-1])
    gid = gid.reshape(-1)
    w = mask.reshape(-1)
    if (flat.shape[0] * num_graphs * _MATMUL_READOUT_BYTES_PER_ELEM
            <= _MATMUL_READOUT_MAX_BYTES):
        return segment_mean_onehot(flat, gid, num_graphs, weights=w)
    return segment_mean(flat, gid, num_graphs, weights=w)


def _block_mean(x, mask):
    """One graph a block (``collate_dense_shared``, no graph ids): the
    masked mean over each block's rows, in float32 as the JAX package's
    promotion gives it."""
    m = mask[..., None].float()
    return (x.float() * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


def masked_mean_nodes(level, x: torch.Tensor, num_graphs: int):
    """Per-graph mean over valid nodes → [num_graphs, F]."""
    if isinstance(level, ShardedLevel):
        return sharded_mean(x, level.n_id, num_graphs, level.node_mask, level.group)
    if isinstance(level, ComplexLevel):
        return segment_mean(x, level.n_id, num_graphs, weights=level.node_mask)
    if level.n_gid is None:
        return _block_mean(x, level.node_mask)
    return _packed_mean(x, level.n_gid, level.node_mask, num_graphs)


def masked_mean_edges(level, x: torch.Tensor, num_graphs: int):
    """Per-graph mean over valid edges → [num_graphs, F]."""
    if isinstance(level, ShardedLevel):
        return sharded_mean(x, level.s_id, num_graphs, level.edge_mask, level.group)
    if isinstance(level, ComplexLevel):
        return segment_mean(x, level.s_id, num_graphs, weights=level.edge_mask)
    if level.s_gid is None:
        return _block_mean(x, level.edge_mask)
    return _packed_mean(x, level.s_gid, level.edge_mask, num_graphs)


def pool_to_coarse(pool, fine, coarse, x_t: torch.Tensor, x_s: torch.Tensor):
    """Mean of each coarse node's (edge's) fine members, either layout:
    flat, a weighted segment mean over the `PoolMap` (padding and deleted
    edges weigh 0 or land in the dump slot); dense, the `DensePool`
    averaging operators as batched GEMMs plus their spills.  Coarse padding
    rows are zeroed (the dense branch multiplies by the float32 mask, as the
    JAX package does).  On a `ShardedLevel` the coarse owners may be other
    ranks: the sums meet in an ``all_reduce``."""
    if isinstance(fine, ShardedLevel):
        return sharded_pool(pool, fine, coarse, x_t, x_s)
    if isinstance(pool, PoolMap):
        x_t_c = segment_mean(x_t, pool.pos_t, coarse.num_nodes, weights=fine.node_mask)
        x_s_c = segment_mean(x_s, pool.pos_s, coarse.num_edges, weights=fine.edge_mask)
        return (x_t_c * coarse.node_mask[:, None].to(x_t_c.dtype),
                x_s_c * coarse.edge_mask[:, None].to(x_s_c.dtype))
    return (_spill_add(_bmm(pool.p_t, x_t), pool.p_t_sp, x_t) * coarse.node_mask[..., None],
            _spill_add(_bmm(pool.p_s, x_s), pool.p_s_sp, x_s) * coarse.edge_mask[..., None])


_casts = TensorCache()  # (operator tensor, (dtype, inference mode)) -> (cast, its version)


def _cast_tensor(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in ``dtype``, made once while t lives unedited: a model casts its
    batch's operators on every forward, and the band kernels prepare their
    operator once per tensor (``laguerre_dense.band_operator``), so a batch
    must hand them one bfloat16 L, not a new one a forward.  The cast lives
    as long as t, and is made anew if it was edited in place.  A tensor that
    needs a gradient, or is already in ``dtype``, is cast as it comes."""
    if t.dtype == dtype or t.requires_grad:
        return t.to(dtype)
    tag = (dtype, torch.is_inference_mode_enabled())
    hit = _casts.lookup(t, tag)
    if hit is not None and tensor_version(hit[0]) == hit[1]:
        return hit[0]
    out = t.to(dtype)
    _casts.put(t, tag, (out, tensor_version(out)))
    return out


def _cast(m, dtype: torch.dtype):
    """An operator part in ``dtype``: a tensor, a `CooMatrix`'s COO and ELL
    values, every part of a `BlockDiagMatrix`; None stays None."""
    if m is None:
        return None
    if isinstance(m, CooMatrix):
        return dataclasses.replace(
            m, vals=_cast_tensor(m.vals, dtype),
            ell_vals=None if m.ell_vals is None else _cast_tensor(m.ell_vals, dtype))
    if isinstance(m, BlockDiagMatrix):
        return BlockDiagMatrix(*(_cast(getattr(m, f.name), dtype)
                                 for f in dataclasses.fields(m)))
    if isinstance(m, torch.Tensor):
        return _cast_tensor(m, dtype)
    return m.to(dtype)


def cast_operators(batch, dtype: torch.dtype):
    """Cast the operators (dense L0, L1, B1 and pool matrices with their
    bands and spills; COO and ELL values) to the compute dtype, so bf16
    activations meet bf16 operators in every product.  Masks, degrees and
    segment ids keep their dtypes (they feed divisions and segment ops)."""
    if dtype == torch.float32:
        return batch

    def cast_level(lvl):
        if isinstance(lvl, ComplexLevel):
            return dataclasses.replace(lvl, l0=_cast(lvl.l0, dtype), l1=_cast(lvl.l1, dtype))
        return dataclasses.replace(
            lvl, **{name: _cast(getattr(lvl, name), dtype)
                    for name in ("l0", "l1", "b1", "b1_sp", "b1_bu", "b1_bd")})

    def cast_pool(p):
        if isinstance(p, PoolMap):
            return p
        return dataclasses.replace(
            p, **{name: _cast(getattr(p, name), dtype)
                  for name in ("p_t", "p_s", "p_t_sp", "p_s_sp")})

    return batch.replace(levels=tuple(cast_level(lvl) for lvl in batch.levels),
                         pools=tuple(cast_pool(p) for p in batch.pools))


def apply_node_mask(level, x: torch.Tensor) -> torch.Tensor:
    return x * level.node_mask[..., None].to(x.dtype)


def apply_edge_mask(level, x: torch.Tensor) -> torch.Tensor:
    return x * level.edge_mask[..., None].to(x.dtype)
