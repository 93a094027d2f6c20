"""Layout-polymorphic graph primitives (``hl_hgat_tpu/ops/dispatch.py``).

Every model op exists in two layouts sharing one call site:

* **flat** (`ComplexLevel`, `CooMatrix`): gathers and segment sums on
  [N, C] rows.  A symmetric `CooMatrix` that carries ELL arrays multiplies
  through the hand-written row-gather kernel (``ops/ell_spmm.py``), forward
  and backward; without ELL arrays it takes the COO scatter
  (``ops/spmm.py``).
* **dense-block** (`DenseLevel`, [G, S, S] tensors): batched matmuls on
  [G, S, *] tiles; outside the Laguerre kernels these are plain GEMMs, left
  to ``torch.matmul`` as the JAX package left them to XLA.  A matmul
  accumulates in float32 and rounds its result to the activation dtype.

Modules call these functions and never branch themselves.
"""

from __future__ import annotations

import dataclasses

import torch

from hl_hgat_tpu_torch.complex.batch import ComplexLevel, CooMatrix
from hl_hgat_tpu_torch.ops import boundary as B
from hl_hgat_tpu_torch.ops.ell_spmm import spmm_ell_symmetric
from hl_hgat_tpu_torch.ops.segment import segment_mean, segment_mean_onehot
from hl_hgat_tpu_torch.ops.spmm import spmm_coo


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[g] @ b[g] in b's dtype (float32 accumulation inside the GEMM)."""
    return torch.matmul(a.to(b.dtype), b)


def lap_matvec(lap, x: torch.Tensor) -> torch.Tensor:
    """L @ x for a `CooMatrix` (flat x [N, ...], trailing axes flattened
    for the product) or dense blocks (lap [G, S, S], x [G, S, C])."""
    if isinstance(lap, CooMatrix):
        flat = x.reshape(x.shape[0], -1)
        if lap.ell_cols is not None and lap.symmetric:
            out = spmm_ell_symmetric(lap.ell_cols, lap.ell_vals, flat)
        else:
            out = spmm_coo(lap.rows, lap.cols, lap.vals, flat, lap.shape[0])
        return out.reshape(x.shape)
    return _bmm(lap, x)


def abs_b1_s2t(level, x_s: torch.Tensor) -> torch.Tensor:
    """|B1| @ x_s (each node gathers its incident edges)."""
    if isinstance(level, ComplexLevel):
        return B.boundary_abs_s2t(
            x_s, level.src, level.dst, level.num_nodes, edge_mask=level.edge_mask)
    return _bmm(level.b1.abs(), x_s)


def _t2s_mm(b1: torch.Tensor, x_t: torch.Tensor) -> torch.Tensor:
    # einsum('gse,gsf->gef'): B1ᵀ-style contraction over the node axis
    return _bmm(b1.transpose(1, 2), x_t)


def abs_b1_t2s(level, x_t: torch.Tensor) -> torch.Tensor:
    """|B1|ᵀ @ x_t (each edge sums its endpoints)."""
    if isinstance(level, ComplexLevel):
        return B.boundary_abs_t2s(x_t, level.src, level.dst, edge_mask=level.edge_mask)
    return _t2s_mm(level.b1.abs(), x_t)


def b1_t2s(level, x_t: torch.Tensor) -> torch.Tensor:
    """B1ᵀ @ x_t (signed endpoint difference)."""
    if isinstance(level, ComplexLevel):
        return B.boundary_t2s(x_t, level.src, level.dst, edge_mask=level.edge_mask)
    return _t2s_mm(level.b1, x_t)


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


def masked_mean_nodes(level, x: torch.Tensor, num_graphs: int):
    """Per-graph mean over valid nodes → [num_graphs, F]."""
    if isinstance(level, ComplexLevel):
        return segment_mean(x, level.n_id, num_graphs, weights=level.node_mask)
    return _packed_mean(x, level.n_gid, level.node_mask, num_graphs)


def masked_mean_edges(level, x: torch.Tensor, num_graphs: int):
    """Per-graph mean over valid edges → [num_graphs, F]."""
    if isinstance(level, ComplexLevel):
        return segment_mean(x, level.s_id, num_graphs, weights=level.edge_mask)
    return _packed_mean(x, level.s_gid, level.edge_mask, num_graphs)


def _cast_coo(m: CooMatrix, dtype: torch.dtype) -> CooMatrix:
    return dataclasses.replace(
        m, vals=m.vals.to(dtype),
        ell_vals=None if m.ell_vals is None else m.ell_vals.to(dtype))


def cast_operators(batch, dtype: torch.dtype):
    """Cast the operators (dense L0, L1, B1; COO and ELL values) to the
    compute dtype, so bf16 activations meet bf16 operators in every
    product.  Masks, degrees and segment ids keep their dtypes (they feed
    divisions and segment ops)."""
    if dtype == torch.float32:
        return batch

    def cast_level(lvl):
        if isinstance(lvl, ComplexLevel):
            return dataclasses.replace(
                lvl, l0=_cast_coo(lvl.l0, dtype), l1=_cast_coo(lvl.l1, dtype))
        return dataclasses.replace(
            lvl, l0=lvl.l0.to(dtype), l1=lvl.l1.to(dtype), b1=lvl.b1.to(dtype))

    return batch.replace(levels=tuple(cast_level(lvl) for lvl in batch.levels))


def apply_node_mask(level, x: torch.Tensor) -> torch.Tensor:
    return x * level.node_mask[..., None].to(x.dtype)


def apply_edge_mask(level, x: torch.Tensor) -> torch.Tensor:
    return x * level.edge_mask[..., None].to(x.dtype)
