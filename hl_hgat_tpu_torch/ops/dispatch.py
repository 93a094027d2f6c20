"""Dense-block graph primitives (dense branches of
``hl_hgat_tpu/ops/dispatch.py``).

Every op is a batched matmul on [G, S, *] tiles; outside the Laguerre
kernels these are plain GEMMs, left to ``torch.matmul`` as the JAX package
left them to XLA.  A matmul accumulates in float32 and rounds its result to
the activation dtype.
"""

from __future__ import annotations

import dataclasses

import torch

from hl_hgat_tpu_torch.complex.dense import DenseBatch, DenseLevel
from hl_hgat_tpu_torch.ops.segment import segment_mean, segment_mean_onehot


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[g] @ b[g] in b's dtype (float32 accumulation inside the GEMM)."""
    return torch.matmul(a.to(b.dtype), b)


def lap_matvec(lap: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """L @ x for dense blocks: lap [G, S, S], x [G, S, C]."""
    return _bmm(lap, x)


def abs_b1_s2t(level: DenseLevel, x_s: torch.Tensor) -> torch.Tensor:
    """|B1| @ x_s (each node gathers its incident edges)."""
    return _bmm(level.b1.abs(), x_s)


def _t2s_mm(b1: torch.Tensor, x_t: torch.Tensor) -> torch.Tensor:
    # einsum('gse,gsf->gef'): B1ᵀ-style contraction over the node axis
    return _bmm(b1.transpose(1, 2), x_t)


def abs_b1_t2s(level: DenseLevel, x_t: torch.Tensor) -> torch.Tensor:
    """|B1|ᵀ @ x_t (each edge sums its endpoints)."""
    return _t2s_mm(level.b1.abs(), x_t)


def b1_t2s(level: DenseLevel, x_t: torch.Tensor) -> torch.Tensor:
    """B1ᵀ @ x_t (signed endpoint difference)."""
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


def masked_mean_nodes(level: DenseLevel, x: torch.Tensor, num_graphs: int):
    """Per-graph mean over valid nodes → [num_graphs, F]."""
    return _packed_mean(x, level.n_gid, level.node_mask, num_graphs)


def masked_mean_edges(level: DenseLevel, x: torch.Tensor, num_graphs: int):
    """Per-graph mean over valid edges → [num_graphs, F]."""
    return _packed_mean(x, level.s_gid, level.edge_mask, num_graphs)


def cast_operators(batch: DenseBatch, dtype: torch.dtype) -> DenseBatch:
    """Cast the operators (L0, L1, B1) to the compute dtype, so bf16
    activations meet bf16 operators in every matmul.  Masks, degrees and
    segment ids keep their dtypes (they feed divisions and segment ops)."""
    if dtype == torch.float32:
        return batch
    levels = tuple(
        dataclasses.replace(
            lvl, l0=lvl.l0.to(dtype), l1=lvl.l1.to(dtype), b1=lvl.b1.to(dtype)
        )
        for lvl in batch.levels
    )
    return batch.replace(levels=levels)


def apply_node_mask(level: DenseLevel, x: torch.Tensor) -> torch.Tensor:
    return x * level.node_mask[..., None].to(x.dtype)


def apply_edge_mask(level: DenseLevel, x: torch.Tensor) -> torch.Tensor:
    return x * level.edge_mask[..., None].to(x.dtype)
