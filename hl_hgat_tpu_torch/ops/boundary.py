"""Boundary-operator products as gathers + segment sums
(``hl_hgat_tpu/ops/boundary.py``).

B1 has exactly two entries per column (−1 at the edge's source row, +1 at
its target row), so no sparse matrix is needed:

  (B1 x_s)[n]      = Σ_{e: dst e = n} x_s[e] − Σ_{e: src e = n} x_s[e]
  (|B1| x_s)[n]    = Σ_{e incident n} x_s[e]
  (B1ᵀ x_t)[e]     = x_t[dst e] − x_t[src e]          (pure gather)
  (|B1|ᵀ x_t)[e]   = x_t[dst e] + x_t[src e]          (pure gather)

Padded edges are removed by multiplying with ``edge_mask``.  The two
forward products sum in float32 and round once.
"""

from __future__ import annotations

import torch

from hl_hgat_tpu_torch.ops.segment import segment_sum


def _masked(x_s: torch.Tensor, edge_mask: torch.Tensor | None) -> torch.Tensor:
    if edge_mask is None:
        return x_s
    return x_s * edge_mask.reshape((-1,) + (1,) * (x_s.ndim - 1)).to(x_s.dtype)


def boundary_abs_s2t(x_s, src, dst, num_nodes: int, *, edge_mask=None) -> torch.Tensor:
    """``|B1| @ x_s``: each node sums its incident-edge features."""
    xm = _masked(x_s, edge_mask).float()
    out = segment_sum(xm, src, num_nodes) + segment_sum(xm, dst, num_nodes)
    return out.to(x_s.dtype)


def boundary_s2t(x_s, src, dst, num_nodes: int, *, edge_mask=None) -> torch.Tensor:
    """``B1 @ x_s``: signed incidence sum (−1 at src, +1 at dst)."""
    xm = _masked(x_s, edge_mask).float()
    out = segment_sum(xm, dst, num_nodes) - segment_sum(xm, src, num_nodes)
    return out.to(x_s.dtype)


def boundary_abs_t2s(x_t, src, dst, *, edge_mask=None) -> torch.Tensor:
    """``|B1|ᵀ @ x_t``: each edge sums its two endpoint features."""
    return _masked(x_t[src.long()] + x_t[dst.long()], edge_mask)


def boundary_t2s(x_t, src, dst, *, edge_mask=None) -> torch.Tensor:
    """``B1ᵀ @ x_t``: signed endpoint difference (dst − src)."""
    return _masked(x_t[dst.long()] - x_t[src.long()], edge_mask)


def node_degree(src, dst, num_nodes: int, *, edge_mask=None, eps: float = 0.0) -> torch.Tensor:
    """Degree of each node in the (undirected, deduped) edge list, plus
    ``eps`` (the reference adds 1e-6 at some call sites and none at
    others; callers pass it)."""
    ones = (
        torch.ones(src.shape, dtype=torch.float32, device=src.device)
        if edge_mask is None else edge_mask.float()
    )
    return segment_sum(ones, src, num_nodes) + segment_sum(ones, dst, num_nodes) + eps
