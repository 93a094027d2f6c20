"""Pooling: global masked readouts and simplicial attention pooling (SAPool)
(``hl_hgat_tpu/nn/pool.py``).

SAPool (reference lib/Hodge_Cheb_Conv.py:36-59): gate node and edge
features with the MSI attention head, mean the gated nodes into their MLGC
clusters and the surviving edges into their coarse edges (intra-cluster
edges and padding go to the dump slot), then continue on the coarse level's
operators.  Fine and coarse levels both live at fixed padded sizes inside
one batch.
"""

from __future__ import annotations

import torch
from torch import nn

from hl_hgat_tpu_torch.nn.interaction import NodeEdgeInt
from hl_hgat_tpu_torch.ops.dispatch import pool_to_coarse
from hl_hgat_tpu_torch.ops.segment import segment_mean
from hl_hgat_tpu_torch.parallel import graph_parallel as gp


def global_mean_pool(x: torch.Tensor, seg_id: torch.Tensor, num_graphs: int,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-graph mean over valid simplices (PyG ``global_mean_pool``):
    padding rows carry ``seg_id == num_graphs`` and drop out; ``mask`` also
    removes them from the denominator."""
    return segment_mean(x, seg_id, num_graphs, weights=mask)


def sapool_scatter(x_t, x_s, pool, fine, coarse):
    """Mean of the (gated) fine features into the coarse complex, either
    layout: deleted fine edges and padding vanish, denominators count valid
    members only (reference lib/Hodge_ST_Model.py:282-285)."""
    return pool_to_coarse(pool, fine, coarse, x_t, x_s)


class SAPool(nn.Module):
    """Gate-then-pool (reference SAPool, lib/Hodge_Cheb_Conv.py:36-59);
    ``max_normalize`` divides the gates by their max first (the CIFAR10
    variant, reference lib/Hodge_ST_Model.py:1061-1062).  Returns the
    coarse (x_t, x_s) and the float32 gates."""

    def __init__(self, c_t: int, c_s: int, *, dk: int = 32, sigma: str = "sigmoid",
                 lam: float = 0.9, max_normalize: bool = False, generator=None):
        super().__init__()
        self.max_normalize = max_normalize
        self.NEAtt = NodeEdgeInt(c_t, c_s, generator=generator, only_att=True, dk=dk,
                                 sigma=sigma, lam=lam)

    def forward(self, x_t, x_s, pool, fine, coarse, deg):
        a_t, a_s = self.NEAtt(x_t, x_s, fine, deg)
        if self.max_normalize:
            a_t, a_s = max_normalize(a_t), max_normalize(a_s)
        # the gated multiply runs in the activation dtype; the gates stay f32
        x_t_c, x_s_c = sapool_scatter(x_t * a_t.to(x_t.dtype), x_s * a_s.to(x_s.dtype),
                                      pool, fine, coarse)
        return x_t_c, x_s_c, a_t, a_s


def max_normalize(a: torch.Tensor) -> torch.Tensor:
    """Gates over their largest value (at least 1e-12); inside
    ``graph_parallel.graph_axis`` the largest over every rank's rows."""
    top = a.max()
    if gp.graph_axis_active():
        top = gp.all_reduce_max(top, gp.active_graph_group())
    return a / torch.clamp(top, min=1e-12)
