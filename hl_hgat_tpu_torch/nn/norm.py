"""Padding-aware BatchNorm (``hl_hgat_tpu/nn/norm.py``).

Training statistics come from valid rows only (the mask), the variance
as the mean squared deviation from the mean (two passes, as torch's
BatchNorm; the JAX module takes E[x²] − E[x]² in one), the normalized
output is re-masked so padding stays zero, and the running statistics
follow torch's defaults: eps 1e-5, momentum 0.1, unbiased running
variance.  The apply is folded, as torch's: y = x·a + b with
a = γ/√(var+ε), b = β − μ·a, computed in float32 and rounded to x's dtype.

Inside ``parallel.graph_parallel.graph_axis(group)`` the rows of a masked
input are one rank's part of a graph-sharded complex: the count and sum,
then the sum of squared deviations, are summed over the group before each
division, so every rank normalizes with the whole complex's statistics
(an unmasked input, such as the head's replicated readout, is not
reduced).
"""

from __future__ import annotations

import torch
from torch import nn

from hl_hgat_tpu_torch.parallel import graph_parallel as gp


EPS = 1e-5
MOMENTUM = 0.1


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """x: [N, C], [N, T, C] or [G, S, C]; mask: x's leading dims
        ([N] or [G, S]; 1 = valid row)."""
        m = None
        if mask is not None:
            m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim)).float()
        if self.training:
            mean, var = self._batch_stats(x, m)
        else:
            mean, var = self.running_mean, self.running_var
        a = self.weight * (1.0 / torch.sqrt(var + EPS))
        b = self.bias - mean * a
        y = x.float() * a + b
        if m is not None:
            y = y * m
        return y.to(x.dtype)

    def _batch_stats(self, x, m):
        """The valid rows' mean, then their mean squared deviation from it,
        in float32.  A variance taken in one pass, E[x²] − E[x]², keeps
        only the digits of the spread that the mean's square leaves: over
        the brain model's hundreds of thousands of edge rows that moved its
        first gradient by up to 1e-3 against float64."""
        reduce_axes = tuple(range(x.ndim - 1))
        xf = x.float()
        if m is None:
            var, mean = torch.var_mean(xf, dim=reduce_axes, correction=0)
            n_valid = torch.tensor(float(xf[..., 0].numel()), device=x.device)
        else:
            per_row = xf[..., 0].numel() / max(m.numel(), 1)
            n_valid = m.sum() * per_row
            xm = xf * m
            total = xm.sum(reduce_axes)
            sharded = gp.graph_axis_active()
            if sharded:
                c = total.shape[0]
                both = gp.all_reduce_sum(torch.cat([total, n_valid[None]]),
                                         gp.active_graph_group())
                total, n_valid = both[:c], both[c]
            n_valid = torch.clamp(n_valid, min=1.0)
            mean = total / n_valid
            dev = torch.addcmul(xm, m, mean, value=-1.0)  # (x − mean) on valid rows, else 0
            sq = (dev * dev).sum(reduce_axes)
            if sharded:
                sq = gp.all_reduce_sum(sq, gp.active_graph_group())
            var = sq / n_valid
        with torch.no_grad():
            unbiased = var * n_valid / torch.clamp(n_valid - 1.0, min=1.0)
            self.running_mean.mul_(1 - MOMENTUM).add_(MOMENTUM * mean)
            self.running_var.mul_(1 - MOMENTUM).add_(MOMENTUM * unbiased)
        return mean, var
