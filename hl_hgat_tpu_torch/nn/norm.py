"""Padding-aware BatchNorm (``hl_hgat_tpu/nn/norm.py``).

Training statistics come from valid rows only (the mask), the normalized
output is re-masked so padding stays zero, and the running statistics
follow torch's defaults: eps 1e-5, momentum 0.1, unbiased running
variance.  The apply is folded: y = x·a + b with a = γ/√(var+ε),
b = β − μ·a, computed in float32 and rounded to x's dtype.
"""

from __future__ import annotations

import torch
from torch import nn


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
        reduce_axes = tuple(range(x.ndim - 1))
        xf = x.float()
        if m is None:
            n_valid = torch.tensor(float(xf[..., 0].numel()), device=x.device)
            total = xf.sum(reduce_axes)
            total_sq = (xf * xf).sum(reduce_axes)
        else:
            per_row = xf[..., 0].numel() / max(m.numel(), 1)
            n_valid = torch.clamp(m.sum() * per_row, min=1.0)
            total = (xf * m).sum(reduce_axes)
            total_sq = (xf * xf * m).sum(reduce_axes)
        mean = total / n_valid
        var = torch.clamp(total_sq / n_valid - mean * mean, min=0.0)
        with torch.no_grad():
            unbiased = var * n_valid / torch.clamp(n_valid - 1.0, min=1.0)
            self.running_mean.mul_(1 - MOMENTUM).add_(MOMENTUM * mean)
            self.running_var.mul_(1 - MOMENTUM).add_(MOMENTUM * unbiased)
        return mean, var
