"""``nn.Linear`` with the JAX ``TorchLinear``'s dtype handling.

Init is torch's own default for ``nn.Linear`` — weight and bias
~ U(±1/√fan_in) — drawn from an explicit generator when one is given.
Forward: W cast to x's dtype, f32 accumulation, result rounded to x's
dtype, then the bias added in that dtype (``hl_hgat_tpu/nn/linear.py``).
"""

from __future__ import annotations

import math

import torch
from torch import nn


class TorchLinear(nn.Linear):
    def __init__(
        self, in_features: int, out_features: int, *,
        generator: torch.Generator | None = None,
    ):
        super().__init__(in_features, out_features)
        bound = 1.0 / math.sqrt(in_features) if in_features > 0 else 0.0
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.weight.t().to(x.dtype))
        return y + self.bias.to(y.dtype)
