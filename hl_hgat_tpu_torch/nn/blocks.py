"""Conv blocks shared by the model families (``hl_hgat_tpu/nn/blocks.py``):
LaguerreConv → masked BN → activation → dropout, singly and as the
node/edge pair of every reference block (reference
lib/Hodge_ST_Model.py:578-589).  Either layout: dense [G, S, C] features
with [G, S, S] operators, or flat [N, C] features with `CooMatrix`
operators.  Dropout is torch's own (active in train mode only); its random
stream is not the JAX package's."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from hl_hgat_tpu_torch.nn.conv import LaguerreConv
from hl_hgat_tpu_torch.nn.norm import MaskedBatchNorm


def activation(name: str, leaky_slope: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "relu":
        return torch.relu
    if name == "leaky_relu":
        return lambda x: nn.functional.leaky_relu(x, leaky_slope)
    raise ValueError(f"unknown activation {name!r}")


class ConvBNAct(nn.Module):
    def __init__(
        self, in_features: int, features: int, k: int,
        generator: torch.Generator | None = None, *,
        act: str = "relu", leaky_slope: float = 0.1, dropout: float = 0.0,
    ):
        super().__init__()
        self.conv = LaguerreConv(in_features, features, k, generator=generator)
        self.bn = MaskedBatchNorm(features)
        self.act = activation(act, leaky_slope)
        self.dropout = dropout

    def forward(self, x, lap, mask):
        x = self.act(self.bn(self.conv(x, lap), mask))
        if self.dropout > 0.0:
            x = nn.functional.dropout(x, self.dropout, self.training)
        return x


class NEConvPair(nn.Module):
    def __init__(
        self, in_features: int, features: int, k: int,
        generator: torch.Generator | None = None, **kw,
    ):
        super().__init__()
        self.node = ConvBNAct(in_features, features, k, generator, **kw)
        self.edge = ConvBNAct(in_features, features, k, generator, **kw)

    def forward(self, x_t, x_s, level):
        return (
            self.node(x_t, level.l0, level.node_mask),
            self.edge(x_s, level.l1, level.edge_mask),
        )
