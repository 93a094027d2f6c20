"""Conv blocks shared by the model families (``hl_hgat_tpu/nn/blocks.py``):
LaguerreConv → masked BN → activation, singly and as the node/edge pair of
every reference block (reference lib/Hodge_ST_Model.py:578-589).  The
activation is ReLU, the only one the ported presets use."""

from __future__ import annotations

import torch
from torch import nn

from hl_hgat_tpu_torch.nn.conv import LaguerreConv
from hl_hgat_tpu_torch.nn.norm import MaskedBatchNorm


class ConvBNAct(nn.Module):
    def __init__(
        self, in_features: int, features: int, k: int,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.conv = LaguerreConv(in_features, features, k, generator=generator)
        self.bn = MaskedBatchNorm(features)

    def forward(self, x, lap, mask):
        return torch.relu(self.bn(self.conv(x, lap), mask))


class NEConvPair(nn.Module):
    def __init__(
        self, in_features: int, features: int, k: int,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.node = ConvBNAct(in_features, features, k, generator)
        self.edge = ConvBNAct(in_features, features, k, generator)

    def forward(self, x_t, x_s, level):
        return (
            self.node(x_t, level.l0, level.node_mask),
            self.edge(x_s, level.l1, level.edge_mask),
        )
