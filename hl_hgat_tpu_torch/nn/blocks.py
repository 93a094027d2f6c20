"""Conv blocks shared by the model families (``hl_hgat_tpu/nn/blocks.py``):
LaguerreConv → masked BN → activation → dropout, singly and as the
node/edge pair of every reference block (reference
lib/Hodge_ST_Model.py:578-589), and ``HLFilter``, a stack of MSI → pair
layers (reference HL_filter, lib/Hodge_Cheb_Conv.py:117-188).
``demo_compat`` gives a block's convs the DEMO recurrence (``nn/conv.py``).
The JAX package's merged node/edge pair, which skips compat convs, has no
counterpart here: the pair runs its two convs apart.  Either layout: dense
[G, S, C] features with [G, S, S] operators, or flat [N, C] features with
`CooMatrix` operators.  Dropout is torch's own (active in train mode only); its random
stream is not the JAX package's."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from hl_hgat_tpu_torch.nn.conv import LaguerreConv
from hl_hgat_tpu_torch.nn.interaction import NodeEdgeInt
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
        demo_compat: bool = False,
    ):
        super().__init__()
        self.conv = LaguerreConv(in_features, features, k, generator=generator,
                                 demo_compat=demo_compat)
        self.bn = MaskedBatchNorm(features)
        self.act = activation(act, leaky_slope)
        self.dropout = dropout

    def forward(self, x, lap, mask):
        x = self.act(self.bn(self.conv(x, lap), mask))
        if self.dropout > 0.0:
            x = nn.functional.dropout(x, self.dropout, self.training)
        return x


class NEConvPair(nn.Module):
    """The node conv block on L0 and the edge conv block on L1;
    ``in_edge`` is the edge input width where it differs from the node's."""

    def __init__(
        self, in_features: int, features: int, k: int,
        generator: torch.Generator | None = None, *, in_edge: int | None = None, **kw,
    ):
        super().__init__()
        self.node = ConvBNAct(in_features, features, k, generator, **kw)
        self.edge = ConvBNAct(in_features if in_edge is None else in_edge, features, k,
                              generator, **kw)

    def forward(self, x_t, x_s, level):
        return (
            self.node(x_t, level.l0, level.node_mask),
            self.edge(x_s, level.l1, level.edge_mask),
        )


class HLFilter(nn.Module):
    """``channels`` stacked layers on one level (reference HL_filter,
    lib/Hodge_Cheb_Conv.py:117-188).  ``if_dense``: each layer is MSI
    ``MSI{j}`` (width ``filters``) → node/edge pair ``NEConv{j}``, its
    outputs concatenated onto the running stacks, which are returned;
    otherwise the pairs run in sequence and the last outputs are returned.
    ``c_t``/``c_s`` are the input widths."""

    def __init__(
        self, c_t: int, c_s: int, channels: int = 2, filters: int = 32, k: int = 4, *,
        act: str = "leaky_relu", leaky_slope: float = 0.1, dropout: float = 0.0,
        if_dense: bool = True, generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.channels, self.if_dense = channels, if_dense
        kw = dict(act=act, leaky_slope=leaky_slope, dropout=dropout)
        for j in range(channels):
            if if_dense:
                self.add_module(f"MSI{j}", NodeEdgeInt(c_t, c_s, filters, generator))
                self.add_module(f"NEConv{j}", NEConvPair(filters, filters, k, generator, **kw))
                c_t, c_s = c_t + filters, c_s + filters
            else:
                self.add_module(f"NEConv{j}",
                                NEConvPair(c_t, filters, k, generator, in_edge=c_s, **kw))
                c_t = c_s = filters

    def forward(self, x_t0, x_s0, level, deg):
        for j in range(self.channels):
            pair = self.get_submodule(f"NEConv{j}")
            if self.if_dense:
                x_t, x_s = pair(*self.get_submodule(f"MSI{j}")(x_t0, x_s0, level, deg), level)
                x_t0 = torch.cat([x_t0, x_t], dim=-1)
                x_s0 = torch.cat([x_s0, x_s], dim=-1)
            else:
                x_t0, x_s0 = pair(x_t0, x_s0, level)
        return x_t0, x_s0
