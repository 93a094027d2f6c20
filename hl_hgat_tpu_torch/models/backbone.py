"""The dense-int3 backbone and the graph-level model
(``hl_hgat_tpu/models/backbone.py``, without pooling, gates or remat).

Template: init conv pair → per block i of width ``filters[i]``:
``channels[i]`` × (MSI → node/edge Laguerre pair with BN/act → dense concat
onto the running stacks) → mean-pool readout [edges ‖ nodes] → MLP head.
The stacks are carried as tuples of column pieces and concatenated once per
block (the JAX ``stack_concat='block'``).  Module names follow the JAX
parameter paths, so ``weights.from_flax_variables`` maps one tree onto the
other.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from hl_hgat_tpu_torch.complex.dense import DenseBatch
from hl_hgat_tpu_torch.nn.blocks import ConvBNAct, NEConvPair
from hl_hgat_tpu_torch.nn.interaction import NodeEdgeInt
from hl_hgat_tpu_torch.nn.linear import TorchLinear
from hl_hgat_tpu_torch.nn.norm import MaskedBatchNorm
from hl_hgat_tpu_torch.ops.dispatch import (
    apply_edge_mask,
    apply_node_mask,
    cast_operators,
    masked_mean_edges,
    masked_mean_nodes,
)
from hl_hgat_tpu_torch.ops.segment import embed_lookup


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    channels: tuple[int, ...] = (2, 2, 2, 2)
    filters: tuple[int, ...] = (64, 128, 256, 512)
    k: int = 2
    init_k: int = 2  # K of the init conv (1 for the zinc script variant)
    # degree epsilon of the MSI division: 1e-6 in the reference models
    # except the zinc pyr loops, which add none (lib/Hodge_ST_Model.py:624)
    deg_eps: float = 1e-6
    # activation dtype; parameters stay float32 and matmuls accumulate f32
    compute_dtype: str = "float32"


class DenseInt3Backbone(nn.Module):
    """Shared trunk; returns the last layer's (x_t, x_s)."""

    def __init__(self, cfg: BackboneConfig, c_t: int, c_s: int, generator=None):
        super().__init__()
        self.cfg = cfg
        f0 = cfg.filters[0]
        self.init_node = ConvBNAct(c_t, f0, cfg.init_k, generator)
        self.init_edge = ConvBNAct(c_s, f0, cfg.init_k, generator)
        # node and edge stacks grow alike: both start at f0, gain `width`
        # per layer
        stack = f0
        self.layer_names: list[tuple[str, str]] = []
        for i, width in enumerate(cfg.filters):
            for j in range(cfg.channels[i]):
                nei, conv = f"NEInt{i}{j}", f"NEConv{i}{j}"
                self.add_module(nei, NodeEdgeInt(stack, stack, width, generator))
                self.add_module(conv, NEConvPair(width, width, cfg.k, generator))
                self.layer_names.append((nei, conv))
                stack += width
        self.out_features = cfg.filters[-1]

    def forward(self, x_t, x_s, batch: DenseBatch):
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        x_t = x_t.to(dtype)
        x_s = x_s.to(dtype)
        # operators follow the compute dtype (ops/dispatch.py cast_operators)
        level = cast_operators(batch, dtype).levels[0]
        deg = level.deg + cfg.deg_eps
        x_t = self.init_node(x_t, level.l0, level.node_mask)
        x_s = self.init_edge(x_s, level.l1, level.edge_mask)
        pieces_t, pieces_s = (x_t,), (x_s,)
        names = iter(self.layer_names)
        for i in range(len(cfg.filters)):
            for _ in range(cfg.channels[i]):
                nei, conv = next(names)
                x_t, x_s = self.get_submodule(nei)(pieces_t, pieces_s, level, deg)
                x_t, x_s = self.get_submodule(conv)(x_t, x_s, level)
                pieces_t += (x_t,)
                pieces_s += (x_s,)
            pieces_t = (torch.cat(pieces_t, dim=-1),)
            pieces_s = (torch.cat(pieces_s, dim=-1),)
        return x_t, x_s


class MLPHead(nn.Module):
    """Linear→BN→ReLU stack + output Linear (reference
    lib/Hodge_ST_Model.py:595-605); float32 output."""

    def __init__(
        self, in_features: int, mlp_channels: tuple[int, ...], num_classes: int,
        generator=None,
    ):
        super().__init__()
        self.depth = len(mlp_channels)
        width = in_features
        for i, out in enumerate(mlp_channels):
            self.add_module(f"mlp{i}_lin", TorchLinear(width, out, generator=generator))
            self.add_module(f"mlp{i}_bn", MaskedBatchNorm(out))
            width = out
        self.out = TorchLinear(width, num_classes, generator=generator)

    def forward(self, x):
        for i in range(self.depth):
            x = self.get_submodule(f"mlp{i}_lin")(x)
            x = torch.relu(self.get_submodule(f"mlp{i}_bn")(x))
        return self.out(x).float()


class HLHGCNNGraph(nn.Module):
    """Graph-level model: backbone → mean-pool [edges ‖ nodes] → MLP.

    ``embed_num > 0`` replaces feature column 0 (integer ids) of nodes AND
    edges with rows of one shared ``nn.Embedding`` table — the reference
    script reuses the node table for edge ids (main_zinc...py:52-53,120-121).
    ``in_t``/``in_s`` are the raw input widths, column 0 included.
    """

    def __init__(
        self, cfg: BackboneConfig, in_t: int, in_s: int, *,
        mlp_channels: tuple[int, ...] = (), num_classes: int = 1,
        embed_num: int = 0, embed_dim: int = 0, generator=None,
    ):
        super().__init__()
        self.cfg = cfg
        self.embed_num = embed_num
        c_t, c_s = in_t, in_s
        if embed_num:
            self.node_embedding = nn.Embedding(embed_num, embed_dim)
            with torch.no_grad():
                # flax nn.Embed's default: N(0, 1/embed_dim)
                self.node_embedding.weight.normal_(
                    0.0, embed_dim ** -0.5, generator=generator)
            c_t, c_s = embed_dim + in_t - 1, embed_dim + in_s - 1
        self.backbone = DenseInt3Backbone(cfg, c_t, c_s, generator)
        self.head = MLPHead(
            2 * self.backbone.out_features, tuple(mlp_channels), num_classes,
            generator,
        )

    def forward(self, batch: DenseBatch) -> torch.Tensor:
        x_t, x_s = batch.x_t, batch.x_s
        level = batch.level0
        if self.embed_num:
            table = self.node_embedding.weight
            x_t = torch.cat(
                [embed_lookup(table, x_t[..., 0].long()), x_t[..., 1:]], dim=-1)
            x_s = torch.cat(
                [embed_lookup(table, x_s[..., 0].long()), x_s[..., 1:]], dim=-1)
            x_t = apply_node_mask(level, x_t)
            x_s = apply_edge_mask(level, x_s)
        f_t, f_s = self.backbone(x_t, x_s, batch)
        pooled = torch.cat(
            [
                masked_mean_edges(level, f_s, batch.num_graphs),
                masked_mean_nodes(level, f_t, batch.num_graphs),
            ],
            dim=-1,
        )
        return self.head(pooled)
