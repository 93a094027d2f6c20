"""The dense-int3 backbone and the graph-, node- and link-level models
(``hl_hgat_tpu/models/backbone.py``, without pooling, gates or remat).

Template: init conv pair → per block i of width ``filters[i]``:
``channels[i]`` × (MSI → node/edge Laguerre pair with BN/act/dropout →
dense concat onto the running stacks) → readout → head.  The stacks are
carried as tuples of column pieces and concatenated once per block (the JAX
``stack_concat='block'``).  Every model takes either batch layout the
package has — a packed `DenseBatch` ([G, S, C] features) or a flat
`ComplexBatch` ([N, C] features) — except the node and link heads, which
the JAX package runs on the flat layout only.  Module names follow the JAX
parameter paths, so ``weights.from_flax_variables`` maps one tree onto the
other.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from hl_hgat_tpu_torch.complex.batch import ComplexBatch
from hl_hgat_tpu_torch.complex.dense import Batch
from hl_hgat_tpu_torch.nn.blocks import ConvBNAct, NEConvPair, activation
from hl_hgat_tpu_torch.nn.conv import LaguerreConv
from hl_hgat_tpu_torch.nn.interaction import NodeEdgeInt
from hl_hgat_tpu_torch.nn.linear import TorchLinear
from hl_hgat_tpu_torch.nn.norm import MaskedBatchNorm
from hl_hgat_tpu_torch.ops.dispatch import (
    abs_b1_s2t,
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
    act: str = "relu"  # 'relu' | 'leaky_relu'
    leaky_slope: float = 0.1
    dropout: float = 0.0  # after every conv block's activation, train mode only
    # degree epsilon of the MSI division: 1e-6 in the reference models
    # except the zinc pyr loops, which add none (lib/Hodge_ST_Model.py:624)
    deg_eps: float = 1e-6
    # activation dtype; parameters stay float32 and matmuls accumulate f32
    compute_dtype: str = "float32"
    # dtype of the readout and head; None follows compute_dtype.  "float32"
    # on a bf16 trunk casts the final features up before the readout.
    head_dtype: str | None = None

    def conv_kw(self) -> dict:
        return dict(act=self.act, leaky_slope=self.leaky_slope, dropout=self.dropout)


class DenseInt3Backbone(nn.Module):
    """Shared trunk; returns the last layer's (x_t, x_s)."""

    def __init__(self, cfg: BackboneConfig, c_t: int, c_s: int, generator=None):
        super().__init__()
        self.cfg = cfg
        f0 = cfg.filters[0]
        kw = cfg.conv_kw()
        self.init_node = ConvBNAct(c_t, f0, cfg.init_k, generator, **kw)
        self.init_edge = ConvBNAct(c_s, f0, cfg.init_k, generator, **kw)
        # node and edge stacks grow alike: both start at f0, gain `width`
        # per layer
        stack = f0
        self.layer_names: list[tuple[str, str]] = []
        for i, width in enumerate(cfg.filters):
            for j in range(cfg.channels[i]):
                nei, conv = f"NEInt{i}{j}", f"NEConv{i}{j}"
                self.add_module(nei, NodeEdgeInt(stack, stack, width, generator))
                self.add_module(conv, NEConvPair(width, width, cfg.k, generator, **kw))
                self.layer_names.append((nei, conv))
                stack += width
        self.out_features = cfg.filters[-1]

    def forward(self, x_t, x_s, batch: Batch):
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


def head_cast(cfg: BackboneConfig, *tensors: torch.Tensor):
    """Cast final backbone features to ``cfg.head_dtype`` (no-op when
    None); every head routes its readout inputs through this."""
    if cfg.head_dtype is not None:
        hd = getattr(torch, cfg.head_dtype)
        tensors = tuple(t.to(hd) for t in tensors)
    return tensors if len(tensors) > 1 else tensors[0]


class MLPHead(nn.Module):
    """Linear→BN→act→dropout stack + output Linear (reference
    lib/Hodge_ST_Model.py:595-605); float32 output."""

    def __init__(
        self, in_features: int, mlp_channels: tuple[int, ...], num_classes: int,
        generator=None, *, act: str = "relu", leaky_slope: float = 0.1,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.depth = len(mlp_channels)
        self.act = activation(act, leaky_slope)
        self.dropout = dropout
        width = in_features
        for i, out in enumerate(mlp_channels):
            self.add_module(f"mlp{i}_lin", TorchLinear(width, out, generator=generator))
            self.add_module(f"mlp{i}_bn", MaskedBatchNorm(out))
            width = out
        self.out = TorchLinear(width, num_classes, generator=generator)

    def forward(self, x):
        for i in range(self.depth):
            x = self.get_submodule(f"mlp{i}_lin")(x)
            x = self.act(self.get_submodule(f"mlp{i}_bn")(x))
            if self.dropout > 0.0:
                x = nn.functional.dropout(x, self.dropout, self.training)
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
        embed_num: int = 0, embed_dim: int = 0, dropout_mlp: float = 0.0,
        generator=None,
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
            generator, act=cfg.act, leaky_slope=cfg.leaky_slope, dropout=dropout_mlp,
        )

    def forward(self, batch: Batch) -> torch.Tensor:
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
        f_t, f_s = head_cast(self.cfg, *self.backbone(x_t, x_s, batch))
        pooled = torch.cat(
            [
                masked_mean_edges(level, f_s, batch.num_graphs),
                masked_mean_nodes(level, f_t, batch.num_graphs),
            ],
            dim=-1,
        )
        return self.head(pooled)


class HLHGCNNNode(nn.Module):
    """Node-level model (PascalVOC-SP / COCO-SP node classification): the
    readout concatenates the final node features with the boundary coupling
    D⁻¹·|B1|·x_s, then applies node-wise K=1 Laguerre-conv layers; per-node
    float32 logits, exactly 0 on padded nodes.  ``in_t``/``in_s`` are the
    input feature widths."""

    def __init__(
        self, cfg: BackboneConfig, in_t: int, in_s: int, *,
        mlp_channels: tuple[int, ...] = (), num_classes: int = 21, generator=None,
    ):
        super().__init__()
        self.cfg = cfg
        self.backbone = DenseInt3Backbone(cfg, in_t, in_s, generator)
        self.depth = len(mlp_channels)
        width = 2 * self.backbone.out_features
        for i, out in enumerate(mlp_channels):
            self.add_module(f"mlp{i}", ConvBNAct(width, out, 1, generator, **cfg.conv_kw()))
            width = out
        self.out = LaguerreConv(width, num_classes, 1, generator=generator)

    def forward(self, batch: Batch) -> torch.Tensor:
        level = batch.level0
        x_t, x_s = head_cast(self.cfg, *self.backbone(batch.x_t, batch.x_s, batch))
        deg = level.deg + self.cfg.deg_eps
        s2t = abs_b1_s2t(level, x_s)
        s2t = s2t / torch.where(deg > 0, deg, torch.ones_like(deg))[..., None].to(s2t.dtype)
        x_t = torch.cat([x_t, s2t], dim=-1)
        for i in range(self.depth):
            x_t = self.get_submodule(f"mlp{i}")(x_t, level.l0, level.node_mask)
        return apply_node_mask(level, self.out(x_t, level.l0).float())


class HLHGCNNLinkPred(nn.Module):
    """Link-prediction model (PCQM-Contact): scores candidate node pairs
    from the backbone's final node features with an MLP on
    [h_u ‖ h_v ‖ h_u⊙h_v].  ``pairs`` [P, 2] holds flat node-row ids, given
    or carried by the batch (``complex.build.attach_link_pairs``); padded
    rows are killed by ``pair_mask``.  Returns [P] float32 logits."""

    def __init__(
        self, cfg: BackboneConfig, in_t: int, in_s: int, *,
        mlp_channels: tuple[int, ...] = (128,), generator=None,
    ):
        super().__init__()
        self.cfg = cfg
        self.backbone = DenseInt3Backbone(cfg, in_t, in_s, generator)
        self.depth = len(mlp_channels)
        self.act = activation(cfg.act, cfg.leaky_slope)
        width = 3 * self.backbone.out_features
        for i, out in enumerate(mlp_channels):
            self.add_module(f"mlp{i}_lin", TorchLinear(width, out, generator=generator))
            self.add_module(f"mlp{i}_bn", MaskedBatchNorm(out))
            width = out
        self.out = TorchLinear(width, 1, generator=generator)

    def forward(self, batch: ComplexBatch, pairs=None, pair_mask=None) -> torch.Tensor:
        if pairs is None:
            pairs, pair_mask = batch.pairs, batch.pair_mask
        if pairs is None:
            raise ValueError(
                "HLHGCNNLinkPred needs pairs: pass them or attach them to the "
                "batch (attach_link_pairs)")
        h = head_cast(self.cfg, self.backbone(batch.x_t, batch.x_s, batch)[0])
        if h.dim() != 2:
            raise ValueError("pairs index flat node rows: the link head takes a ComplexBatch")
        hu, hv = h[pairs[:, 0].long()], h[pairs[:, 1].long()]
        z = torch.cat([hu, hv, hu * hv], dim=-1)
        for i in range(self.depth):
            z = self.get_submodule(f"mlp{i}_lin")(z)
            z = self.act(self.get_submodule(f"mlp{i}_bn")(z, pair_mask))
        return self.out(z).float()[:, 0] * pair_mask.float()
