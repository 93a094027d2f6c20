"""The dense-int3 backbone and the graph-, node-, link- and edge-level
models (``hl_hgat_tpu/models/backbone.py``, without remat).

Template: init conv pair → per block i of width ``filters[i]``:
``channels[i]`` × (MSI → node/edge Laguerre pair with BN/act/dropout →
dense concat onto the running stacks) → optional attention gates and
structural pooling onto the next level → readout → head.  Per-model quirks
are config (``BackboneConfig``; the JAX module's header lists them): the
degree epsilon, what the gates read and multiply, which blocks gate and
which pool, the poolint3 variant's one MSI per block after its convs.  The
stacks are carried as tuples of column pieces and concatenated once per
block (``stack_concat='block'``) or after every layer (``'layer'``).
Every model takes either batch layout the package has — a packed
`DenseBatch` ([G, S, C] features) or a flat `ComplexBatch` ([N, C]
features) — except the node and link heads, which the JAX package runs on
the flat layout only.  The edge-level (TSP) model also takes a packed
batch whose graphs span blocks (``complex.dense.BlockDiagMatrix``).  Module names follow the JAX
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
from hl_hgat_tpu_torch.nn.pool import max_normalize, sapool_scatter
from hl_hgat_tpu_torch.ops.dispatch import (
    abs_b1_s2t,
    apply_edge_mask,
    b1_t2s,
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
    init_k: int = 2  # K of the init conv (1 for zinc-script/CIFAR/pepfunc-att)
    act: str = "relu"  # 'relu' | 'leaky_relu'
    leaky_slope: float = 0.1
    dropout: float = 0.0  # after every conv block's activation, train mode only
    # degree epsilon of the MSI division: 1e-6 in the reference models
    # except the zinc pyr/attpool loops, which add none
    # (lib/Hodge_ST_Model.py:504,624)
    deg_eps: float = 1e-6
    # False: the poolint3 variant, convs on the raw stacks and one MSI per
    # block after them (reference lib/Hodge_ST_Model.py:649-749)
    msi_per_layer: bool = True
    # gates and pooling after block i: att_locs gate, pool_locs gate and pool
    pool_locs: tuple[int, ...] = ()
    att_locs: tuple[int, ...] = ()
    att_sigma: str = "sigmoid"
    att_lam: float = 0.9
    att_dk: int = 32
    gate_input: str = "last"  # 'last' (x_t, x_s) | 'stack' (the stacks)
    gate_target: str = "stack"  # 'stack' | 'last'
    max_normalize_gates: bool = False
    # activation dtype; parameters stay float32 and matmuls accumulate f32
    compute_dtype: str = "float32"
    # dtype of the readout and head; None follows compute_dtype.  "float32"
    # on a bf16 trunk casts the final features up before the readout.
    head_dtype: str | None = None
    # when the dense-concat stacks are materialized: 'block' once per block,
    # 'layer' after every layer (the reference's formulation); same values
    stack_concat: str = "block"
    # the DEMO fast-conv recurrence in the trunk's convs (nn/conv.py), needed
    # to run the shipped brain checkpoint; the plain route on any device
    demo_conv_compat: bool = False

    def conv_kw(self) -> dict:
        return dict(act=self.act, leaky_slope=self.leaky_slope, dropout=self.dropout)


class DenseInt3Backbone(nn.Module):
    """Shared trunk: init conv pair, then per block of ``filters[i]``
    channels its layers, the block's gates and its pooling.  Returns the
    last layer's (x_t, x_s) on level ``level_idx`` (the number of pools
    taken); with ``return_atts`` also the float32 gates (a_t, a_s) of each
    gated block, in block order; with ``return_snapshots`` (last) also the
    list of every layer's conv output (x_t, x_s), taken after each
    ``NEConv{i}{j}`` before any gate, on that layer's level (the feature
    trends of ``utils.viz``; reference lib/Visualization.py:35-122)."""

    def __init__(self, cfg: BackboneConfig, c_t: int, c_s: int, generator=None):
        super().__init__()
        if cfg.stack_concat not in ("block", "layer"):
            raise ValueError(f"unknown stack_concat {cfg.stack_concat!r}")
        self.cfg = cfg
        f0 = cfg.filters[0]
        kw = dict(cfg.conv_kw(), demo_compat=cfg.demo_conv_compat)
        self.init_node = ConvBNAct(c_t, f0, cfg.init_k, generator, **kw)
        self.init_edge = ConvBNAct(c_s, f0, cfg.init_k, generator, **kw)
        # node and edge stacks grow alike: both start at f0, gain `width`
        # per layer (and per block MSI in poolint3); pooling keeps the width
        stack = f0
        for i, width in enumerate(cfg.filters):
            for j in range(cfg.channels[i]):
                if cfg.msi_per_layer:
                    self.add_module(f"NEInt{i}{j}", NodeEdgeInt(stack, stack, width, generator))
                conv_in = width if cfg.msi_per_layer else stack
                self.add_module(f"NEConv{i}{j}",
                                NEConvPair(conv_in, width, cfg.k, generator, **kw))
                stack += width
            if not cfg.msi_per_layer:
                self.add_module(f"NEInt{i}", NodeEdgeInt(stack, stack, width, generator))
                stack += width
            if i in cfg.att_locs or i in cfg.pool_locs:
                c_gate = width if cfg.gate_input == "last" else stack
                self.add_module(f"NEAtt{i}", NodeEdgeInt(
                    c_gate, c_gate, generator=generator, only_att=True, dk=cfg.att_dk,
                    sigma=cfg.att_sigma, lam=cfg.att_lam))
        self.out_features = cfg.filters[-1]
        self.level_idx = sum(1 for i in range(len(cfg.filters)) if i in cfg.pool_locs)

    def forward(self, x_t, x_s, batch: Batch, *, return_atts: bool = False,
                return_snapshots: bool = False):
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        x_t = x_t.to(dtype)
        x_s = x_s.to(dtype)
        # operators follow the compute dtype (ops/dispatch.py cast_operators)
        batch = cast_operators(batch, dtype)
        level = batch.levels[0]
        deg = level.deg + cfg.deg_eps
        x_t = self.init_node(x_t, level.l0, level.node_mask)
        x_s = self.init_edge(x_s, level.l1, level.edge_mask)
        pieces_t, pieces_s = (x_t,), (x_s,)
        k = 0  # pooling level index
        atts, snapshots = [], []
        for i in range(len(cfg.filters)):
            for j in range(cfg.channels[i]):
                conv = self.get_submodule(f"NEConv{i}{j}")
                if cfg.msi_per_layer:
                    x_t, x_s = self.get_submodule(f"NEInt{i}{j}")(pieces_t, pieces_s, level, deg)
                    x_t, x_s = conv(x_t, x_s, level)
                else:
                    x_t, x_s = conv(torch.cat(pieces_t, dim=-1), torch.cat(pieces_s, dim=-1),
                                    level)
                pieces_t += (x_t,)
                pieces_s += (x_s,)
                snapshots.append((x_t, x_s))
                if cfg.stack_concat == "layer":
                    pieces_t = (torch.cat(pieces_t, dim=-1),)
                    pieces_s = (torch.cat(pieces_s, dim=-1),)
            if not cfg.msi_per_layer:
                x_t, x_s = self.get_submodule(f"NEInt{i}")(pieces_t, pieces_s, level, deg)
                pieces_t += (x_t,)
                pieces_s += (x_s,)
            pieces_t = (torch.cat(pieces_t, dim=-1),)
            pieces_s = (torch.cat(pieces_s, dim=-1),)

            if i in cfg.att_locs or i in cfg.pool_locs:
                g_t, g_s = (x_t, x_s) if cfg.gate_input == "last" else (pieces_t, pieces_s)
                a_t, a_s = self.get_submodule(f"NEAtt{i}")(g_t, g_s, level, deg)
                if cfg.max_normalize_gates:
                    a_t, a_s = max_normalize(a_t), max_normalize(a_s)
                atts.append((a_t, a_s))
                # the gates stay float32; the wide multiply runs in the
                # activation dtype
                if cfg.gate_target == "stack":
                    pieces_t = tuple(p * a_t.to(p.dtype) for p in pieces_t)
                    pieces_s = tuple(p * a_s.to(p.dtype) for p in pieces_s)
                else:
                    x_t = x_t * a_t.to(x_t.dtype)
                    x_s = x_s * a_s.to(x_s.dtype)

            if i in cfg.pool_locs:
                coarse = batch.levels[k + 1]
                pieces_t, pieces_s = (
                    (p,) for p in sapool_scatter(pieces_t[0], pieces_s[0], batch.pools[k],
                                                 level, coarse))
                k += 1
                level = coarse
                deg = level.deg + cfg.deg_eps
        return ((x_t, x_s) + ((atts,) if return_atts else ())
                + ((snapshots,) if return_snapshots else ()))


def make_backbone(cfg: BackboneConfig, c_t: int, c_s: int, generator=None) -> DenseInt3Backbone:
    """The shared trunk on its own (``hl_hgat_tpu/models/backbone.py::
    make_backbone``) for node and edge inputs of ``c_t`` and ``c_s``
    columns: ``make_backbone(cfg, c_t, c_s)(x_t, x_s, batch,
    return_snapshots=True)``.  Torch needs the input widths that flax
    infers at init."""
    return DenseInt3Backbone(cfg, c_t, c_s, generator)


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

    def forward(self, x, *, return_latent: bool = False):
        """[B, in] → float32 [B, num_classes]; with ``return_latent`` also
        the input of the output layer."""
        for i in range(self.depth):
            x = self.get_submodule(f"mlp{i}_lin")(x)
            x = self.act(self.get_submodule(f"mlp{i}_bn")(x))
            if self.dropout > 0.0:
                x = nn.functional.dropout(x, self.dropout, self.training)
        out = self.out(x).float()
        return (out, x) if return_latent else out


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

    def forward(self, batch: Batch, *, return_atts: bool = False, return_latent: bool = False):
        """[num_graphs, classes]; with ``return_atts`` / ``return_latent``,
        ``(out, extras)`` where ``extras["atts"]`` holds the backbone's
        gates and ``extras["latent"]`` the pooled [edges ‖ nodes] features
        (the JAX module's two flags)."""
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
        f_t, f_s, atts = self.backbone(x_t, x_s, batch, return_atts=True)
        f_t, f_s = head_cast(self.cfg, f_t, f_s)
        final = batch.levels[self.backbone.level_idx]
        pooled = torch.cat(
            [
                masked_mean_edges(final, f_s, batch.num_graphs),
                masked_mean_nodes(final, f_t, batch.num_graphs),
            ],
            dim=-1,
        )
        out = self.head(pooled)
        extras = {}
        if return_atts:
            extras["atts"] = atts
        if return_latent:
            extras["latent"] = pooled
        return (out, extras) if extras else out


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


class HLHGCNNTsp(nn.Module):
    """Edge-level model (reference HL_HGCNN_TSP_dense_int3_pyr,
    lib/Hodge_ST_Model.py:756-852): the backbone reads x_s without its last
    column (the augmentation mask); the readout concatenates the final x_s
    with |B1ᵀ x_t| / 2 (abs after the product, reference :848), then runs
    the one-term conv block "mlp" (only when ``mlp_channels`` has exactly
    one entry, as in the JAX module) and the K = 1 conv "out" on L1.  The
    float32 logits [..., num_classes] are multiplied by the mask column.
    ``in_t``/``in_s`` are the input widths, the mask column included."""

    def __init__(
        self, cfg: BackboneConfig, in_t: int, in_s: int, *,
        mlp_channels: tuple[int, ...] = (), num_classes: int = 1, generator=None,
    ):
        super().__init__()
        self.cfg = cfg
        self.backbone = DenseInt3Backbone(cfg, in_t, in_s - 1, generator)
        width = 2 * self.backbone.out_features
        self.has_mlp = len(mlp_channels) == 1
        if self.has_mlp:
            self.mlp = ConvBNAct(width, mlp_channels[0], 1, generator, **cfg.conv_kw())
            width = mlp_channels[0]
        self.out = LaguerreConv(width, num_classes, 1, generator=generator)

    def forward(self, batch: Batch) -> torch.Tensor:
        level = batch.level0
        x_s, aug_mask = batch.x_s[..., :-1], batch.x_s[..., -1:]
        x_t, x_s = head_cast(self.cfg, *self.backbone(batch.x_t, x_s, batch))
        x_s = torch.cat([x_s, b1_t2s(level, x_t).abs() / 2.0], dim=-1)
        if self.has_mlp:
            x_s = self.mlp(x_s, level.l1, level.edge_mask)
        return self.out(x_s, level.l1).float() * aug_mask
