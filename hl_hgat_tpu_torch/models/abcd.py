"""The brain / ABCD model (``hl_hgat_tpu/models/abcd.py``; reference
``HL_HGCNN_ABCD_dense_int3_attpool``, lib/Hodge_ST_Model.py:26-168).

``Inception1D`` embeds each node's time course, the dense-int3 trunk pools
with sigmoid gates computed from the last layer's features and multiplied
into the stacks, K = 1 convs read out one channel per simplex, and an MLP
reads the flattened [edges ‖ nodes] vector — valid because every subject
shares one skeleton, so the per-graph simplex counts are constant.  Either
layout: a flat `ComplexBatch` ([N, T] time courses) or a
``collate_dense_shared`` batch ([G, S, T], one shared operator a level).
"""

from __future__ import annotations

import torch
from torch import nn

from hl_hgat_tpu_torch.complex.dense import Batch, DenseLevel
from hl_hgat_tpu_torch.models.backbone import BackboneConfig, DenseInt3Backbone, MLPHead, head_cast
from hl_hgat_tpu_torch.nn.conv import LaguerreConv
from hl_hgat_tpu_torch.nn.inception import Inception1D


def flatten_per_graph(x: torch.Tensor, num_graphs: int, per_graph: int) -> torch.Tensor:
    """[N, 1] (flat) or [G, S, 1] (dense) → [G, per_graph].  Needs each
    graph's rows contiguous with padding at the tail: the flat ``collate``
    and ``collate_dense_shared`` keep the samples' simplex order (a
    packed, BFS-reordered batch does not, and is not for these models)."""
    if x.dim() == 3:
        return x[:, :per_graph, 0]
    return x[: num_graphs * per_graph].reshape(num_graphs, per_graph)


def embed_time_courses(inception: Inception1D, batch: Batch) -> torch.Tensor:
    """Inception1D over every node row's time course, padding rows zeroed;
    a dense batch's [G, S, T] is flattened around it.  A packed batch
    (graph ids on its rows) raises: its rows are not one graph a block, so
    the flatten readout would read the wrong rows."""
    if isinstance(batch.level0, DenseLevel) and batch.level0.n_gid is not None:
        raise ValueError("the brain models read a flat batch or a collate_dense_shared one, "
                         "not a packed one")
    x_t, mask = batch.x_t, batch.level0.node_mask
    rows = x_t.reshape(-1, x_t.shape[-1])
    flat_mask = mask.reshape(-1)
    out = inception(rows, flat_mask)
    out = out * flat_mask.to(out.dtype)[:, None]
    return out.reshape(*x_t.shape[:-1], out.shape[-1])


class HLHGCNNAbcd(nn.Module):
    """Returns float32 [G, num_classes].  ``in_s`` is the edge feature
    width (the FC value: 1)."""

    def __init__(
        self, cfg: BackboneConfig, in_s: int = 1, *, mlp_channels: tuple[int, ...] = (),
        num_classes: int = 1, dropout_mlp: float = 0.0, inception_channels: int = 64,
        inception_num_channels: int = 8, nodes_per_graph: int = 0, edges_per_graph: int = 0,
        generator=None,
    ):
        super().__init__()
        self.cfg = cfg
        self.nodes_per_graph, self.edges_per_graph = nodes_per_graph, edges_per_graph
        self.node_embedding = Inception1D(
            inception_channels, inception_num_channels, compute_dtype=cfg.compute_dtype,
            generator=generator)
        self.backbone = DenseInt3Backbone(cfg, self.node_embedding.out_features, in_s, generator)
        width = self.backbone.out_features
        self.readout_node = LaguerreConv(width, 1, 1, generator=generator)
        self.readout_edge = LaguerreConv(width, 1, 1, generator=generator)
        self.head = MLPHead(nodes_per_graph + edges_per_graph, tuple(mlp_channels), num_classes,
                            generator, act=cfg.act, leaky_slope=cfg.leaky_slope,
                            dropout=dropout_mlp)

    def forward(self, batch: Batch) -> torch.Tensor:
        x_t = embed_time_courses(self.node_embedding, batch)
        x_t, x_s = self.backbone(x_t, batch.x_s, batch)
        level = batch.levels[self.backbone.level_idx]
        f_t, f_s = head_cast(self.cfg, x_t, x_s)
        r_t = self.readout_node(f_t, level.l0)
        r_s = self.readout_edge(f_s, level.l1)
        g = batch.num_graphs
        x = torch.cat([flatten_per_graph(r_s, g, self.edges_per_graph),
                       flatten_per_graph(r_t, g, self.nodes_per_graph)], dim=-1)
        return self.head(x)
