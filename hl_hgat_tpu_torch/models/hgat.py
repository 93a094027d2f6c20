"""The HL-HGAT attention-pooling model (``hl_hgat_tpu/models/hgat.py``;
reference ``HL_HGAT_attpool``, HL-HGAT-DEMO/lib/Hodge_Cheb_Conv.py:250-399).

Inception1D embedding (max and mean readout) → dense-int3 trunk pooling at
the first ``pool_num`` blocks with sigmoid gates computed from the stacks
and multiplied into them → K = 1 conv readout → flattened MLP.  Returns
``(pred, latent, node_att, edge_att)``: the float32 prediction, the MLP's
last hidden layer, and the first gated block's gates on level 0 per graph
(reference :374-376, :399), the maps the OHBM notebook visualizes.  Unlike
the ABCD model it casts nothing before the readout (no ``head_cast``).
"""

from __future__ import annotations

import torch
from torch import nn

from hl_hgat_tpu_torch.complex.dense import Batch
from hl_hgat_tpu_torch.models.abcd import embed_time_courses, flatten_per_graph
from hl_hgat_tpu_torch.models.backbone import BackboneConfig, DenseInt3Backbone, MLPHead
from hl_hgat_tpu_torch.nn.conv import LaguerreConv
from hl_hgat_tpu_torch.nn.inception import Inception1D


class HLHGATAttpool(nn.Module):
    """``in_s``: the edge feature width (the FC value: 1); the node rows are
    time courses.  ``nodes_per_graph``/``edges_per_graph`` count the final
    level's simplices, ``fine_*`` level 0's.  The JAX module's
    ``use_inception=False`` (raw node features), which no caller sets, is
    not carried over."""

    def __init__(
        self, cfg: BackboneConfig, in_s: int = 1, *, mlp_channels: tuple[int, ...] = (),
        num_classes: int = 1, dropout_mlp: float = 0.0, nodes_per_graph: int = 0,
        edges_per_graph: int = 0, fine_nodes_per_graph: int = 0,
        fine_edges_per_graph: int = 0, generator=None,
    ):
        super().__init__()
        if not cfg.pool_locs and not cfg.att_locs:
            raise ValueError("HLHGATAttpool returns the first gates: the trunk must gate")
        self.cfg = cfg
        self.nodes_per_graph, self.edges_per_graph = nodes_per_graph, edges_per_graph
        self.fine_nodes_per_graph = fine_nodes_per_graph
        self.fine_edges_per_graph = fine_edges_per_graph
        self.node_embedding = Inception1D(readout_mode="max_mean",
                                          compute_dtype=cfg.compute_dtype, generator=generator)
        self.backbone = DenseInt3Backbone(cfg, self.node_embedding.out_features, in_s,
                                          generator)
        width = self.backbone.out_features
        self.readout_node = LaguerreConv(width, 1, 1, generator=generator)
        self.readout_edge = LaguerreConv(width, 1, 1, generator=generator)
        self.head = MLPHead(nodes_per_graph + edges_per_graph, tuple(mlp_channels), num_classes,
                            generator, act=cfg.act, leaky_slope=cfg.leaky_slope,
                            dropout=dropout_mlp)

    def forward(self, batch: Batch):
        x_t = embed_time_courses(self.node_embedding, batch)
        x_t, x_s, atts = self.backbone(x_t, batch.x_s, batch, return_atts=True)
        level = batch.levels[self.backbone.level_idx]
        r_t = self.readout_node(x_t, level.l0)
        r_s = self.readout_edge(x_s, level.l1)
        g = batch.num_graphs
        x = torch.cat([flatten_per_graph(r_s, g, self.edges_per_graph),
                       flatten_per_graph(r_t, g, self.nodes_per_graph)], dim=-1)
        pred, latent = self.head(x, return_latent=True)
        a_t, a_s = atts[0]
        return (pred, latent, flatten_per_graph(a_t, g, self.fine_nodes_per_graph),
                flatten_per_graph(a_s, g, self.fine_edges_per_graph))
