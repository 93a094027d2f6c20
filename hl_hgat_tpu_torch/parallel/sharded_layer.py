"""One HL-HGAT layer over a graph-sharded complex
(``hl_hgat_tpu/parallel/sharded_layer.py``).

The single-complex regime written out with explicit weights: node features
live in node row blocks, edge features in edge row blocks, one per rank of
the graph group, and one layer runs distributed —

* the MSI boundary couplings through rectangular halo shards of |B1|
  (nodes × edges) and |B1|ᵀ (edges × nodes),
* the Laguerre convs over L0 and L1 through the halo-exchange mat-vec,
* BatchNorm with the count, sum and squared deviation summed over the
  group, so it normalizes as the unsharded layer does,
* the pointwise GEMMs and activations on each rank's rows alone.

It is the collective-level check of the graph path; ``gp_model.py`` runs
whole models over the same shards.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.build import GraphStructure
from hl_hgat_tpu_torch.parallel.graph_parallel import (
    HaloShard,
    all_reduce_sum,
    halo_matvec,
    partition_halo,
)


@dataclasses.dataclass(frozen=True)
class ShardedComplex:
    """One complex partitioned for the graph axis: host form with every
    part stacked on the leading axis (``part`` None), or one rank's part."""

    l0: HaloShard  # nodes × nodes
    l1: HaloShard  # edges × edges
    b1_abs: HaloShard  # nodes × edges (values |B1| = 1)
    b1t_abs: HaloShard  # edges × nodes
    deg: Any  # [P, n_local]
    node_mask: Any  # [P, n_local]
    edge_mask: Any  # [P, e_local]
    n_parts: int
    part: int | None = None
    group: Any = None

    def local(self, part: int, device, group=None) -> "ShardedComplex":
        def t(a):
            return torch.as_tensor(np.asarray(a[part])).to(device)

        return ShardedComplex(
            **{k: getattr(self, k).local(part, device, group)
               for k in ("l0", "l1", "b1_abs", "b1t_abs")},
            deg=t(self.deg), node_mask=t(self.node_mask), edge_mask=t(self.edge_mask),
            n_parts=self.n_parts, part=part, group=group)


def build_sharded_complex(st: GraphStructure, n_parts: int) -> ShardedComplex:
    """Host-side partitioning of one complex into halo shards."""
    n, e = st.num_nodes, st.num_edges
    l0, _ = partition_halo(st.l0_rows, st.l0_cols, st.l0_vals, n, n_parts)
    l1, _ = partition_halo(st.l1_rows, st.l1_cols, st.l1_vals, e, n_parts)
    eidx = np.arange(e, dtype=np.int32)
    ones = np.ones(2 * e, np.float32)
    ends = np.concatenate([st.src, st.dst])
    b1_abs, _ = partition_halo(ends, np.concatenate([eidx, eidx]), ones, n, n_parts,
                               num_cols=e)
    b1t_abs, _ = partition_halo(np.concatenate([eidx, eidx]), ends, ones, e, n_parts,
                                num_cols=n)
    n_local, e_local = l0.n_local, l1.n_local
    deg = np.zeros(n_parts * n_local, np.float32)
    np.add.at(deg, st.src, 1.0)
    np.add.at(deg, st.dst, 1.0)
    node_mask = np.zeros(n_parts * n_local, np.float32)
    node_mask[:n] = 1.0
    edge_mask = np.zeros(n_parts * e_local, np.float32)
    edge_mask[:e] = 1.0
    return ShardedComplex(
        l0=l0, l1=l1, b1_abs=b1_abs, b1t_abs=b1t_abs,
        deg=deg.reshape(n_parts, n_local),
        node_mask=node_mask.reshape(n_parts, n_local),
        edge_mask=edge_mask.reshape(n_parts, e_local),
        n_parts=n_parts)


def pad_features(x: np.ndarray, n_parts: int) -> np.ndarray:
    """[N, F] → [P, ceil(N/P), F] block layout."""
    n_local = -(-x.shape[0] // n_parts)
    xp = np.zeros((n_parts * n_local,) + x.shape[1:], x.dtype)
    xp[:x.shape[0]] = x
    return xp.reshape((n_parts, n_local) + x.shape[1:])


def _sharded_bn(x, mask, scale, offset, group, eps: float = 1e-5):
    """BatchNorm on the group's statistics (the JAX layer's two-pass form)."""
    m = mask[:, None]
    count = all_reduce_sum(m.sum()[None], group)[0].clamp(min=1.0)
    mean = all_reduce_sum((x * m).sum(0), group) / count
    var = all_reduce_sum(((x - mean) ** 2 * m).sum(0), group) / count
    y = (x - mean) * torch.rsqrt(var.clamp(min=0.0) + eps) * scale + offset
    return y * m


def _laguerre_local(shard: HaloShard, x, w, b):
    terms = [x]
    if w.shape[0] > 1:
        terms.append(x - halo_matvec(shard, x))
    for j in range(1, w.shape[0] - 1):
        lt = halo_matvec(shard, terms[-1])
        terms.append((-lt + (2 * j + 1) * terms[-1] - j * terms[-2]) / (j + 1))
    return torch.cat(terms, dim=-1) @ w.reshape(-1, w.shape[-1]) + b


@dataclasses.dataclass(frozen=True)
class HLLayerWeights:
    """Explicit weights of one MSI + conv-pair layer."""

    wv_node1: Any
    bv_node1: Any
    wv_node2: Any
    bv_node2: Any
    wv_edge1: Any
    bv_edge1: Any
    wv_edge2: Any
    bv_edge2: Any
    conv_t_w: Any  # [K, C, F]
    conv_t_b: Any
    conv_s_w: Any
    conv_s_b: Any
    bn_scales: tuple  # 6 (scale, offset) pairs: msi × 4, conv × 2

    def to(self, device) -> "HLLayerWeights":
        def t(a):
            return torch.as_tensor(a).to(device)

        return HLLayerWeights(
            **{f.name: t(getattr(self, f.name)) for f in dataclasses.fields(self)
               if f.name != "bn_scales"},
            bn_scales=tuple((t(s), t(o)) for s, o in self.bn_scales))


def sharded_hl_layer(weights: HLLayerWeights, comp: ShardedComplex, x_t: torch.Tensor,
                     x_s: torch.Tensor, *, deg_eps: float = 1e-6):
    """One full HL layer (MSI value mode → Laguerre conv pair → BN → ReLU)
    on this rank's part: ``comp`` a local `ShardedComplex`, x_t
    [n_local, C], x_s [e_local, C].  Equal to the unsharded layer's math
    with batch-statistics BN."""
    group = comp.group
    deg = comp.deg + deg_eps
    nmask, emask = comp.node_mask, comp.edge_mask
    s2t = halo_matvec(comp.b1_abs, x_s) / torch.where(deg > 0, deg, torch.ones_like(deg))[:, None]
    t2s = halo_matvec(comp.b1t_abs, x_t) / 2.0

    def value_head(z, mask, w1, b1, w2, b2, bn1, bn2):
        z = torch.relu(_sharded_bn(z @ w1 + b1, mask, *bn1, group))
        return torch.relu(_sharded_bn(z @ w2 + b2, mask, *bn2, group))

    w, bns = weights, weights.bn_scales
    v_t = value_head(torch.cat([s2t, x_t], dim=-1), nmask, w.wv_node1, w.bv_node1,
                     w.wv_node2, w.bv_node2, bns[0], bns[1])
    v_s = value_head(torch.cat([t2s, x_s], dim=-1), emask, w.wv_edge1, w.bv_edge1,
                     w.wv_edge2, w.bv_edge2, bns[2], bns[3])
    y_t = torch.relu(_sharded_bn(_laguerre_local(comp.l0, v_t, w.conv_t_w, w.conv_t_b),
                                 nmask, *bns[4], group))
    y_s = torch.relu(_sharded_bn(_laguerre_local(comp.l1, v_s, w.conv_s_w, w.conv_s_b),
                                 emask, *bns[5], group))
    return y_t, y_s
