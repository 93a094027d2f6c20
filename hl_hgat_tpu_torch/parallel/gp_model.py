"""Full-model graph parallelism: one large complex sharded over the ranks of
a graph group (``hl_hgat_tpu/parallel/gp_model.py``).

``build_gp_batch`` pads every pyramid level to part-aligned sizes (a
multiple of the part count; global simplex id == padded row, padding at the
tail) and gives each rank a `ComplexBatch` of its rows: features, masks,
graph ids and degrees; L0, L1 and the boundary couplings as `HaloShard`s;
pool maps from its fine rows to global coarse ids.

The JAX package runs the model unmodified at global view and lets GSPMD
partition everything but the SpMM.  Torch has no such partitioner, so each
op that crosses the row partition goes through a collective where it is
dispatched (``ops/dispatch.py``: mat-vecs, boundary couplings, readouts,
pooling; ``nn/norm.py`` and ``nn/pool.py`` under ``graph_axis``: masked
BatchNorm statistics, the gate max).  Every model built on those runs
unchanged::

    batch = build_gp_batch(sample, n_parts, group=graph_group)  # this rank's part
    out = gp_apply(model, batch)                               # replicated [1, classes]

Training: ``DataParallelTrainer`` over a mesh with a graph axis runs the
forward under ``graph_axis`` and averages the gradients over the ranks,
which gives the single-device step (``graph_parallel.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from hl_hgat_tpu_torch.complex.batch import ComplexBatch, PoolMap
from hl_hgat_tpu_torch.complex.build import GraphSample, GraphStructure
from hl_hgat_tpu_torch.device import resolve_device
from hl_hgat_tpu_torch.parallel.graph_parallel import (
    ShardedLevel,
    graph_axis,
    partition_halo,
)


def _pad_to(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    out = np.full((n,) + a.shape[1:], fill, a.dtype)
    out[:a.shape[0]] = a
    return out


def _build_gp_level(st: GraphStructure, n_parts: int, part: int, device, group):
    """One level padded to part-aligned sizes: this part's ShardedLevel and
    the padded (nodes, edges)."""
    n, e = st.num_nodes, st.num_edges
    n_local = -(-max(n, 1) // n_parts)
    e_local = -(-max(e, 1) // n_parts)
    np_pad, ep_pad = n_parts * n_local, n_parts * e_local

    l0, _ = partition_halo(st.l0_rows, st.l0_cols, st.l0_vals, np_pad, n_parts)
    l1, _ = partition_halo(st.l1_rows, st.l1_cols, st.l1_vals, ep_pad, n_parts)
    eidx = np.arange(e, dtype=np.int32)
    ends = np.concatenate([st.src, st.dst]).astype(np.int32)
    both = np.concatenate([eidx, eidx])
    ones = np.ones(2 * e, np.float32)
    signed = np.concatenate([-ones[:e], ones[e:]])  # B1: −1 at src, +1 at dst
    b1_abs, _ = partition_halo(ends, both, ones, np_pad, n_parts, num_cols=ep_pad)
    b1t_abs, _ = partition_halo(both, ends, ones, ep_pad, n_parts, num_cols=np_pad)
    b1t, _ = partition_halo(both, ends, signed, ep_pad, n_parts, num_cols=np_pad)

    deg = np.zeros(np_pad, np.float32)
    np.add.at(deg, st.src, 1.0)
    np.add.at(deg, st.dst, 1.0)
    node_mask = np.zeros(np_pad, np.float32)
    node_mask[:n] = 1.0
    edge_mask = np.zeros(ep_pad, np.float32)
    edge_mask[:e] = 1.0
    # one complex: every simplex belongs to graph 0; padding → dump id 1
    n_id = np.where(node_mask > 0, 0, 1).astype(np.int32)
    s_id = np.where(edge_mask > 0, 0, 1).astype(np.int32)

    def rows(a, k):
        return torch.from_numpy(np.ascontiguousarray(a[part * k:(part + 1) * k])).to(device)

    level = ShardedLevel(
        node_mask=rows(node_mask, n_local), edge_mask=rows(edge_mask, e_local),
        n_id=rows(n_id, n_local), s_id=rows(s_id, e_local), deg=rows(deg, n_local),
        **{name: shard.local(part, device, group) for name, shard in
           (("l0", l0), ("l1", l1), ("b1_abs", b1_abs), ("b1t_abs", b1t_abs), ("b1t", b1t))},
        n_parts=n_parts, part=part, group=group)
    return level, (np_pad, ep_pad)


def build_gp_batch(sample: GraphSample, n_parts: int, part: int | None = None, *,
                   group=None, device=None) -> ComplexBatch:
    """This rank's part of ONE complex (with its pyramid) sharded over
    ``n_parts`` ranks of ``group`` (None: the default group; ``part``
    defaults to this rank's index there).  On the card unless ``device``
    says otherwise.  ``y`` is replicated, [1, ...]."""
    device = resolve_device(device)
    if part is None:
        part = dist.get_rank(group)
    levels, pads = [], []
    for st in sample.levels:
        level, pad = _build_gp_level(st, n_parts, part, device, group)
        levels.append(level)
        pads.append(pad)

    def rows(a, n_pad):
        k = n_pad // n_parts
        return torch.from_numpy(np.ascontiguousarray(a[part * k:(part + 1) * k])).to(device)

    pools = []
    for k, (c_node, c_edge) in enumerate(sample.pools):
        npc, epc = pads[k + 1]
        pos_t = _pad_to(c_node.astype(np.int32), pads[k][0], fill=npc)
        c_edge = c_edge.astype(np.int32)
        c_edge = np.where(c_edge < 0, epc, c_edge)  # deleted → coarse dump
        pos_s = _pad_to(c_edge, pads[k][1], fill=epc)
        pools.append(PoolMap(pos_t=rows(pos_t, pads[k][0]), pos_s=rows(pos_s, pads[k][1])))

    x_t = _pad_to(sample.x_t.astype(np.float32), pads[0][0])
    x_s = _pad_to(sample.x_s.astype(np.float32), pads[0][1])
    y = torch.from_numpy(np.asarray(sample.y, np.float32).reshape(1, -1)).to(device)
    return ComplexBatch(x_t=rows(x_t, pads[0][0]), x_s=rows(x_s, pads[0][1]), y=y,
                        levels=tuple(levels), pools=tuple(pools), num_graphs=1)


def gp_apply(model: torch.nn.Module, batch: ComplexBatch, **kw):
    """``model(batch)`` on this rank's part of a `build_gp_batch` batch,
    with the masked statistics reduced over its graph group."""
    with graph_axis(batch.level0.group):
        return model(batch, **kw)
