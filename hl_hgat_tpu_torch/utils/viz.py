"""The arrays behind the analysis figures (``hl_hgat_tpu/utils/viz.py``;
reference L5).  Plotting is left to the caller's matplotlib.

* ``collect_outputs``: latents, predictions and labels stacked over a loader
  (reference ``visualize``, lib/Hodge_Dataset.py:51-70);
* ``feature_trends``: mean |activation| per layer from the backbone's
  snapshots (reference lib/Visualization.py:126-165, fig/tsp_trend.png);
* ``attention_fc_matrix`` and ``sort_by_parcels``: edge attention as a
  symmetric ROI × ROI matrix, ordered by parcel (reference
  ``plt_sort_anatomy``, HL-HGAT-DEMO/lib/Hodge_Dataset.py:53-107);
* ``edge_index_from_level``: the both-ways adjacency of a level's canonical
  edge list (reference ``pdata2data``, lib/Visualization.py:126-165).

Every function takes NumPy arrays or tensors on any device (a card tensor is
copied to the host) and returns NumPy arrays.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """A tensor (any device and dtype; bfloat16 widened to float32) or an
    array as a NumPy array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def collect_outputs(batches: Iterable, apply_fn: Callable[..., tuple]) -> dict[str, np.ndarray]:
    """``apply_fn(batch) -> (latent, pred)`` over ``batches``: latents,
    predictions and each batch's ``y``, concatenated (NumPy, on the host)."""
    outs, preds, ys = [], [], []
    for batch in batches:
        latent, pred = apply_fn(batch)
        outs.append(to_numpy(latent))
        preds.append(to_numpy(pred))
        ys.append(to_numpy(batch.y))
    return dict(latent=np.concatenate(outs), pred=np.concatenate(preds), y=np.concatenate(ys))


def feature_trends(snapshots, level) -> dict[str, np.ndarray]:
    """Mean |activation| per layer over the level's valid nodes and edges:
    ``snapshots`` is the backbone's list of (x_t, x_s), flat [N, C] or dense
    [G, S, C] as the level's masks."""
    node_mask = to_numpy(level.node_mask) > 0
    edge_mask = to_numpy(level.edge_mask) > 0
    return dict(
        node=np.asarray([np.abs(to_numpy(x_t))[node_mask].mean() for x_t, _ in snapshots]),
        edge=np.asarray([np.abs(to_numpy(x_s))[edge_mask].mean() for _, x_s in snapshots]),
    )


def attention_fc_matrix(edge_att, src, dst, num_nodes: int) -> np.ndarray:
    """Per-edge attention scattered into a symmetric [num_nodes, num_nodes]
    float64 matrix."""
    m = np.zeros((num_nodes, num_nodes), np.float64)
    a = to_numpy(edge_att).reshape(-1)
    src, dst = to_numpy(src), to_numpy(dst)
    m[src, dst] = a
    m[dst, src] = a
    return m


def sort_by_parcels(matrix: np.ndarray, parcel_labels) -> tuple[np.ndarray, np.ndarray,
                                                                  np.ndarray]:
    """An ROI × ROI matrix reordered by parcel membership (stable):
    (sorted matrix, permutation, indices where a parcel starts)."""
    labels = to_numpy(parcel_labels)
    perm = np.argsort(labels, kind="stable")
    boundaries = np.nonzero(np.diff(labels[perm]))[0] + 1
    return matrix[np.ix_(perm, perm)], perm, boundaries


def edge_index_from_level(level) -> np.ndarray:
    """[2, 2E] directed adjacency, both ways, of a flat level's real edges
    (the first ``edge_mask.sum()`` rows of its canonical src/dst)."""
    e = int(to_numpy(level.edge_mask).sum())
    src, dst = to_numpy(level.src)[:e], to_numpy(level.dst)[:e]
    return np.concatenate([np.stack([src, dst]), np.stack([dst, src])], axis=1)
