"""Multi-level graph coarsening (MLGC): graclus matching and the coarse complex.

A NumPy copy of ``hl_hgat_tpu/complex/coarsen.py`` that takes the same
matcher in each case: greedy heavy-edge matching, nodes visited in index
order.  The unweighted build (the reference runs graclus on the symmetric,
row-major L0 pattern, reference lib/Hodge_Dataset.py:241-295) and the
weighted one (neighbours by descending weight, lib/Hodge_Dataset.py:298-353)
run the host library's ``graclus_match`` (``native.py``); the unweighted
build sorts the canonical list row-major first, so each node meets its
neighbours in ascending index order.  A given visit order or directed
matching (the brain pyramid) takes the Python walk of ``graclus_cluster``.
The coarse edges always come from the library's ``coarse_edges``.
Host-side dataset preprocessing, never on the training path.  The brain
options of ``mlgc`` (pooled edge features, pruned coarse edges, dropped
nodes, a given visit order, directed matching) are the JAX module's too:
with them the brain pyramid of ``data/brain.py`` reproduces the
reference's torch-cluster run (HL-HGAT-DEMO/lib/Hodge_Dataset.py:219-258).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hl_hgat_tpu_torch import native
from hl_hgat_tpu_torch.complex.build import GraphStructure, build_structure


@dataclasses.dataclass
class MLGCLevel:
    """Result of one coarsening step."""

    structure: GraphStructure  # the coarse complex
    c_node: np.ndarray  # [n_fine] int32 coarse node id per fine node
    c_edge: np.ndarray  # [e_fine] int32 coarse edge id; −1 = deleted
    x_s_pool: np.ndarray | None = None  # the fine edge features pooled (brain variant)


def graclus_cluster(
    src: np.ndarray, dst: np.ndarray, weight: np.ndarray | None, num_nodes: int,
    *, directed: bool = False, visit: np.ndarray | None = None,
) -> np.ndarray:
    """Greedy heavy-edge matching; a representative node id per node.

    Nodes are visited in index order, or in the order ``visit`` gives;
    each unmatched node is matched with its first unmatched neighbour,
    neighbours ordered by descending weight (insertion order among equal
    weights); a node with none stays a singleton.  The pair's id is the
    smaller index.  ``directed``: a node only sees the neighbours it points
    to (torch-cluster's graclus on a canonical src < dst list, which it
    does not symmetrize).
    """
    w = np.ones(src.shape[0], np.float64) if weight is None else np.asarray(weight, np.float64)
    nbr: list[list[int]] = [[] for _ in range(num_nodes)]
    for i in np.argsort(-w, kind="stable"):
        u, v = int(src[i]), int(dst[i])
        if u == v:
            continue
        nbr[u].append(v)
        if not directed:
            nbr[v].append(u)
    match = np.full(num_nodes, -1, np.int64)
    order = range(num_nodes) if visit is None else (int(u) for u in visit)
    for u in order:
        if match[u] >= 0:
            continue
        best = next((v for v in nbr[u] if match[v] < 0), -1)
        rep = min(u, best) if best >= 0 else u
        match[u] = rep
        if best >= 0:
            match[best] = rep
    return match


def coarse_edges(
    c_node: np.ndarray, src: np.ndarray, dst: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Coarse edge set in first-seen order and the fine→coarse edge map
    (the host library's ``coarse_edges``).

    A fine edge whose endpoints fall into one cluster is deleted (map −1);
    otherwise the coarse edge (min, max) is created on first sight and
    reused after (reference lib/Hodge_Dataset.py:260-274).
    """
    return native.coarse_edges(c_node, src, dst)


def mlgc(
    structure: GraphStructure, *,
    edge_weight: np.ndarray | None = None,
    x_s: np.ndarray | None = None,
    prune_single_fine_edges: bool = False,
    drop_isolated_nodes: bool = False,
    visit: np.ndarray | None = None,
    directed_match: bool = False,
) -> MLGCLevel:
    """One MLGC coarsening step.

    * default: unweighted graclus on the node graph with neighbours in
      ascending index order (reference ``MLGC``);
    * ``edge_weight``: weighted matching (``MLGC_weighted``, or the brain
      ``MLGC_Weight`` with FC weights);
    * ``visit`` / ``directed_match``: torch-cluster's visit order and its
      unsymmetrized neighbour lists (the brain pyramid);
    * ``prune_single_fine_edges`` / ``drop_isolated_nodes``: the brain-demo
      refinements (reference HL-HGAT-DEMO/lib/Hodge_Dataset.py:219-242) that
      delete coarse edges backed by exactly one fine edge and remove the
      nodes left isolated, remapping the assignments (dropped fine nodes
      map to −1);
    * ``x_s``: also mean-pool the fine edge features onto the coarse edges
      (reference HL-HGAT-DEMO/lib/Hodge_Dataset.py:255-258).
    """
    src, dst, n = structure.src, structure.dst, structure.num_nodes
    if visit is None and not directed_match:
        if edge_weight is None:
            # the canonical list sorted row-major (coarse levels come out of
            # the first-seen dedup unsorted): the symmetrizing matcher then
            # meets each node's neighbours in ascending index order
            order = np.lexsort((dst, src))
            rep = native.graclus_match(src[order], dst[order], None, n)
        else:
            rep = native.graclus_match(src, dst, edge_weight, n)
    else:
        rep = graclus_cluster(src, dst, edge_weight, n, directed=directed_match, visit=visit)
    uniq, c_node = np.unique(rep, return_inverse=True)
    n_coarse = uniq.size
    csrc, cdst, c_edge = coarse_edges(c_node, src, dst)

    if prune_single_fine_edges:
        backing = np.bincount(c_edge[c_edge >= 0], minlength=csrc.size)
        keep = backing >= 2
        new_ids = np.cumsum(keep) - 1
        csrc, cdst = csrc[keep], cdst[keep]
        kept = c_edge >= 0
        kept[kept] = keep[c_edge[kept]]
        remapped = np.full_like(c_edge, -1)
        remapped[kept] = new_ids[c_edge[kept]]
        c_edge = remapped

    if drop_isolated_nodes:
        used = np.zeros(n_coarse, bool)
        used[csrc] = True
        used[cdst] = True
        node_new = np.full(n_coarse, -1, np.int64)
        node_new[used] = np.arange(int(used.sum()))
        csrc, cdst = node_new[csrc], node_new[cdst]
        c_node = node_new[c_node]
        n_coarse = int(used.sum())

    x_s_pool = None
    if x_s is not None:
        valid = c_edge >= 0
        sums = np.zeros((csrc.size,) + x_s.shape[1:], np.float64)
        cnt = np.zeros(csrc.size, np.float64)
        np.add.at(sums, c_edge[valid], x_s[valid])
        np.add.at(cnt, c_edge[valid], 1.0)
        x_s_pool = (sums / np.maximum(cnt, 1.0).reshape((-1,) + (1,) * (x_s.ndim - 1))
                    ).astype(np.float32)
    return MLGCLevel(
        structure=build_structure(csrc.astype(np.int32), cdst.astype(np.int32), n_coarse),
        c_node=c_node.astype(np.int32),
        c_edge=c_edge.astype(np.int32),
        x_s_pool=x_s_pool,
    )


def build_pyramid(
    sample_levels: list[GraphStructure], num_pool: int, *,
    weighted_by: np.ndarray | None = None,
) -> tuple[list[GraphStructure], list[tuple[np.ndarray, np.ndarray]]]:
    """Coarsen ``num_pool`` times: the level list and the pool assignments
    (reference lib/Hodge_Dataset.py:523-527).  Weights apply to the first
    level only."""
    levels = list(sample_levels)
    pools: list[tuple[np.ndarray, np.ndarray]] = []
    weight = weighted_by
    for _ in range(num_pool):
        lvl = mlgc(levels[-1], edge_weight=weight)
        levels.append(lvl.structure)
        pools.append((lvl.c_node, lvl.c_edge))
        weight = None
    return levels, pools
