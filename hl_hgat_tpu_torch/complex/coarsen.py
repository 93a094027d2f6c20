"""Multi-level graph coarsening (MLGC): graclus matching and the coarse complex.

A NumPy copy of ``hl_hgat_tpu/complex/coarsen.py`` (the JAX package's module
reaches ``hl_hgat_tpu.native`` and its build module, so the port keeps its
own).  It takes the JAX package's pure-Python paths, which give the same
assignments as its native matcher: greedy heavy-edge matching, nodes visited
in index order, each node's neighbours in ascending index order for the
unweighted build (the reference runs graclus on the symmetric, row-major L0
pattern, reference lib/Hodge_Dataset.py:241-295) and by descending weight
for the weighted one (lib/Hodge_Dataset.py:298-353).  Host-side dataset
preprocessing, never on the training path.  The brain variants (pruned
edges, dropped nodes, torch-cluster's visit order) come with the brain
family.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hl_hgat_tpu_torch.complex.build import GraphStructure, build_structure


@dataclasses.dataclass
class MLGCLevel:
    """Result of one coarsening step."""

    structure: GraphStructure  # the coarse complex
    c_node: np.ndarray  # [n_fine] int32 coarse node id per fine node
    c_edge: np.ndarray  # [e_fine] int32 coarse edge id; −1 = deleted


def graclus_cluster(
    src: np.ndarray, dst: np.ndarray, weight: np.ndarray | None, num_nodes: int,
    *, directed: bool = False,
) -> np.ndarray:
    """Greedy heavy-edge matching; a representative node id per node.

    Nodes are visited in index order; each unmatched node is matched with
    its first unmatched neighbour, neighbours ordered by descending weight
    (insertion order among equal weights); a node with none stays a
    singleton.  The pair's id is the smaller index.  ``directed``: a node
    only sees the neighbours it points to.
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
    for u in range(num_nodes):
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
    """Coarse edge set in first-seen order and the fine→coarse edge map.

    A fine edge whose endpoints fall into one cluster is deleted (map −1);
    otherwise the coarse edge (min, max) is created on first sight and
    reused after (reference lib/Hodge_Dataset.py:260-274).
    """
    c_edge = np.zeros(src.shape[0], np.int64)
    ei0: list[int] = []
    ei1: list[int] = []
    seen: dict[tuple[int, int], int] = {}
    for i in range(src.shape[0]):
        a, b = int(c_node[src[i]]), int(c_node[dst[i]])
        if a == b:
            c_edge[i] = -1
            continue
        key = (min(a, b), max(a, b))
        if key not in seen:
            seen[key] = len(ei0)
            ei0.append(key[0])
            ei1.append(key[1])
        c_edge[i] = seen[key]
    return np.asarray(ei0, np.int32), np.asarray(ei1, np.int32), c_edge


def mlgc(structure: GraphStructure, *, edge_weight: np.ndarray | None = None) -> MLGCLevel:
    """One MLGC coarsening step: unweighted graclus on the node graph with
    neighbours in ascending index order, or weighted matching when
    ``edge_weight`` is given."""
    src, dst, n = structure.src, structure.dst, structure.num_nodes
    if edge_weight is None:
        # the symmetric edge list sorted row-major, walked as given: each
        # node meets its neighbours in ascending index order
        ss = np.concatenate([src, dst])
        dd = np.concatenate([dst, src])
        order = np.lexsort((dd, ss))
        rep = graclus_cluster(ss[order], dd[order], None, n, directed=True)
    else:
        rep = graclus_cluster(src, dst, edge_weight, n)
    uniq, c_node = np.unique(rep, return_inverse=True)
    csrc, cdst, c_edge = coarse_edges(c_node, src, dst)
    return MLGCLevel(
        structure=build_structure(csrc, cdst, uniq.size),
        c_node=c_node.astype(np.int32),
        c_edge=c_edge.astype(np.int32),
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
