"""Synthetic simplex graphs shaped like the real benchmarks.

Copies of ``hl_hgat_tpu/data/synthetic.py``'s generators: the same
``np.random.Generator`` call sequence, so a seed gives both packages the
same samples.
"""

from __future__ import annotations

import numpy as np

from hl_hgat_tpu_torch.complex.batch import ComplexBatch
from hl_hgat_tpu_torch.complex.build import GraphSample, build_complex, collate
from hl_hgat_tpu_torch.complex.coarsen import build_pyramid
from hl_hgat_tpu_torch.complex.dense import reorder_sample


def _random_connected(rng: np.random.Generator, n: int, extra: int):
    parents = rng.integers(0, np.maximum(np.arange(1, n), 1))
    pairs = {
        (int(min(p, i)), int(max(p, i)))
        for i, p in zip(range(1, n), parents)
    }
    for _ in range(extra):
        a, b = rng.integers(0, n, 2)
        if a != b:
            pairs.add((int(min(a, b)), int(max(a, b))))
    arr = np.array(sorted(pairs), np.int64)
    return arr[:, 0], arr[:, 1]


def random_simplex_sample(
    rng: np.random.Generator,
    *,
    n_nodes: int = 23,
    extra_edges: int = 4,
    node_feat: int = 21,
    edge_feat: int = 3,
    keig: int = 8,
    num_pool: int = 0,
    y_dim: int = 1,
) -> GraphSample:
    """A random connected graph lifted to a simplex sample; ``num_pool``
    coarsened levels (MLGC) below it."""
    src, dst = _random_connected(rng, n_nodes, extra_edges)
    e = src.shape[0]
    sample = build_complex(
        np.stack([src, dst]),
        n_nodes,
        x_t=rng.standard_normal((n_nodes, node_feat)).astype(np.float32),
        x_s=rng.standard_normal((e, edge_feat)).astype(np.float32),
        y=rng.standard_normal(y_dim).astype(np.float32),
        keig=keig,
    )
    if num_pool:
        sample.levels, sample.pools = build_pyramid(sample.levels, num_pool)
    return sample


def pooled_like_samples(
    rng: np.random.Generator, count: int, *, benchmark: str = "cifar10sp",
    num_pool: int = 1,
) -> list[GraphSample]:
    """The JAX CLI's synthetic ``cifar10sp`` / ``pepfunc`` samples
    (``hl_hgat_tpu/run.py:310-319``): 20–59 nodes, 4 extra edges, 9 node
    and 3 edge features, ``keig`` 10, ``num_pool`` coarsened levels; a
    class id in [0, 10) (cifar10sp) or 10 binary labels (pepfunc)."""
    samples = []
    for _ in range(count):
        s = random_simplex_sample(
            rng, n_nodes=int(rng.integers(20, 60)), node_feat=9, edge_feat=3, keig=10,
            num_pool=num_pool, y_dim=10 if benchmark == "pepfunc" else 1,
        )
        if benchmark == "pepfunc":
            s.y = (s.y > 0).astype(np.float32)
        else:
            s.y = np.asarray([int(abs(s.y[0]) * 7) % 10], np.float32)
        samples.append(s)
    return samples


def zinc_like_samples(
    rng: np.random.Generator, count: int, *, keig: int = 16, embed_ids: bool = True
) -> list[GraphSample]:
    """ZINC-shaped molecules as ``bench.py`` draws them: n in [15, 33)
    atoms, [2, 6) extra edges, ``keig - 1`` PE columns and, with
    ``embed_ids``, integer atom ids (28 types) and bond ids (4 types) in
    feature column 0 (else 21 and 3 random feature columns)."""
    samples = []
    for _ in range(count):
        n = int(rng.integers(15, 33))
        s = random_simplex_sample(
            rng, n_nodes=n, extra_edges=int(rng.integers(2, 6)),
            node_feat=1 if embed_ids else 21, edge_feat=1 if embed_ids else 3,
            keig=keig,
        )
        if embed_ids:
            s.x_t[:, 0] = rng.integers(0, 28, s.x_t.shape[0])
            s.x_s[:, 0] = rng.integers(0, 4, s.x_s.shape[0])
        samples.append(s)
    return samples


def synthetic_zinc_batch(
    batch_size: int = 8,
    *,
    seed: int = 0,
    keig: int = 16,
    embed_ids: bool = False,
    with_ell: bool = False,
) -> ComplexBatch:
    """A flat batch of ZINC-like graphs (NumPy arrays), the JAX package's
    ``synthetic_zinc_batch`` without pooling: the same generator calls, so
    a seed gives both packages the same batch.  ``with_ell=True`` attaches
    the ELL forms of L0 and L1 (the row-gather SpMM route)."""
    samples = zinc_like_samples(
        np.random.default_rng(seed), batch_size, keig=keig, embed_ids=embed_ids)
    return collate(samples, with_ell=with_ell)


def superpixel_like_samples(
    rng: np.random.Generator,
    count: int,
    *,
    n_range: tuple[int, int] = (300, 481),
    num_classes: int = 21,
    node_feat: int = 14,
    edge_feat: int = 2,
    max_edges: int = 1000,
) -> list[GraphSample]:
    """Superpixel-shaped graphs with per-node labels (the shape of a
    PascalVOC-SP sample: 14 node and 2 edge features, a class id per
    node): ``n`` in ``n_range`` nodes on a random tree plus about
    ``n`` extra edges, at most ``max_edges`` edges (the dense Laplacian
    build's limit), no eigen-PE."""
    samples = []
    for _ in range(count):
        n = int(rng.integers(*n_range))
        s = random_simplex_sample(
            rng, n_nodes=n, extra_edges=max(min(n, max_edges - n), 0),
            node_feat=node_feat, edge_feat=edge_feat, keig=0,
        )
        s.y = rng.integers(0, num_classes, n).astype(np.float32)
        samples.append(s)
    return samples


def contact_like_samples(
    rng: np.random.Generator,
    count: int,
    *,
    n_range: tuple[int, int] = (20, 41),
    node_feat: int = 9,
    edge_feat: int = 3,
) -> list[GraphSample]:
    """Small-molecule-shaped graphs for link prediction (the shape of a
    PCQM-Contact sample: 9 node and 3 edge features); the query pairs are
    attached to the batch by ``complex.build.attach_link_pairs``."""
    return [
        random_simplex_sample(
            rng, n_nodes=int(rng.integers(*n_range)), extra_edges=int(rng.integers(2, 6)),
            node_feat=node_feat, edge_feat=edge_feat, keig=0,
        )
        for _ in range(count)
    ]


def synthetic_tsp_batch(batch_size: int = 4, *, seed: int = 0) -> ComplexBatch:
    """A flat batch of TSP-like graphs (``hl_hgat_tpu/data/synthetic.py::
    synthetic_tsp_batch``, the same draws): 50–100 points in the unit
    square, a random tour ring plus 3n random chords, x_t the coordinates,
    x_s [distance, aug-mask column of ones], y 1 on the tour's edges."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(batch_size):
        n = int(rng.integers(50, 101))
        pos = rng.random((n, 2)).astype(np.float32)
        order = rng.permutation(n)
        tour = {(min(int(order[i]), int(order[(i + 1) % n])),
                 max(int(order[i]), int(order[(i + 1) % n]))) for i in range(n)}
        pairs = set(tour)
        for _ in range(3 * n):
            a, b = rng.integers(0, n, 2)
            if a != b:
                pairs.add((int(min(a, b)), int(max(a, b))))
        arr = np.array(sorted(pairs), np.int64)
        src, dst = arr[:, 0], arr[:, 1]
        dist = np.linalg.norm(pos[src] - pos[dst], axis=1, keepdims=True)
        y = np.array([1.0 if (int(a), int(b)) in tour else 0.0 for a, b in zip(src, dst)],
                     np.float32)
        samples.append(build_complex(
            np.stack([src, dst]), n, x_t=pos,
            x_s=np.concatenate([dist, np.ones_like(dist)], axis=1).astype(np.float32), y=y))
    return collate(samples, y_per_edge=True)


def knn_graph(rng: np.random.Generator, n: int, k: int = 10):
    """Canonical undirected k-NN edge list of n uniform points in the unit
    square, and the points (``benchmarks/tsp_bench.py::knn_graph``)."""
    pos = rng.random((n, 2)).astype(np.float32)
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbr = np.argpartition(d2, k, axis=1)[:, :k]
    lo = np.minimum(np.repeat(np.arange(n), k), nbr.reshape(-1))
    hi = np.maximum(np.repeat(np.arange(n), k), nbr.reshape(-1))
    uniq = np.unique(lo.astype(np.int64) * n + hi)
    return np.stack([uniq // n, uniq % n]).astype(np.int64), pos


def tsp_like_samples(
    num: int, *, seed: int = 0, min_nodes: int = 50, max_nodes: int = 500
) -> list[GraphSample]:
    """TSP-shaped k-NN graphs (k = 10) as ``benchmarks/tsp_bench.py``
    draws them, in the same order, so one seed gives both the same graphs:
    n uniform in [min_nodes, max_nodes], x_t = the coordinates, x_s =
    [a standard-normal weight, aug-mask column of ones], y = 1 on about 15 %
    of the edges; each sample BFS-reordered (``reorder_sample``) with its
    per-edge labels."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(num):
        n = int(rng.integers(min_nodes, max_nodes + 1))
        ei, pos = knn_graph(rng, n)
        e = ei.shape[1]
        x_s = np.concatenate([rng.standard_normal((e, 1), np.float32),
                              np.ones((e, 1), np.float32)], axis=1)
        y = (rng.random(e) > 0.85).astype(np.float32)
        s = build_complex(ei, n, x_t=pos, x_s=x_s, y=y)
        samples.append(reorder_sample(s, y_per_edge=True))
    return samples


def synthetic_brain_samples(
    batch_size: int = 4, *, seed: int = 0, n_rois: int = 32, t_len: int = 64,
    density: float = 0.2, num_pool: int = 2,
) -> list[GraphSample]:
    """Brain-like subjects on one shared skeleton: random time courses on
    the nodes, random FC values on the edges, one MLGC pyramid shared by
    all (the samples of ``hl_hgat_tpu/data/synthetic.py::
    synthetic_brain_batch``, the same draws).  Collate them flat or with
    ``complex.dense.collate_dense_shared``."""
    rng = np.random.default_rng(seed)
    src, dst = _random_connected(rng, n_rois, int(density * n_rois * (n_rois - 1) / 2))
    levels = pools = None
    samples = []
    for _ in range(batch_size):
        ts = rng.standard_normal((n_rois, t_len)).astype(np.float32)
        fc = rng.standard_normal((src.shape[0], 1)).astype(np.float32)
        s = build_complex(np.stack([src, dst]), n_rois, x_t=ts, x_s=fc,
                          y=rng.standard_normal(1).astype(np.float32))
        if levels is None:
            levels, pools = build_pyramid(s.levels, num_pool)
        s.levels, s.pools = levels, pools
        samples.append(s)
    return samples


def synthetic_brain_batch(
    batch_size: int = 4, *, seed: int = 0, n_rois: int = 32, t_len: int = 64,
    density: float = 0.2, num_pool: int = 2,
) -> tuple[ComplexBatch, int, int]:
    """``synthetic_brain_samples`` collated flat with no row padding:
    (batch, nodes and edges of the final level a graph)."""
    samples = synthetic_brain_samples(batch_size, seed=seed, n_rois=n_rois, t_len=t_len,
                                      density=density, num_pool=num_pool)
    final = samples[0].levels[-1]
    return collate(samples, multiple=1), final.num_nodes, final.num_edges


def synthetic_fmri_series(
    rng: np.random.Generator, n_subjects: int, n_rois: int, t_len: int, *,
    k_latent: int = 4, y_mean: float = 95.1377, y_std: float = 7.3,
) -> tuple[np.ndarray, np.ndarray]:
    """Learnable synthetic fMRI: a latent network signal plus noise, the
    score correlated with the strength of one latent component (the
    stand-in for the reference's subject series, whose file is not
    shipped; HL-HGAT-DEMO/OHBM_DEMO.ipynb cell 16 describes the real
    format).  The same draws as the JAX package's generator.

    Returns (timeseries [N, R, T], scores [N])."""
    mixing = rng.standard_normal((n_rois, k_latent))
    ts_all = np.empty((n_subjects, n_rois, t_len))
    scores = np.empty(n_subjects)
    for s in range(n_subjects):
        strength = rng.uniform(0.5, 2.0)
        lat = rng.standard_normal((k_latent, t_len))
        lat[0] *= strength
        ts_all[s] = mixing @ lat + 0.5 * rng.standard_normal((n_rois, t_len))
        scores[s] = y_mean + y_std * (strength - 1.25)
    return ts_all, scores
