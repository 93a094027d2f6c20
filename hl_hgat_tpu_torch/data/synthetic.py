"""Synthetic simplex graphs shaped like the real benchmarks.

Copies of ``hl_hgat_tpu/data/synthetic.py``'s generators: the same
``np.random.Generator`` call sequence, so a seed gives both packages the
same samples.
"""

from __future__ import annotations

import numpy as np

from hl_hgat_tpu_torch.complex.batch import ComplexBatch
from hl_hgat_tpu_torch.complex.build import GraphSample, build_complex, collate


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
    y_dim: int = 1,
) -> GraphSample:
    src, dst = _random_connected(rng, n_nodes, extra_edges)
    e = src.shape[0]
    return build_complex(
        np.stack([src, dst]),
        n_nodes,
        x_t=rng.standard_normal((n_nodes, node_feat)).astype(np.float32),
        x_s=rng.standard_normal((e, edge_feat)).astype(np.float32),
        y=rng.standard_normal(y_dim).astype(np.float32),
        keig=keig,
    )


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
