"""Synthetic simplex graphs shaped like the real benchmarks.

Copies of ``hl_hgat_tpu/data/synthetic.py``'s generators: the same
``np.random.Generator`` call sequence, so a seed gives both packages the
same samples.
"""

from __future__ import annotations

import numpy as np

from hl_hgat_tpu_torch.complex.build import GraphSample, build_complex


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
) -> GraphSample:
    src, dst = _random_connected(rng, n_nodes, extra_edges)
    e = src.shape[0]
    return build_complex(
        np.stack([src, dst]),
        n_nodes,
        x_t=rng.standard_normal((n_nodes, node_feat)).astype(np.float32),
        x_s=rng.standard_normal((e, edge_feat)).astype(np.float32),
        y=rng.standard_normal(1).astype(np.float32),
        keig=keig,
    )


def zinc_like_samples(rng: np.random.Generator, count: int) -> list[GraphSample]:
    """ZINC-shaped molecules as ``bench.py`` draws them: n in [15, 33)
    atoms, [2, 6) extra edges, ``keig=16`` (15 PE columns), integer atom
    ids (28 types) and bond ids (4 types) in feature column 0."""
    samples = []
    for _ in range(count):
        n = int(rng.integers(15, 33))
        s = random_simplex_sample(
            rng, n_nodes=n, extra_edges=int(rng.integers(2, 6)),
            node_feat=1, edge_feat=1, keig=16,
        )
        s.x_t[:, 0] = rng.integers(0, 28, s.x_t.shape[0])
        s.x_s[:, 0] = rng.integers(0, 4, s.x_s.shape[0])
        samples.append(s)
    return samples
