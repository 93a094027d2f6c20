"""ZINC-shaped molecules, drawn from a seed (NumPy only).

A frozen copy of ``hl_hgat_tpu_torch/data/synthetic.py::zinc_like_samples``
(itself the JAX package's ``bench.py`` draw): the same ``np.random.Generator``
call sequence, so a generator gives the molecules that function gives.  What
the copy returns is the raw molecule, as a dataset stores it: the canonical
edge list, the atom and bond ids in feature column 0, the eigen positional
encodings of L0 and L1 in the other columns (reference
lib/Hodge_Dataset.py:97-112, 442-477) and the target.  The Laplacians, the
packing and everything else are left to the two sides that read it.
"""

from __future__ import annotations

import numpy as np


def _random_connected(rng: np.random.Generator, n: int, extra: int):
    parents = rng.integers(0, np.maximum(np.arange(1, n), 1))
    pairs = {(int(min(p, i)), int(max(p, i))) for i, p in zip(range(1, n), parents)}
    for _ in range(extra):
        a, b = rng.integers(0, n, 2)
        if a != b:
            pairs.add((int(min(a, b)), int(max(a, b))))
    arr = np.array(sorted(pairs), np.int64)
    return arr[:, 0], arr[:, 1]


def _eig_pe(lap: np.ndarray, k: int) -> np.ndarray:
    """Eigenvectors 1..k−1 by ascending eigenvalue, zero-padded to k−1."""
    vals, vecs = np.linalg.eigh(lap)
    pe = np.real(vecs[:, np.argsort(vals, kind="stable")])[:, 1:k]
    if pe.shape[1] < k - 1:
        pe = np.concatenate([pe, np.zeros((pe.shape[0], k - 1 - pe.shape[1]))], axis=1)
    return pe.astype(np.float32)


def _laplacians(src, dst, n):
    """2·B1B1ᵀ/λmax and 2·B1ᵀB1/λmax in float64, λmax of B1B1ᵀ."""
    e = src.shape[0]
    b1 = np.zeros((n, e))
    b1[src, np.arange(e)] = -1.0
    b1[dst, np.arange(e)] = 1.0
    l0 = b1 @ b1.T
    lam = float(np.linalg.eigvalsh(l0).max())
    return 2.0 * l0 / lam, 2.0 * (b1.T @ b1) / lam


def molecules(rng: np.random.Generator, count: int, keig: int = 16) -> list[dict]:
    """``count`` molecules of 15–32 atoms and 2–5 extra bonds; each a dict of
    ``src``/``dst`` (canonical, src < dst, sorted), ``n``, ``x_t`` [n, keig]
    (atom id of 28, then keig − 1 PE columns), ``x_s`` [e, keig] (bond id of
    4, then PE) and ``y`` [1]."""
    out = []
    for _ in range(count):
        n = int(rng.integers(15, 33))
        src, dst = _random_connected(rng, n, int(rng.integers(2, 6)))
        e = src.shape[0]
        x_t = rng.standard_normal((n, 1)).astype(np.float32)
        x_s = rng.standard_normal((e, 1)).astype(np.float32)
        y = rng.standard_normal(1).astype(np.float32)
        l0, l1 = _laplacians(src, dst, n)
        x_t = np.concatenate([x_t, _eig_pe(l0, keig)], axis=1)
        x_s = np.concatenate([x_s, _eig_pe(l1, keig)], axis=1)
        x_t[:, 0] = rng.integers(0, 28, n)
        x_s[:, 0] = rng.integers(0, 4, e)
        out.append(dict(src=src, dst=dst, n=n, x_t=x_t, x_s=x_s, y=y))
    return out


def molecule_chunk(args: tuple) -> list[dict]:
    """``molecules`` of chunk ``index`` of a run: its own generator seeded
    with (seed, stream, index), so chunks can be drawn in parallel."""
    seed, stream, index, count, keig = args
    return molecules(np.random.default_rng([seed, stream, index]), count, keig)
