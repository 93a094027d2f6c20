"""Host-side (NumPy) construction of one-level simplicial complexes.

A copy of the dense branch of ``hl_hgat_tpu/complex/build.py`` (the JAX
package's module imports ``complex/batch.py``, which imports jax, so the
port keeps its own): undirected canonicalization, boundary operator, Hodge
Laplacians and eigen positional encodings (reference
lib/Hodge_Dataset.py:442-477), producing `GraphSample`s that
``complex/dense.py`` packs into dense blocks.

Graphs above ``SPARSE_BUILD_THRESHOLD`` edges need the sparse-direct
Laplacian build, which this package does not have yet: they raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GraphStructure:
    """One resolution level of a single (unbatched) complex, NumPy arrays."""

    src: np.ndarray  # [e] int32, canonical src < dst
    dst: np.ndarray  # [e] int32
    l0_rows: np.ndarray
    l0_cols: np.ndarray
    l0_vals: np.ndarray
    l1_rows: np.ndarray
    l1_cols: np.ndarray
    l1_vals: np.ndarray
    num_nodes: int
    num_edges: int
    max_eig: float


@dataclasses.dataclass
class GraphSample:
    """A single preprocessed simplex graph (``pools`` stays empty here)."""

    x_t: np.ndarray  # [n, Ft]
    x_s: np.ndarray  # [e, Fs]
    y: np.ndarray | None
    levels: list[GraphStructure]
    pools: list[tuple[np.ndarray, np.ndarray]]
    extra: dict | None = None

    @property
    def num_nodes(self) -> int:
        return self.levels[0].num_nodes

    @property
    def num_edges(self) -> int:
        return self.levels[0].num_edges


def canonical_undirected(
    edge_index: np.ndarray,
    edge_attr: np.ndarray | None = None,
    *,
    reduce: str = "min",
) -> tuple[np.ndarray, np.ndarray | None]:
    """Dedup a directed edge list into canonical undirected (src < dst) form.

    ``to_undirected(..., reduce='min')`` followed by the
    ``edge_index[0] < edge_index[1]`` filter (reference
    lib/Hodge_Dataset.py:447-450).  Self-loops are dropped.
    """
    src, dst = edge_index[0], edge_index[1]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    attr = edge_attr[keep] if edge_attr is not None else None
    lo = np.minimum(src, dst).astype(np.int64)
    hi = np.maximum(src, dst).astype(np.int64)
    key = lo * (hi.max() + 1 if hi.size else 1) + hi
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    uniq_mask = np.ones(key_sorted.shape, dtype=bool)
    uniq_mask[1:] = key_sorted[1:] != key_sorted[:-1]
    first_idx = order[uniq_mask]
    out_ei = np.stack([lo[first_idx], hi[first_idx]]).astype(np.int32)
    if attr is None:
        return out_ei, None
    grp = np.cumsum(uniq_mask) - 1
    if reduce == "min":
        out_attr = np.full(
            (first_idx.size,) + attr.shape[1:], np.inf, dtype=np.float64
        )
        np.minimum.at(out_attr, grp, attr[order])
        out_attr = out_attr.astype(attr.dtype)
    elif reduce == "mean":
        out_attr = np.zeros((first_idx.size,) + attr.shape[1:], dtype=np.float64)
        np.add.at(out_attr, grp, attr[order].astype(np.float64))
        counts = np.bincount(grp, minlength=first_idx.size).astype(np.float64)
        out_attr = (out_attr / counts.reshape((-1,) + (1,) * (attr.ndim - 1))).astype(
            attr.dtype if np.issubdtype(attr.dtype, np.floating) else np.float64
        )
    else:
        raise ValueError(f"unknown reduce {reduce!r}")
    return out_ei, out_attr


def boundary_dense(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> np.ndarray:
    """Dense B1 [num_nodes, num_edges]: −1 at src, +1 at dst per column."""
    e = src.shape[0]
    b1 = np.zeros((num_nodes, e), dtype=np.float64)
    b1[src, np.arange(e)] = -1.0
    b1[dst, np.arange(e)] = 1.0
    return b1


def hodge_laplacians(
    src: np.ndarray, dst: np.ndarray, num_nodes: int
) -> tuple[np.ndarray, np.ndarray, float]:
    """L0 = 2 B1 B1ᵀ / λmax, L1 = 2 B1ᵀ B1 / λmax (dense, float64).

    λmax is the largest eigenvalue of the unscaled L0, so both spectra lie
    in [0, 2] (reference lib/Hodge_Dataset.py:451-456).
    """
    b1 = boundary_dense(src, dst, num_nodes)
    l0 = b1 @ b1.T
    max_eig = float(np.linalg.eigvalsh(l0).max()) if num_nodes > 0 else 1.0
    if max_eig <= 0:
        max_eig = 1.0
    l0 = 2.0 * l0 / max_eig
    l1 = 2.0 * (b1.T @ b1) / max_eig
    return l0, l1, max_eig


def dense_to_coo(m: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact-nonzero COO extraction (PyG ``dense_to_sparse`` semantics)."""
    rows, cols = np.nonzero(m)
    return rows.astype(np.int32), cols.astype(np.int32), m[rows, cols].astype(
        np.float32
    )


def eig_pe(lap: np.ndarray, k: int = 9) -> np.ndarray:
    """Laplacian eigenvector positional encoding: eigenvectors 1..k−1 by
    ascending eigenvalue, zero-padded to k−1 columns (reference
    lib/Hodge_Dataset.py:97-112, 430-437)."""
    if lap.shape[0] == 0:
        return np.zeros((0, max(k - 1, 0)), dtype=np.float32)
    eig_vals, eig_vecs = np.linalg.eigh(lap)
    eig_vecs = np.real(eig_vecs[:, np.argsort(eig_vals, kind="stable")])
    pe = eig_vecs[:, 1:k]
    if pe.shape[1] < k - 1:
        pe = np.concatenate(
            [pe, np.zeros((pe.shape[0], k - 1 - pe.shape[1]))], axis=1
        )
    return pe.astype(np.float32)


# Above this edge count the JAX package switches to a sparse-direct
# Laplacian build that this package has not ported.
SPARSE_BUILD_THRESHOLD = 1024


def build_structure(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> GraphStructure:
    """Boundary + Laplacians for one complex level (dense build only)."""
    if src.shape[0] > SPARSE_BUILD_THRESHOLD:
        raise ValueError(
            f"{src.shape[0]} edges exceed the dense build's limit of "
            f"{SPARSE_BUILD_THRESHOLD}; the sparse-direct build is not ported"
        )
    l0, l1, max_eig = hodge_laplacians(src, dst, num_nodes)
    l0r, l0c, l0v = dense_to_coo(l0)
    l1r, l1c, l1v = dense_to_coo(l1)
    return GraphStructure(
        src=src.astype(np.int32),
        dst=dst.astype(np.int32),
        l0_rows=l0r,
        l0_cols=l0c,
        l0_vals=l0v,
        l1_rows=l1r,
        l1_cols=l1c,
        l1_vals=l1v,
        num_nodes=int(num_nodes),
        num_edges=int(src.shape[0]),
        max_eig=max_eig,
    )


def build_complex(
    edge_index: np.ndarray,
    num_nodes: int,
    *,
    x_t: np.ndarray | None = None,
    x_s: np.ndarray | None = None,
    edge_attr: np.ndarray | None = None,
    y: np.ndarray | None = None,
    keig: int = 0,
    reduce: str = "min",
) -> GraphSample:
    """Lift a plain graph to a 1-level simplex sample.

    With ``keig > 0`` the L0 eigen-PE is appended to the node features and
    the L1 eigen-PE to the edge features (reference
    lib/Hodge_Dataset.py:457-462).
    """
    ei, ea = canonical_undirected(edge_index, edge_attr, reduce=reduce)
    src, dst = ei[0], ei[1]
    structure = build_structure(src, dst, num_nodes)
    l0, l1, _ = hodge_laplacians(src, dst, num_nodes)
    xt = (
        x_t.astype(np.float32)
        if x_t is not None
        else np.zeros((num_nodes, 0), dtype=np.float32)
    )
    if x_s is not None:
        xs = x_s.astype(np.float32)
    elif ea is not None:
        xs = np.asarray(ea, dtype=np.float32).reshape(src.shape[0], -1)
    else:
        xs = np.zeros((src.shape[0], 0), dtype=np.float32)
    if keig > 0:
        xt = np.concatenate([xt, eig_pe(l0, k=keig)], axis=1)
        xs = np.concatenate([xs, eig_pe(l1, k=keig)], axis=1)
    yy = np.zeros((1,), dtype=np.float32) if y is None else np.asarray(y)
    return GraphSample(x_t=xt, x_s=xs, y=yy, levels=[structure], pools=[])
