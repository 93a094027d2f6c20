"""Host-side (NumPy) construction of one-level simplicial complexes.

A copy of the dense branch of ``hl_hgat_tpu/complex/build.py`` (the JAX
package's module imports ``complex/batch.py``, which imports jax, so the
port keeps its own): undirected canonicalization, boundary operator, Hodge
Laplacians and eigen positional encodings (reference
lib/Hodge_Dataset.py:442-477), producing `GraphSample`s that
``complex/dense.py`` packs into dense blocks and that ``collate`` here
concatenates into the flat (COO/ELL) layout of ``complex/batch.py``, every
coarsened level of a pooled sample (``complex/coarsen.py``) with its pooling
map.

Graphs above ``SPARSE_BUILD_THRESHOLD`` edges take the sparse-direct
Laplacian build (``hodge_laplacians_coo``), which never forms an [E, E]
matrix.  Its L1 and the ELL packing of ``collate(with_ell=True)`` run in the
host library (``native.py``), as in the JAX module; their NumPy versions
(``hodge_l1_numpy``, ``coo_to_ell_numpy``) stay for the tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hl_hgat_tpu_torch import native
from hl_hgat_tpu_torch.complex.batch import ComplexBatch, ComplexLevel, CooMatrix, PoolMap


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
    """A single preprocessed simplex graph: ``levels[0]`` the graph, the
    coarsened levels after it, ``pools[i]`` the (c_node, c_edge) assignment
    from level i to level i + 1."""

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


def par2adj(par1: np.ndarray) -> np.ndarray:
    """The canonical edge list [2, E] of a dense boundary operator, the
    inverse of ``boundary_dense`` (reference ``par2adj``,
    lib/Hodge_Dataset.py:194-209): each column has −1 at src, +1 at dst."""
    srcs, dsts = [], []
    for e in range(par1.shape[1]):
        nz = np.nonzero(par1[:, e])[0]
        srcs.append(int(nz[par1[nz, e] < 0][0]))
        dsts.append(int(nz[par1[nz, e] > 0][0]))
    return np.stack([np.asarray(srcs, np.int32), np.asarray(dsts, np.int32)])


def post2poss(pos_t: np.ndarray, edge_index: np.ndarray, edge_index1: np.ndarray) -> np.ndarray:
    """Edge cluster assignment from node clusters (reference
    lib/Hodge_Dataset.py:212-238): an edge inside one cluster maps to −1
    (the reference's ``inf``), any other to the index of the coarse edge
    (min, max) in ``edge_index1``; KeyError when that edge is missing."""
    coarse = {(int(a), int(b)): i for i, (a, b) in enumerate(zip(edge_index1[0], edge_index1[1]))}
    pos_t = np.asarray(pos_t).reshape(-1)
    out = np.empty(edge_index.shape[1], np.int64)
    for i in range(edge_index.shape[1]):
        a, b = int(pos_t[edge_index[0, i]]), int(pos_t[edge_index[1, i]])
        out[i] = -1 if a == b else coarse[(min(a, b), max(a, b))]
    return out


def unbatch_edge_attr(edge_attr: np.ndarray, s_id: np.ndarray, edge_mask: np.ndarray,
                      num_graphs: int) -> list[np.ndarray]:
    """Batched per-edge rows split back per graph, padding dropped
    (reference ``unbatch_edge_attr``, lib/Hodge_Cheb_Conv.py:244-251)."""
    s_id = np.asarray(s_id)
    valid = np.asarray(edge_mask) > 0
    return [np.asarray(edge_attr)[(s_id == g) & valid] for g in range(num_graphs)]


def boundary_dense(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> np.ndarray:
    """Dense B1 [num_nodes, num_edges]: −1 at src, +1 at dst per column."""
    e = src.shape[0]
    b1 = np.zeros((num_nodes, e), dtype=np.float64)
    b1[src, np.arange(e)] = -1.0
    b1[dst, np.arange(e)] = 1.0
    return b1


def hodge_laplacians(
    src: np.ndarray, dst: np.ndarray, num_nodes: int, *, with_l1: bool = True
) -> tuple[np.ndarray, np.ndarray | None, float]:
    """L0 = 2 B1 B1ᵀ / λmax, L1 = 2 B1ᵀ B1 / λmax (dense, float64).

    λmax is the largest eigenvalue of the unscaled L0, so both spectra lie
    in [0, 2] (reference lib/Hodge_Dataset.py:451-456).  ``with_l1=False``
    skips the [E, E] product (None in its place) where only L0 is read.
    """
    b1 = boundary_dense(src, dst, num_nodes)
    l0 = b1 @ b1.T
    max_eig = float(np.linalg.eigvalsh(l0).max()) if num_nodes > 0 else 1.0
    if max_eig <= 0:
        max_eig = 1.0
    l0 = 2.0 * l0 / max_eig
    l1 = 2.0 * (b1.T @ b1) / max_eig if with_l1 else None
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


def hodge_laplacians_coo(
    src: np.ndarray, dst: np.ndarray, num_nodes: int
) -> tuple[tuple, tuple, float]:
    """Sparse-direct L0/L1 construction that never densifies, as
    ``hl_hgat_tpu/complex/build.py::hodge_laplacians_coo``: L0 and λmax
    (sparse Lanczos) in NumPy, L1 by the native build (``native.hodge_l1``).

    nnz(L1) is about Σ deg² (edge pairs sharing a vertex) instead of E².
    Same math as `hodge_laplacians`:

      L0[i, i] = deg(i);  L0[i, j] = −1 per edge {i, j}
      L1[e, e] = 2;       L1[e, f] = B1[v, e]·B1[v, f] for the shared v,
                          with B1[v, e] = −1 if v == src(e) else +1.

    Returns ((rows, cols, vals) of L0 and of L1, each sorted by row then
    column, exact zeros dropped, values rescaled by 2/λmax; λmax).
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    e = src.shape[0]
    deg = np.bincount(src, minlength=num_nodes) + np.bincount(dst, minlength=num_nodes)
    l0_rows = np.concatenate([np.arange(num_nodes), src, dst])
    l0_cols = np.concatenate([np.arange(num_nodes), dst, src])
    l0_vals = np.concatenate([deg.astype(np.float64), -np.ones(2 * e)])
    l0_mat = sp.coo_matrix((l0_vals, (l0_rows, l0_cols)), shape=(num_nodes, num_nodes)).tocsr()
    if num_nodes <= 2:
        max_eig = float(np.linalg.eigvalsh(l0_mat.toarray()).max())
    else:
        max_eig = float(spla.eigsh(l0_mat, k=1, which="LA", return_eigenvectors=False,
                                   tol=1e-9)[0])
    if max_eig <= 0:
        max_eig = 1.0
    scale = 2.0 / max_eig
    l0_mat.eliminate_zeros()
    l0_coo = l0_mat.tocoo()
    return (
        (l0_coo.row.astype(np.int32), l0_coo.col.astype(np.int32),
         (l0_coo.data * scale).astype(np.float32)),
        native.hodge_l1(src, dst, num_nodes, scale),
        max_eig,
    )


def hodge_l1_numpy(src: np.ndarray, dst: np.ndarray, num_nodes: int, scale: float):
    """The NumPy version of ``native.hodge_l1`` (the JAX module's fallback
    branch): every ordered pair of edges within each node's incidence
    group, coalesced, sorted by (row, col), × ``scale`` in float64."""
    e = src.shape[0]
    inc_node = np.concatenate([src, dst])
    inc_edge = np.concatenate([np.arange(e), np.arange(e)])
    inc_sign = np.concatenate([-np.ones(e), np.ones(e)])
    order = np.argsort(inc_node, kind="stable")
    inc_node, inc_edge, inc_sign = inc_node[order], inc_edge[order], inc_sign[order]
    starts = np.searchsorted(inc_node, np.arange(num_nodes + 1))
    counts = (starts[1:] - starts[:-1]).astype(np.int64)
    sq = counts * counts
    grp = np.repeat(np.arange(num_nodes), sq)
    pos = np.arange(int(sq.sum())) - (np.cumsum(sq) - sq)[grp]
    c_g = np.maximum(counts[grp], 1)
    g_start = starts[:-1][grp]
    idx_row = g_start + pos // c_g
    idx_col = g_start + pos % c_g
    # coalesce: each edge's diagonal appears once per endpoint
    key = inc_edge[idx_row].astype(np.int64) * e + inc_edge[idx_col]
    uniq, inv = np.unique(key, return_inverse=True)
    summed = np.bincount(inv, weights=inc_sign[idx_row] * inc_sign[idx_col],
                         minlength=uniq.size)
    keep = summed != 0
    uniq, summed = uniq[keep], summed[keep]
    return ((uniq // e).astype(np.int32), (uniq % e).astype(np.int32),
            (summed * scale).astype(np.float32))


# Above this edge count the O(E²) dense L1 is replaced by the sparse-direct
# construction (the same values up to float rounding and COO order).
SPARSE_BUILD_THRESHOLD = 1024


def build_structure(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> GraphStructure:
    """Boundary + Laplacians for one complex level: dense for small graphs,
    sparse-direct beyond ``SPARSE_BUILD_THRESHOLD`` edges."""
    if src.shape[0] > SPARSE_BUILD_THRESHOLD:
        (l0r, l0c, l0v), (l1r, l1c, l1v), max_eig = hodge_laplacians_coo(src, dst, num_nodes)
    else:
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
        l0, l1, _ = hodge_laplacians(src, dst, num_nodes)
        xt = np.concatenate([xt, eig_pe(l0, k=keig)], axis=1)
        xs = np.concatenate([xs, eig_pe(l1, k=keig)], axis=1)
    yy = np.zeros((1,), dtype=np.float32) if y is None else np.asarray(y)
    return GraphSample(x_t=xt, x_s=xs, y=yy, levels=[structure], pools=[])


# ---------------------------------------------------------------------------
# flat batching / collation
# ---------------------------------------------------------------------------


def _pad_to(x: np.ndarray, n: int, fill=0) -> np.ndarray:
    pad = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, constant_values=fill)


@dataclasses.dataclass(frozen=True)
class LevelPad:
    nodes: int
    edges: int
    nnz0: int
    nnz1: int


def pad_spec(
    samples: list[GraphSample], *, multiple: int = 8, slack: float = 1.0
) -> list[LevelPad]:
    """Padded sizes per level for a batch (rounded up to ``multiple``)."""

    def rnd(x: int) -> int:
        x = int(np.ceil(x * slack))
        return max(((x + multiple - 1) // multiple) * multiple, multiple)

    return [
        LevelPad(
            nodes=rnd(sum(s.levels[lv].num_nodes for s in samples)),
            edges=rnd(sum(s.levels[lv].num_edges for s in samples)),
            nnz0=rnd(sum(s.levels[lv].l0_rows.size for s in samples)),
            nnz1=rnd(sum(s.levels[lv].l1_rows.size for s in samples)),
        )
        for lv in range(len(samples[0].levels))
    ]


def _collate_level(
    structs: list[GraphStructure], pad: LevelPad, num_graphs: int,
    with_ell: bool = False,
) -> tuple[ComplexLevel, np.ndarray, np.ndarray]:
    """Block-diagonal concatenation of one level across the batch; returns
    the level and the per-graph node and edge offsets."""
    n_off = np.cumsum([0] + [s.num_nodes for s in structs])
    e_off = np.cumsum([0] + [s.num_edges for s in structs])
    n_tot, e_tot = int(n_off[-1]), int(e_off[-1])
    if n_tot > pad.nodes or e_tot > pad.edges:
        raise ValueError(
            f"batch exceeds pad spec: nodes {n_tot}>{pad.nodes} or edges "
            f"{e_tot}>{pad.edges}"
        )

    def cat(parts, offs):
        return np.concatenate(
            [p + o for p, o in zip(parts, offs)] or [np.zeros(0, np.int32)]
        ).astype(np.int32)

    # Padded edges point at the last padded node slot: harmless under masks.
    src = _pad_to(cat([s.src for s in structs], n_off), pad.edges, fill=pad.nodes - 1)
    dst = _pad_to(cat([s.dst for s in structs], n_off), pad.edges, fill=pad.nodes - 1)

    def cat_coo(which, offs, nnz_pad, size):
        rows = cat([getattr(s, f"{which}_rows") for s in structs], offs)
        cols = cat([getattr(s, f"{which}_cols") for s in structs], offs)
        vals = np.concatenate(
            [getattr(s, f"{which}_vals") for s in structs] or [np.zeros(0, np.float32)]
        ).astype(np.float32)
        if rows.size > nnz_pad:
            raise ValueError(f"nnz {rows.size} exceeds pad {nnz_pad}")
        rows, cols, vals = (_pad_to(a, nnz_pad) for a in (rows, cols, vals))
        ell = coo_to_ell(rows, cols, vals, size) if with_ell else (None, None)
        return CooMatrix(
            rows=rows, cols=cols, vals=vals, shape=(size, size),
            ell_cols=ell[0], ell_vals=ell[1], symmetric=True,
        )

    node_mask = np.zeros(pad.nodes, np.float32)
    node_mask[:n_tot] = 1.0
    edge_mask = np.zeros(pad.edges, np.float32)
    edge_mask[:e_tot] = 1.0
    counts_n = np.diff(n_off)
    counts_e = np.diff(e_off)
    n_id = np.full(pad.nodes, num_graphs, np.int32)
    n_id[:n_tot] = np.repeat(np.arange(len(structs), dtype=np.int32), counts_n)
    s_id = np.full(pad.edges, num_graphs, np.int32)
    s_id[:e_tot] = np.repeat(np.arange(len(structs), dtype=np.int32), counts_e)

    deg = np.zeros(pad.nodes, np.float32)
    np.add.at(deg, src[:e_tot], 1.0)
    np.add.at(deg, dst[:e_tot], 1.0)

    level = ComplexLevel(
        src=src, dst=dst, node_mask=node_mask, edge_mask=edge_mask,
        n_id=n_id, s_id=s_id,
        l0=cat_coo("l0", n_off, pad.nnz0, pad.nodes),
        l1=cat_coo("l1", e_off, pad.nnz1, pad.edges),
        deg=deg, num_graphs=num_graphs,
    )
    return level, n_off, e_off


def collate(
    samples: list[GraphSample],
    pads: list[LevelPad] | None = None,
    *,
    multiple: int = 8,
    y_per_edge: bool = False,
    y_per_node: bool = False,
    with_ell: bool = False,
) -> ComplexBatch:
    """Pack samples into one padded `ComplexBatch` of NumPy arrays: edge
    endpoints offset by node counts, L1 indices by edge counts, every level
    block-diagonal, and per coarsening step a `PoolMap` of the pooling
    assignments globalized by the coarse offsets (dropped nodes, deleted
    edges and padding point at the coarse level's dump slot, one past its
    last padded row), as ``hl_hgat_tpu/complex/build.py::collate``.
    """
    if pads is None:
        pads = pad_spec(samples, multiple=multiple)
    num_graphs = len(samples)
    levels, offs = [], []
    for lv in range(len(samples[0].levels)):
        level, n_off, e_off = _collate_level(
            [s.levels[lv] for s in samples], pads[lv], num_graphs, with_ell=with_ell)
        levels.append(level)
        offs.append((n_off, e_off))

    pools = []
    for lv in range(len(levels) - 1):
        fine, coarse = pads[lv], pads[lv + 1]
        (fn_off, fe_off), (cn_off, ce_off) = offs[lv], offs[lv + 1]
        pos_t = np.full(fine.nodes, coarse.nodes, np.int32)
        pos_s = np.full(fine.edges, coarse.edges, np.int32)
        for g, s in enumerate(samples):
            c_node, c_edge = (np.asarray(a).reshape(-1).astype(np.int64) for a in s.pools[lv])
            pos_t[fn_off[g] : fn_off[g + 1]] = np.where(c_node < 0, coarse.nodes,
                                                        c_node + cn_off[g])
            pos_s[fe_off[g] : fe_off[g + 1]] = np.where(c_edge < 0, coarse.edges,
                                                        c_edge + ce_off[g])
        pools.append(PoolMap(pos_t=pos_t, pos_s=pos_s))

    n_off, e_off = offs[0]

    def rows_of(arrays, offs, total):
        out = np.zeros((total,) + arrays[0].shape[1:], np.float32)
        for g, a in enumerate(arrays):
            out[offs[g] : offs[g + 1]] = a
        return out

    x_t = rows_of([s.x_t for s in samples], n_off, pads[0].nodes)
    x_s = rows_of([s.x_s for s in samples], e_off, pads[0].edges)
    if y_per_edge:
        y = rows_of([s.y for s in samples], e_off, pads[0].edges)
    elif y_per_node:
        y = rows_of([s.y for s in samples], n_off, pads[0].nodes)
    else:
        y = np.stack([np.asarray(s.y, np.float32).reshape(-1) for s in samples])
    return ComplexBatch(
        x_t=x_t, x_s=x_s, y=y, levels=tuple(levels), pools=tuple(pools),
        num_graphs=num_graphs)


def attach_link_pairs(
    batch: ComplexBatch,
    samples: list[GraphSample],
    rng: np.random.Generator,
    *,
    n_queries: int = 4,
    n_neg: int = 8,
) -> ComplexBatch:
    """Attach PCQM-Contact-style link-prediction queries to a flat batch.

    Per graph, ``n_queries`` positive pairs (existing edges, sampled with
    replacement, or the positive ``edge_label_index`` pairs of
    ``sample.extra`` when present) each followed by ``n_neg`` non-adjacent
    negatives: contiguous groups of (1 + n_neg) rows, positive first, so
    MRR is a [Q, 1 + n_neg] reshape.  ``batch.y`` is replaced by the [P]
    pair labels, P = G·n_queries·(1 + n_neg).  ``samples`` must be the
    graphs behind ``batch`` in order.  The ``rng`` call sequence is the JAX
    package's, so one seed gives both the same pairs.
    """
    offs = np.cumsum([0] + [s.num_nodes for s in samples])[:-1]
    pairs, labels = [], []
    for off, s in zip(offs, samples):
        st = s.levels[0]
        es = set(zip(st.src.tolist(), st.dst.tolist()))
        extra = getattr(s, "extra", None) or {}
        if "edge_label_index" in extra:
            eli = np.asarray(extra["edge_label_index"])
            el = np.asarray(extra["edge_label"]).reshape(-1)
            pos_pool = eli[:, el > 0] if (el > 0).any() else eli
            sel = rng.choice(pos_pool.shape[1], n_queries, replace=True)
            pos_pairs = [(int(pos_pool[0, i]), int(pos_pool[1, i])) for i in sel]
        else:
            pos_idx = rng.choice(st.num_edges, n_queries, replace=True)
            pos_pairs = [(int(st.src[pi]), int(st.dst[pi])) for pi in pos_idx]
        for pa, pb in pos_pairs:
            pairs.append((off + pa, off + pb))
            labels.append(1.0)
            negs = 0
            while negs < n_neg:
                a, b = rng.integers(0, st.num_nodes, 2)
                lo, hi = int(min(a, b)), int(max(a, b))
                if lo == hi or (lo, hi) in es:
                    continue
                pairs.append((off + lo, off + hi))
                labels.append(0.0)
                negs += 1
    return batch.replace(
        pairs=np.asarray(pairs, np.int32),
        y=np.asarray(labels, np.float32),
        pair_mask=np.ones(len(labels), np.float32),
    )


def coo_to_ell(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    num_rows: int,
    *,
    width: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pack COO into ELL [num_rows, width] (cols, vals), zero-padded rows,
    by the native packer (``native.coo_to_ell``), as the JAX package's
    collate does.

    Entries with ``vals == 0`` are dropped; the others fill their row's
    slots in the order they appear in the COO arrays.  Padding slots carry
    column 0 and value 0.  ``width`` defaults to the longest row; a row
    that does not fit raises ValueError.
    """
    return native.coo_to_ell(rows, cols, vals, num_rows, width)


def coo_to_ell_numpy(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    num_rows: int,
    *,
    width: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """The NumPy version of `coo_to_ell`: the slot order of the JAX
    package's ``coo_to_ell`` loop, reproduced with a stable sort."""
    rows, cols, vals = np.asarray(rows), np.asarray(cols), np.asarray(vals)
    keep = vals != 0
    r, c, v = rows[keep].astype(np.int64), cols[keep], vals[keep]
    counts = np.bincount(r, minlength=num_rows)
    w = max(int(counts.max()) if width is None else width, 1)
    order = np.argsort(r, kind="stable")
    r_sorted = r[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(r_sorted.size) - starts[r_sorted]
    if slot.size and slot.max() >= w:
        raise ValueError(f"row {int(r_sorted[np.argmax(slot >= w)])} exceeds ELL width {w}")
    ell_cols = np.zeros((num_rows, w), np.int32)
    ell_vals = np.zeros((num_rows, w), np.float32)
    ell_cols[r_sorted, slot] = c[order]
    ell_vals[r_sorted, slot] = v[order]
    return ell_cols, ell_vals
