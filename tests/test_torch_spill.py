"""The large-graph dense layout against the JAX package on the CPU: the
sparse-direct Laplacian build, ``pack_plan`` with spans, the BFS locality
order, the spill-mode ``collate_dense_packed`` (every array), the band and
spill operators inside ``lap_matvec``, the three B1 products and
``pool_to_coarse`` (values and vector-Jacobian products), ``cast_operators``
to bfloat16, and the conv route a `BlockDiagMatrix` takes.

Tolerances: float32 ops rtol/atol 1e-5 (the same arithmetic in another
summation order); λmax rtol 1e-6 (both from ARPACK at tol 1e-9); the
collated arrays and the reordered samples exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hl_hgat_tpu.complex import build as jbuild
from hl_hgat_tpu.complex import dense as jdense
from hl_hgat_tpu.data.synthetic import random_simplex_sample as jrandom_sample
from hl_hgat_tpu.nn.conv import LaguerreConv as JLaguerreConv
from hl_hgat_tpu.ops import dispatch as jdispatch
from hl_hgat_tpu_torch.complex import build, dense
from hl_hgat_tpu_torch.complex.batch import CooMatrix
from hl_hgat_tpu_torch.complex.dense import BlockDiagMatrix
from hl_hgat_tpu_torch.data.synthetic import knn_graph, random_simplex_sample
from hl_hgat_tpu_torch.nn import conv
from hl_hgat_tpu_torch.ops import dispatch
from hl_hgat_tpu_torch.weights import from_flax_variables

F32 = dict(rtol=1e-5, atol=1e-5)
# node and edge caps small enough that the big graph's operators have
# entries in both bands and beyond them, at every level
CAPS = dict(node_cap=32, edge_cap=64)


def _arrays(obj, prefix=""):
    """Every array leaf of a (nested) batch dataclass, by path, as it is
    (NumPy or JAX array, or torch tensor)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {}
    if isinstance(obj, (tuple, list)):
        out = {}
        for i, v in enumerate(obj):
            out.update(_arrays(v, f"{prefix}{i}."))
        return out
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_arrays(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix.rstrip("."): obj}


def _dtype(v) -> str:
    return str(v.dtype).replace("torch.", "")


def _f32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(v).astype(np.float32)


def _sorted_coo(rows, cols, vals):
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], vals[order]


def _big_and_small(seed, *, num_pool=0, big_nodes=300):
    """One graph well past the caps and two small ones, from each package's
    generator and reordered by each package's BFS (the JAX spill tests'
    batch)."""
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    ours, theirs = [], []
    for n, extra in ((big_nodes, big_nodes // 2), (14, 4), (19, 5)):
        kw = dict(n_nodes=n, extra_edges=extra, node_feat=6, edge_feat=5, keig=0,
                  num_pool=num_pool)
        ours.append(dense.reorder_sample(random_simplex_sample(rng_a, **kw)))
        theirs.append(jdense.reorder_sample(jrandom_sample(rng_b, **kw)))
    return ours, theirs


@pytest.fixture(scope="module")
def spill_batches():
    """(port batch, JAX batch) per pooling depth: 0 (one level) or 1."""
    out = {}
    for pooled in (0, 1):
        ours, theirs = _big_and_small(3, num_pool=pooled, big_nodes=260 if pooled else 300)
        out[pooled] = (dense.collate_dense_packed(ours, **CAPS),
                       jdense.collate_dense_packed(theirs, **CAPS))
    return out


def test_hodge_laplacians_coo_matches_jax():
    """A 300-node k-NN graph over the dense build's 1024 edges: the same
    coalesced entries and λmax as the JAX build (which may take its native
    L1 path, in another COO order) and as the dense formula."""
    ei, _ = knn_graph(np.random.default_rng(0), 300)
    src, dst = ei[0].astype(np.int32), ei[1].astype(np.int32)
    assert src.shape[0] > build.SPARSE_BUILD_THRESHOLD
    (l0r, l0c, l0v), (l1r, l1c, l1v), lam = build.hodge_laplacians_coo(src, dst, 300)
    (j0r, j0c, j0v), (j1r, j1c, j1v), jlam = jbuild.hodge_laplacians_coo(src, dst, 300)
    np.testing.assert_allclose(lam, jlam, rtol=1e-6)
    for ours, ref in (((l0r, l0c, l0v), (j0r, j0c, j0v)), ((l1r, l1c, l1v), (j1r, j1c, j1v))):
        a, b = _sorted_coo(*ours), _sorted_coo(*(np.asarray(x) for x in ref))
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_allclose(a[2], b[2], **F32)
        # the port's own entries come sorted by (row, col)
        np.testing.assert_array_equal(ours[0], a[0])
        np.testing.assert_array_equal(ours[1], a[1])
    d0, d1, dlam = build.hodge_laplacians(src, dst, 300)
    np.testing.assert_allclose(lam, dlam, rtol=1e-6)
    for (r, c, v), full in (((l0r, l0c, l0v), d0), ((l1r, l1c, l1v), d1)):
        got = np.zeros_like(full)
        got[r, c] = v
        np.testing.assert_allclose(got, full, **F32)


@pytest.mark.parametrize("nodes", [60, 300])
def test_build_structure_switches_at_the_threshold(nodes):
    """Dense build up to 1024 edges, sparse-direct above, in both packages."""
    ei, _ = knn_graph(np.random.default_rng(nodes), nodes)
    src, dst = ei[0].astype(np.int32), ei[1].astype(np.int32)
    ours, ref = build.build_structure(src, dst, nodes), jbuild.build_structure(src, dst, nodes)
    assert (src.shape[0] > 1024) == (nodes == 300)
    for which in ("l0", "l1"):
        a = _sorted_coo(*(getattr(ours, f"{which}_{f}") for f in ("rows", "cols", "vals")))
        b = _sorted_coo(*(getattr(ref, f"{which}_{f}") for f in ("rows", "cols", "vals")))
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_allclose(a[2], b[2], **F32)
    assert ours.max_eig == pytest.approx(ref.max_eig, rel=1e-6)


@pytest.mark.parametrize("caps", [(128, 128), (32, 64), (64, 256)])
def test_pack_plan_spans_match_jax(caps):
    ours, theirs = _big_and_small(0)
    bins, spans = dense.pack_plan(ours, *caps)
    jbins, jspans = jdense.pack_plan(theirs, *caps)
    assert bins == jbins and spans == jspans
    big = ours[0]
    assert spans == {0: max(-(-big.num_nodes // caps[0]), -(-big.num_edges // caps[1]))}
    assert dense.pack_graphs(ours[1:], *caps) == jdense.pack_graphs(theirs[1:], *caps)
    with pytest.raises(ValueError, match="exceeds pack caps"):
        dense.pack_plan(ours, *caps, allow_span=False)


def test_bfs_order_and_reorder_match_jax():
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    for n, extra in ((40, 25), (120, 60), (7, 0)):
        s = random_simplex_sample(rng_a, n_nodes=n, extra_edges=extra, node_feat=3,
                                  edge_feat=2, keig=0, num_pool=1)
        js = jrandom_sample(rng_b, n_nodes=n, extra_edges=extra, node_feat=3, edge_feat=2,
                            keig=0, num_pool=1)
        st = s.levels[0]
        perm = dense.bfs_node_order(st.src, st.dst, n)
        np.testing.assert_array_equal(perm, jdense.bfs_node_order(st.src, st.dst, n))
        assert sorted(perm.tolist()) == list(range(n))
        s.y = np.arange(st.num_edges, dtype=np.float32)
        js.y = s.y.copy()
        a = _arrays(dense.reorder_sample(s, y_per_edge=True))
        b = _arrays(jdense.reorder_sample(js, y_per_edge=True))
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("pooled", [0, 1])
def test_spill_collate_matches_jax(spill_batches, pooled):
    """Every array of the spill-mode batch (blocks, bands, spills, pools,
    masks, ids, features) equals the JAX package's, with and without one
    MLGC level; the big graph's operators have both bands and a spill."""
    got, ref = spill_batches[pooled]
    a = {k: np.asarray(v) for k, v in _arrays(got).items()}
    b = {k: np.asarray(v) for k, v in _arrays(ref).items()}
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert len(got.levels) == 1 + pooled and len(got.pools) == pooled
    for lvl in got.levels:
        for op in (lvl.l0, lvl.l1):
            assert isinstance(op, BlockDiagMatrix)
            assert op.spill is not None and op.band_up is not None and op.band_dn is not None
        assert lvl.b1_sp is not None and lvl.b1_bu is not None and lvl.b1_bd is not None
    for p in got.pools:
        assert p.p_t_sp is not None and p.p_s_sp is not None
    # a batch of graphs that each fit one block has no band and no spill
    small = dense.collate_dense_packed([s for s in _big_and_small(3)[0][1:]], **CAPS)
    lvl = small.level0
    assert not isinstance(lvl.l0, BlockDiagMatrix) and not isinstance(lvl.l1, BlockDiagMatrix)
    assert lvl.b1_sp is None and lvl.b1_bu is None and lvl.b1_bd is None


def test_spill_batch_moves_to_tensors(spill_batches):
    batch = spill_batches[1][0].to("cpu")
    leaves = _arrays(batch)
    assert len(leaves) > 40
    for key, v in leaves.items():
        assert isinstance(v, torch.Tensor), key
    lvl = batch.level0
    assert isinstance(lvl.l1, BlockDiagMatrix) and isinstance(lvl.l1.spill, CooMatrix)
    for t in (lvl.l1.blocks, lvl.l1.band_up, lvl.l1.band_dn, lvl.l1.spill.vals, lvl.b1_bu,
              lvl.b1_sp.rows):
        assert isinstance(t, torch.Tensor)
    assert lvl.l1.spill.rows.dtype == torch.int32 and lvl.l1.spill.symmetric


_OPS = ["l0", "l1", "abs_b1_s2t", "abs_b1_t2s", "b1_t2s", "pool_to_coarse"]


@pytest.mark.parametrize("op", _OPS)
def test_spill_ops_match_jax(spill_batches, op):
    """Each operator on the pooled spill batch, its value and its
    vector-Jacobian product with a random cotangent, against the JAX
    function and ``jax.vjp``.  B1 has both bands, so the transposed
    products test the direction of each band."""
    got_b, ref_b = spill_batches[1]
    got_b, ref_b = got_b.to("cpu"), jax.tree.map(jnp.asarray, ref_b)
    lvl, jlvl = got_b.level0, ref_b.levels[0]
    rng = np.random.default_rng(_OPS.index(op))
    g, s, e = lvl.b1.shape
    if op == "pool_to_coarse":
        x = (rng.standard_normal((g, s, 6)).astype(np.float32),
             rng.standard_normal((g, e, 5)).astype(np.float32))
        fn = lambda a, b: dispatch.pool_to_coarse(  # noqa: E731
            got_b.pools[0], lvl, got_b.levels[1], a, b)
        jfn = lambda a, b: jdispatch.pool_to_coarse(  # noqa: E731
            ref_b.pools[0], jlvl, ref_b.levels[1], a, b)
    else:
        rows = s if op in ("l0", "abs_b1_t2s", "b1_t2s") else e
        x = (rng.standard_normal((g, rows, 7)).astype(np.float32),)
        if op in ("l0", "l1"):
            fn = lambda a: dispatch.lap_matvec(getattr(lvl, op), a)  # noqa: E731
            jfn = lambda a: jdispatch.lap_matvec(getattr(jlvl, op), a)  # noqa: E731
        else:
            fn = lambda a: getattr(dispatch, op)(lvl, a)  # noqa: E731
            jfn = lambda a: getattr(jdispatch, op)(jlvl, a)  # noqa: E731
    xs = [torch.from_numpy(a).requires_grad_() for a in x]
    out = fn(*xs)
    out = out if isinstance(out, tuple) else (out,)
    ref, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in x))
    ref = ref if isinstance(ref, tuple) else (ref,)
    cots = [rng.standard_normal(r.shape).astype(np.float32) for r in ref]
    for a, r in zip(out, ref):
        assert float(jnp.abs(r).max()) > 0
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), **F32)
    torch.autograd.backward(out, [torch.from_numpy(c) for c in cots])
    ref_grads = vjp(tuple(jnp.asarray(c) for c in cots) if len(cots) > 1 else jnp.asarray(cots[0]))
    for a, r in zip(xs, ref_grads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), **F32)


def test_band_add_and_spill_add_against_the_full_operator(spill_batches):
    """lap_matvec and B1ᵀ on the spill layout equal the flat operator
    assembled from blocks, bands and spill (a float64 oracle)."""
    host = spill_batches[0][0]  # NumPy arrays
    lvl, hl = host.to("cpu").level0, host.level0
    g, s, e = hl.b1.shape
    full_b1 = np.zeros((g * s, g * e))
    for b in range(g):
        full_b1[b * s:(b + 1) * s, b * e:(b + 1) * e] = hl.b1[b]
        if b + 1 < g:
            full_b1[b * s:(b + 1) * s, (b + 1) * e:(b + 2) * e] = hl.b1_bu[b]
        if b > 0:
            full_b1[b * s:(b + 1) * s, (b - 1) * e:b * e] = hl.b1_bd[b]
    np.add.at(full_b1, (hl.b1_sp.rows, hl.b1_sp.cols), hl.b1_sp.vals)
    x = np.random.default_rng(9).standard_normal((g, s, 3)).astype(np.float32)
    got = dispatch.b1_t2s(lvl, torch.from_numpy(x)).numpy().reshape(-1, 3)
    np.testing.assert_allclose(got, full_b1.T @ x.reshape(-1, 3), **F32)
    # L0 = B1 B1ᵀ · 2/λmax graph by graph: the operator is symmetric
    l0 = np.zeros((g * s, g * s))
    for b in range(g):
        l0[b * s:(b + 1) * s, b * s:(b + 1) * s] = hl.l0.blocks[b]
        if b + 1 < g:
            l0[b * s:(b + 1) * s, (b + 1) * s:(b + 2) * s] = hl.l0.band_up[b]
        if b > 0:
            l0[b * s:(b + 1) * s, (b - 1) * s:b * s] = hl.l0.band_dn[b]
    np.add.at(l0, (hl.l0.spill.rows, hl.l0.spill.cols), hl.l0.spill.vals)
    np.testing.assert_allclose(l0, l0.T, atol=1e-7)
    got = dispatch.lap_matvec(lvl.l0, torch.from_numpy(x)).numpy().reshape(-1, 3)
    np.testing.assert_allclose(got, l0 @ x.reshape(-1, 3), **F32)


def test_cast_operators_to_bfloat16(spill_batches):
    """Blocks, both bands and the spill values of every operator (pools
    too) turn bfloat16, as in the JAX package; indices, masks, degrees and
    ids keep their dtypes."""
    got_b, ref_b = spill_batches[1]
    cast = dispatch.cast_operators(got_b.to("cpu"), torch.bfloat16)
    ref = jdispatch.cast_operators(jax.tree.map(jnp.asarray, ref_b), jnp.bfloat16)
    a, b = _arrays(cast), _arrays(ref)
    assert set(a) == set(b)
    for key in a:
        assert _dtype(a[key]) == _dtype(b[key]), key
        np.testing.assert_array_equal(_f32(a[key]), _f32(b[key]), err_msg=key)
    lvl = cast.level0
    for t in (lvl.l1.blocks, lvl.l1.band_up, lvl.l1.band_dn, lvl.l1.spill.vals, lvl.b1,
              lvl.b1_bu, lvl.b1_bd, lvl.b1_sp.vals, lvl.l0.spill.vals):
        assert t.dtype == torch.bfloat16
    for t in (lvl.node_mask, lvl.deg):
        assert t.dtype == torch.float32
    assert lvl.l1.spill.rows.dtype == torch.int32


def test_block_diag_conv_takes_the_plain_route(spill_batches, monkeypatch):
    """A LaguerreConv on a `BlockDiagMatrix` runs the plain recurrence
    (no kernel wrapper is called, whatever the route flags say) and
    matches the JAX conv."""
    got_b, ref_b = spill_batches[0]
    lvl, jlvl = got_b.to("cpu").level0, jax.tree.map(jnp.asarray, ref_b).levels[0]

    def refuse(*_args, **_kw):
        raise AssertionError("a kernel wrapper was called on a BlockDiagMatrix")

    monkeypatch.setattr(conv, "laguerre_dense_fused", refuse)
    monkeypatch.setattr(conv, "laguerre_terms_dense", refuse)
    x = np.random.default_rng(11).standard_normal(lvl.l1.blocks.shape[:2] + (6,))
    x = x.astype(np.float32)
    jconv = JLaguerreConv(5, 3)
    v = jconv.init(jax.random.key(0), jnp.asarray(x), jlvl.l1)
    ref = jconv.apply(v, jnp.asarray(x), jlvl.l1)
    mod = conv.LaguerreConv(6, 5, 3)
    mod.load_state_dict(from_flax_variables(jax.tree.map(np.asarray, v)))
    for fused, terms in ((True, False), (False, True)):
        monkeypatch.setattr(conv, "_fused_dense_flag", fused)
        monkeypatch.setattr(conv, "_terms_kernel_flag", terms)
        out = mod(torch.from_numpy(x), lvl.l1)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **F32)
