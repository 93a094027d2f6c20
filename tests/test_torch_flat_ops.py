"""The port's flat (COO/ELL) layout against the JAX package on the CPU:
the NumPy collate functions field by field (exact), the ELL SpMM with its backward
against the Pallas kernel in interpret mode, the COO SpMM, the boundary and
segment functions and the flat branches of ``ops.dispatch``.

Tolerances: float32 rtol/atol 1e-5 (same arithmetic, summation order
only); bfloat16 2e-2 of max|ref| (one rounding of the same f32 sum, a
flipped ulp of the largest entries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hl_hgat_tpu.complex import build as jbuild
from hl_hgat_tpu.data import synthetic as jsynthetic
from hl_hgat_tpu.ops import boundary as JB
from hl_hgat_tpu.ops import dispatch as jdispatch
from hl_hgat_tpu.ops import pallas_spmm
from hl_hgat_tpu.ops import segment as JS
from hl_hgat_tpu.ops import spmm as jspmm
from hl_hgat_tpu_torch.complex import build
from hl_hgat_tpu_torch.complex.batch import ComplexBatch, ComplexLevel, CooMatrix, graph_sizes
from hl_hgat_tpu_torch.data import synthetic
from hl_hgat_tpu_torch.ops import boundary as B
from hl_hgat_tpu_torch.ops import dispatch, ell_spmm, spmm
from hl_hgat_tpu_torch.ops import segment as S

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 2e-2


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(getattr(torch, dtype))


def _close(ours, ref, dtype="float32", what=""):
    ours = ours.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, err_msg=what, **F32)
    else:
        np.testing.assert_allclose(
            ours, ref, rtol=0, atol=BF16_REL * np.abs(ref).max(), err_msg=what)


def _python_loop_ell(rows, cols, vals, num_rows, **kw):
    """The JAX package's reference loop (its collate may take a native
    implementation instead; both must give this)."""
    return jbuild.coo_to_ell(rows, cols, vals, num_rows, **kw)


def _symmetric_coo(rng, n, nnz, pad=0):
    """Random symmetric pattern without duplicate (row, col) pairs, in a
    shuffled order, plus ``pad`` padding entries (index 0, value 0)."""
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (rng.integers(0, n, nnz), rng.integers(0, n, nnz)),
              rng.standard_normal(nnz).astype(np.float32))
    dense = dense + dense.T
    rows, cols = np.nonzero(dense)
    order = rng.permutation(rows.size)
    rows, cols = rows[order].astype(np.int32), cols[order].astype(np.int32)
    vals = dense[rows, cols]
    z = np.zeros(pad, np.int32)
    return (np.r_[rows, z], np.r_[cols, z], np.r_[vals, np.zeros(pad, np.float32)], dense)


# ---------------------------------------------------------------------------
# collate, ELL packing, link pairs: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,nnz,pad,width", [
    (16, 40, 0, None), (12, 30, 7, None), (9, 5, 3, 6), (5, 0, 4, None), (64, 300, 11, None)])
def test_coo_to_ell_reproduces_the_loop_slot_order(rng, n, nnz, pad, width):
    rows, cols, vals, _ = _symmetric_coo(rng, n, nnz, pad)
    vals[::5] = 0.0  # explicit zeros inside the pattern are dropped too
    ec, ev = build.coo_to_ell(rows, cols, vals, n, width=width)
    rc, rv = _python_loop_ell(rows, cols, vals, n, width=width)
    assert ec.dtype == np.int32 and ev.dtype == np.float32
    np.testing.assert_array_equal(ec, rc)
    np.testing.assert_array_equal(ev, rv)


def test_coo_to_ell_keeps_duplicates_apart_and_raises_on_overflow(rng):
    rows = np.array([2, 0, 2, 2, 1], np.int32)
    cols = np.array([1, 0, 1, 0, 2], np.int32)
    vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    ec, ev = build.coo_to_ell(rows, cols, vals, 3)
    rc, rv = _python_loop_ell(rows, cols, vals, 3)
    np.testing.assert_array_equal(ec, rc)
    np.testing.assert_array_equal(ev, rv)
    assert ev[2].tolist() == [1.0, 3.0, 4.0]  # COO order within the row
    with pytest.raises(ValueError, match="exceeds ELL width"):
        build.coo_to_ell(rows, cols, vals, 3, width=2)


def _assert_same_tree(ours, ref, path=""):
    """Field by field, exact: arrays, static fields and None alike."""
    import dataclasses

    if dataclasses.is_dataclass(ours):
        names = [f.name for f in dataclasses.fields(ours)]
        assert names == [f.name for f in dataclasses.fields(ref)], path
        for name in names:
            _assert_same_tree(getattr(ours, name), getattr(ref, name), f"{path}.{name}")
    elif isinstance(ours, tuple) and not isinstance(ours[0] if ours else 0, (int, np.integer)):
        assert len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_same_tree(a, b, f"{path}[{i}]")
    elif ours is None or isinstance(ours, (int, bool, tuple)):
        assert ours == ref, path
    else:
        a, b = np.asarray(ours), np.asarray(ref)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


def _samples_pair(seed, count, **kw):
    ours = [synthetic.random_simplex_sample(np.random.default_rng(seed + i), **kw)
            for i in range(count)]
    ref = [jsynthetic.random_simplex_sample(np.random.default_rng(seed + i), **kw)
           for i in range(count)]
    return ours, ref


@pytest.mark.parametrize("kw", [
    dict(), dict(with_ell=True), dict(with_ell=True, multiple=1), dict(y_per_node=True),
    dict(y_per_edge=True, with_ell=True)])
def test_collate_matches_jax_field_by_field(kw):
    ours, ref = _samples_pair(3, 5, n_nodes=11, extra_edges=3, node_feat=4, edge_feat=2, keig=4)
    if kw.get("y_per_node") or kw.get("y_per_edge"):
        for so, sr in zip(ours, ref):
            n = so.num_nodes if kw.get("y_per_node") else so.num_edges
            so.y = sr.y = np.arange(n, dtype=np.float32)
    batch, jbatch = build.collate(ours, **kw), jbuild.collate(ref, **kw)
    _assert_same_tree(batch, jbatch)
    lvl = batch.level0
    assert lvl.l0.symmetric and lvl.l0.shape == (lvl.num_nodes, lvl.num_nodes)
    # padding: edges point at the last node slot, ids at the dump bucket
    pad_e = lvl.edge_mask == 0
    assert (lvl.src[pad_e] == lvl.num_nodes - 1).all() and (lvl.s_id[pad_e] == 5).all()


def test_collate_with_explicit_pads_and_overflow():
    ours, ref = _samples_pair(9, 3, n_nodes=8, extra_edges=2, node_feat=3, edge_feat=1, keig=0)
    pads = build.pad_spec(ours, multiple=16, slack=1.5)
    jpads = jbuild.pad_spec(ref, multiple=16, slack=1.5)
    assert [(p.nodes, p.edges, p.nnz0, p.nnz1) for p in pads] == [
        (p.nodes, p.edges, p.nnz0, p.nnz1) for p in jpads]
    _assert_same_tree(build.collate(ours, pads, with_ell=True),
                      jbuild.collate(ref, jpads, with_ell=True))
    with pytest.raises(ValueError, match="exceeds pad spec"):
        build.collate(ours, [build.LevelPad(nodes=8, edges=8, nnz0=8, nnz1=8)])


def test_attach_link_pairs_and_synthetic_batch_match_jax():
    ours, ref = _samples_pair(5, 4, n_nodes=13, extra_edges=2, node_feat=3, edge_feat=2, keig=0)
    ours[1].extra = ref[1].extra = dict(
        edge_label_index=np.array([[0, 2, 5, 7], [3, 4, 6, 9]]), edge_label=np.array([1, 0, 1, 1]))
    batch = build.attach_link_pairs(
        build.collate(ours), ours, np.random.default_rng(7), n_queries=3, n_neg=4)
    jbatch = jbuild.attach_link_pairs(
        jbuild.collate(ref), ref, np.random.default_rng(7), n_queries=3, n_neg=4)
    _assert_same_tree(batch, jbatch)
    assert batch.pairs.shape == (4 * 3 * 5, 2) and batch.y.reshape(-1, 5)[:, 0].all()
    for kw in (dict(), dict(embed_ids=True, with_ell=True), dict(keig=6, with_ell=True)):
        _assert_same_tree(synthetic.synthetic_zinc_batch(5, seed=2, **kw),
                          jsynthetic.synthetic_zinc_batch(5, seed=2, **kw))


def test_batch_to_device_and_graph_sizes():
    samples = synthetic.zinc_like_samples(np.random.default_rng(0), 4)
    host = build.collate(samples, with_ell=True)
    batch = host.to("cpu")
    assert isinstance(batch, ComplexBatch) and isinstance(batch.level0, ComplexLevel)
    assert isinstance(batch.level0.l0, CooMatrix) and batch.pairs is None
    for t in (batch.x_t, batch.y, batch.level0.src, batch.level0.l1.ell_vals, batch.level0.deg):
        assert isinstance(t, torch.Tensor)
    assert batch.level0.l0.ell_cols.dtype == torch.int32
    assert batch.level0.l0.shape == host.level0.l0.shape and batch.num_graphs == 4
    n, e = graph_sizes(batch.level0)
    assert n.tolist() == [s.num_nodes for s in samples]
    assert e.tolist() == [s.num_edges for s in samples]
    assert batch.replace(num_graphs=3).num_graphs == 3


# ---------------------------------------------------------------------------
# the ELL SpMM against the Pallas kernel (interpret mode on the CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,nnz,feat", [(12, 30, 5), (40, 90, 37), (24, 20, 64), (7, 3, 1)])
def test_ell_symmetric_forward_dx_dvals_match_pallas(rng, dtype, n, nnz, feat):
    rows, cols, vals, dense = _symmetric_coo(rng, n, nnz, pad=3)
    ec, ev = build.coo_to_ell(rows, cols, vals, n)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    cot = rng.standard_normal((n, feat)).astype(np.float32)

    tv = _t(ev, dtype).requires_grad_()
    tx = _t(x, dtype).requires_grad_()
    ell_spmm.reset_launch_counts()
    out = ell_spmm.spmm_ell_symmetric(_t(ec), tv, tx)
    out.backward(_t(cot, dtype))
    assert ell_spmm.LAUNCHES == {"spmm_ell": 0, "spmm_ell_bwd": 0}  # CPU: plain version
    assert out.dtype == tx.dtype == tx.grad.dtype and tv.grad.dtype == tv.dtype

    ref, vjp = jax.vjp(
        lambda v, xx: pallas_spmm.spmm_ell_symmetric(jnp.asarray(ec), v, xx),
        jnp.asarray(ev, dtype), jnp.asarray(x, dtype))
    rdv, rdx = vjp(jnp.asarray(cot, dtype))
    _close(out, ref, dtype, "out")
    _close(tx.grad, rdx, dtype, "dx")
    _close(tv.grad, rdv, dtype, "dvals")
    assert bool((tv.grad[_t(ev) == 0] == 0).all())  # padding slots: masked
    if dtype == "float32":
        np.testing.assert_allclose(out.detach().numpy(), dense @ x, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tx.grad.numpy(), dense @ cot, rtol=1e-4, atol=1e-5)


def test_ell_dvals_are_computed_only_on_request(rng, monkeypatch):
    rows, cols, vals, _ = _symmetric_coo(rng, 10, 20)
    ec, ev = build.coo_to_ell(rows, cols, vals, 10)
    called = []
    real = ell_spmm.spmm_ell_dvals_plain
    monkeypatch.setattr(ell_spmm, "spmm_ell_dvals_plain",
                        lambda *a: called.append(1) or real(*a))
    x = _t(rng.standard_normal((10, 4)).astype(np.float32)).requires_grad_()
    ell_spmm.spmm_ell_symmetric(_t(ec), _t(ev), x).sum().backward()
    assert called == [] and x.grad is not None
    v = _t(ev).requires_grad_()
    ell_spmm.spmm_ell_symmetric(_t(ec), v, x.detach()).sum().backward()
    assert called == [1] and v.grad.shape == ev.shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_plain_takes_trailing_axes_like_the_xla_route(rng, dtype):
    rows, cols, vals, _ = _symmetric_coo(rng, 14, 30)
    ec, ev = build.coo_to_ell(rows, cols, vals, 14)
    x = rng.standard_normal((14, 3, 6)).astype(np.float32)
    cot = rng.standard_normal((14, 3, 6)).astype(np.float32)
    tx = _t(x, dtype).requires_grad_()
    tv = _t(ev, dtype).requires_grad_()
    out = spmm.spmm_ell_sym(_t(ec), tv, tx)
    out.backward(_t(cot, dtype))
    ref, vjp = jax.vjp(lambda v, xx: jspmm.spmm_ell_sym(jnp.asarray(ec), v, xx),
                       jnp.asarray(ev, dtype), jnp.asarray(x, dtype))
    rdv, rdx = vjp(jnp.asarray(cot, dtype))
    _close(out, ref, dtype)
    _close(tx.grad, rdx, dtype, "dx")
    live = ev != 0  # the XLA route does not mask padding slots; autograd here does not either
    _close(tv.grad[_t(live)], np.asarray(rdv, np.float32)[live], dtype, "dvals")
    # the differentiable kernel route flattens the trailing axes itself
    out2 = ell_spmm.spmm_ell_symmetric(_t(ec), _t(ev, dtype), _t(x, dtype))
    assert out2.shape == (14, 3, 6) and torch.equal(out2, out.detach())


def test_ell_wrappers_reject_rectangular_and_malformed_inputs():
    cols, vals = torch.zeros(4, 2, dtype=torch.int32), torch.zeros(4, 2)
    for fn in (ell_spmm.spmm_ell, ell_spmm.spmm_ell_plain, ell_spmm.spmm_ell_symmetric):
        with pytest.raises(ValueError, match="square"):
            fn(cols, vals, torch.zeros(5, 3))
        with pytest.raises(ValueError, match=r"\[N, W\]"):
            fn(cols, vals[:, :1], torch.zeros(4, 3))
    with pytest.raises(ValueError, match="width"):
        ell_spmm.spmm_ell_plain(cols[:, :0], vals[:, :0], torch.zeros(4, 3))
    assert ell_spmm.use_ell_kernel() is True
    ell_spmm.use_ell_kernel(False)
    assert ell_spmm.use_ell_kernel() is False
    ell_spmm.use_ell_kernel(True)


# ---------------------------------------------------------------------------
# COO SpMM, SDDMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_coo_forward_and_gradients_match_jax(rng, dtype):
    n_rows, n_cols, nnz, feat = 9, 11, 30, 6
    rows = np.r_[rng.integers(0, n_rows, nnz), np.zeros(4, np.int64)].astype(np.int32)
    cols = np.r_[rng.integers(0, n_cols, nnz), np.zeros(4, np.int64)].astype(np.int32)
    vals = np.r_[rng.standard_normal(nnz), np.zeros(4)].astype(np.float32)
    x = rng.standard_normal((n_cols, feat)).astype(np.float32)
    cot = rng.standard_normal((n_rows, feat)).astype(np.float32)
    tv, tx = _t(vals, dtype).requires_grad_(), _t(x, dtype).requires_grad_()
    out = spmm.spmm_coo(_t(rows), _t(cols), tv, tx, n_rows)
    out.backward(_t(cot, dtype))
    ref, vjp = jax.vjp(
        lambda v, xx: jspmm.spmm_coo(jnp.asarray(rows), jnp.asarray(cols), v, xx, n_rows),
        jnp.asarray(vals, dtype), jnp.asarray(x, dtype))
    rdv, rdx = vjp(jnp.asarray(cot, dtype))
    _close(out, ref, dtype)
    _close(tx.grad, rdx, dtype, "dx")
    _close(tv.grad, rdv, dtype, "dvals")
    if dtype == "float32":
        oracle = spmm.spmm_dense_oracle(_t(rows), _t(cols), _t(vals), _t(x), n_rows)
        np.testing.assert_allclose(
            oracle.numpy(),
            jspmm.spmm_dense_oracle(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
                                    jnp.asarray(x), n_rows), **F32)
        np.testing.assert_allclose(out.detach().numpy(), oracle.numpy(), rtol=1e-4, atol=1e-5)
    tr, tc, tvv = spmm.coo_transpose(_t(rows), _t(cols), _t(vals))
    assert tr is not None and torch.equal(tr, _t(cols)) and torch.equal(tc, _t(rows))


def test_sddmm_matches_jax(rng):
    rows = rng.integers(0, 8, 20).astype(np.int32)
    cols = rng.integers(0, 9, 20).astype(np.int32)
    a = rng.standard_normal((8, 5)).astype(np.float32)
    b = rng.standard_normal((9, 5)).astype(np.float32)
    out = spmm.sddmm_coo(_t(rows), _t(cols), _t(a), _t(b))
    ref = jspmm.sddmm_coo(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(out.numpy(), ref, **F32)
    np.testing.assert_allclose(out.numpy(), (a @ b.T)[rows, cols], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# boundary and segment functions
# ---------------------------------------------------------------------------


def _edges(rng, n, e, pad):
    src = np.r_[rng.integers(0, n - 1, e), np.full(pad, n - 1)].astype(np.int32)
    dst = np.r_[rng.integers(0, n - 1, e), np.full(pad, n - 1)].astype(np.int32)
    mask = np.r_[np.ones(e), np.zeros(pad)].astype(np.float32)
    return src, dst, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["boundary_abs_s2t", "boundary_s2t"])
@pytest.mark.parametrize("masked", [True, False])
def test_boundary_s2t_products_match_jax(rng, name, masked, dtype):
    n, e, pad = 10, 17, 3
    src, dst, mask = _edges(rng, n, e, pad)
    x_s = rng.standard_normal((e + pad, 4)).astype(np.float32)
    m = mask if masked else None
    out = getattr(B, name)(_t(x_s, dtype), _t(src), _t(dst), n,
                           edge_mask=None if m is None else _t(m))
    ref = getattr(JB, name)(jnp.asarray(x_s, dtype), jnp.asarray(src), jnp.asarray(dst), n,
                            edge_mask=None if m is None else jnp.asarray(m))
    assert out.shape == (n, 4)
    _close(out, ref, dtype)


@pytest.mark.parametrize("name", ["boundary_abs_t2s", "boundary_t2s"])
@pytest.mark.parametrize("shape", [(10, 4), (10, 3, 2)])
def test_boundary_t2s_products_match_jax(rng, name, shape):
    src, dst, mask = _edges(rng, 10, 17, 3)
    x_t = rng.standard_normal(shape).astype(np.float32)
    out = getattr(B, name)(_t(x_t), _t(src), _t(dst), edge_mask=_t(mask))
    ref = getattr(JB, name)(jnp.asarray(x_t), jnp.asarray(src), jnp.asarray(dst),
                            edge_mask=jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=0)
    assert not out[-3:].any()  # padded edges are zeroed


def test_node_degree_matches_jax(rng):
    src, dst, mask = _edges(rng, 10, 17, 3)
    for m, eps in ((None, 0.0), (mask, 1e-6)):
        out = B.node_degree(_t(src), _t(dst), 10, edge_mask=None if m is None else _t(m), eps=eps)
        ref = JB.node_degree(jnp.asarray(src), jnp.asarray(dst), 10,
                             edge_mask=None if m is None else jnp.asarray(m), eps=eps)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


def _segments(rng, rows, num_segments):
    ids = rng.integers(0, num_segments, rows).astype(np.int32)
    ids[-3:] = num_segments  # the dump bucket
    ids[ids == 2] = 0  # segment 2 stays empty
    return ids


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(20,), (20, 5), (20, 2, 3)])
def test_segment_sum_matches_jax_and_drops_the_dump_bucket(rng, shape, dtype):
    ids = _segments(rng, 20, 6)
    data = rng.standard_normal(shape).astype(np.float32)
    out = S.segment_sum(_t(data, dtype), _t(ids), 6)
    ref = JS.segment_sum(jnp.asarray(data, dtype), jnp.asarray(ids), 6)
    assert out.shape == (6,) + shape[1:] and out.dtype == getattr(torch, dtype)
    _close(out, ref, dtype)
    assert not out[2].any()
    # negative ids are dropped too, and int64 ids are taken
    ids64 = ids.astype(np.int64)
    ids64[0] = -1
    keep = (ids64 >= 0) & (ids64 < 6)
    expect = np.zeros((6,) + shape[1:], np.float32)
    np.add.at(expect, ids64[keep], data[keep])
    _close(S.segment_sum(_t(data), _t(ids64), 6), expect)


def test_segment_count_max_mean_match_jax(rng):
    ids = _segments(rng, 20, 6)
    data = rng.standard_normal((20, 4)).astype(np.float32)
    w = (rng.random(20) > 0.3).astype(np.float32)
    jids, jdata, jw = jnp.asarray(ids), jnp.asarray(data), jnp.asarray(w)
    np.testing.assert_allclose(S.segment_count(_t(ids), 6).numpy(), JS.segment_count(jids, 6))
    np.testing.assert_allclose(S.segment_count(_t(ids), 6, weights=_t(w)).numpy(),
                               JS.segment_count(jids, 6, weights=jw))
    for mv in (0.0, -3.0):
        np.testing.assert_allclose(
            S.segment_max(_t(data), _t(ids), 6, mask_value=mv).numpy(),
            JS.segment_max(jdata, jids, 6, mask_value=mv), rtol=0, atol=0)
    for kw, jkw in ((dict(), dict()), (dict(weights=_t(w)), dict(weights=jw)),
                    (dict(weights=_t(w), eps=0.5), dict(weights=jw, eps=0.5))):
        np.testing.assert_allclose(S.segment_mean(_t(data), _t(ids), 6, **kw).numpy(),
                                   JS.segment_mean(jdata, jids, 6, **jkw), **F32)
    out16 = S.segment_mean(_t(data, "bfloat16"), _t(ids), 6, weights=_t(w))
    _close(out16, JS.segment_mean(jnp.asarray(data, "bfloat16"), jids, 6, weights=jw), "bfloat16")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(24,), (24, 3)])
def test_segment_softmax_matches_jax(rng, shape, masked):
    ids = np.sort(rng.integers(0, 5, 24)).astype(np.int32)
    ids[ids == 3] = 4
    logits = (rng.standard_normal(shape) * 4).astype(np.float32)
    mask = (rng.random(24) > 0.3).astype(np.float32) if masked else None
    out = S.segment_softmax(_t(logits), _t(ids), 5, mask=None if mask is None else _t(mask))
    ref = JS.segment_softmax(jnp.asarray(logits), jnp.asarray(ids), 5,
                             mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-7)
    sums = S.segment_sum(out, _t(ids), 5).numpy().reshape(5, -1)
    live = np.unique(ids if mask is None else ids[mask > 0])
    np.testing.assert_allclose(sums[live], 1.0, rtol=1e-5)
    ids[-2:] = 5  # dump-bucket rows come out 0 and leave the others alone
    out2 = S.segment_softmax(_t(logits), _t(ids), 5)
    assert not out2[-2:].any() and torch.isfinite(out2).all()


# ---------------------------------------------------------------------------
# ops.dispatch, flat branches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flat_pair():
    samples = synthetic.zinc_like_samples(np.random.default_rng(5), 5)
    batch = build.collate(samples, with_ell=True)
    jb = jax.tree.map(jnp.asarray, jsynthetic.synthetic_zinc_batch(
        5, seed=5, embed_ids=True, with_ell=True))
    _assert_same_tree(batch, jax.tree.map(np.asarray, jb))
    return batch.to("cpu"), jb


def _without_ell(m):
    import dataclasses

    return dataclasses.replace(m, ell_cols=None, ell_vals=None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["ell_kernel", "ell_gather", "coo"])
@pytest.mark.parametrize("which,trailing", [("l0", (6,)), ("l1", (6,)), ("l0", (2, 3))])
def test_lap_matvec_flat_routes_match_jax(flat_pair, rng, monkeypatch, route, which, trailing,
                                          dtype):
    """The three flat routes of both packages: the row-gather kernel (here
    its plain version under the custom backward; there Pallas in interpret
    mode), the autodiff ELL gather, and the COO scatter."""
    batch, jb = flat_pair
    if dtype == "bfloat16":
        batch = dispatch.cast_operators(batch, torch.bfloat16)
        jb = jdispatch.cast_operators(jb, jnp.bfloat16)
    lap, jlap = getattr(batch.level0, which), getattr(jb.levels[0], which)
    n = lap.shape[0]
    x = rng.standard_normal((n,) + trailing).astype(np.float32)
    cot = rng.standard_normal((n,) + trailing).astype(np.float32)
    monkeypatch.setenv("HLHGAT_ELL_PALLAS", "1" if route == "ell_kernel" else "0")
    tx = _t(x, dtype).requires_grad_()
    if route == "coo":
        lap, jlap = _without_ell(lap), _without_ell(jlap)
    if route == "ell_gather":
        out = spmm.spmm_ell_sym(lap.ell_cols, lap.ell_vals, tx)
    else:
        out = dispatch.lap_matvec(lap, tx)
    out.backward(_t(cot, dtype))
    ref, vjp = jax.vjp(lambda xx: jdispatch.lap_matvec(jlap, xx), jnp.asarray(x, dtype))
    (rdx,) = vjp(jnp.asarray(cot, dtype))
    assert out.shape == x.shape and out.dtype == getattr(torch, dtype)
    _close(out, ref, dtype)
    _close(tx.grad, rdx, dtype, "dx")


def test_lap_matvec_unsymmetric_ell_falls_to_coo(flat_pair, rng, monkeypatch):
    import dataclasses

    batch, _ = flat_pair
    lap = dataclasses.replace(batch.level0.l0, symmetric=False)
    calls = []
    monkeypatch.setattr(dispatch, "spmm_ell_symmetric", lambda *a: calls.append(1))
    x = _t(rng.standard_normal((lap.shape[0], 3)).astype(np.float32))
    out = dispatch.lap_matvec(lap, x)
    assert calls == []
    _close(out, ell_spmm.spmm_ell_plain(lap.ell_cols, lap.ell_vals, x))


@pytest.mark.parametrize("name", ["abs_b1_s2t", "abs_b1_t2s", "b1_t2s", "masked_mean_nodes",
                                  "masked_mean_edges", "apply_node_mask", "apply_edge_mask"])
def test_flat_dispatch_functions_match_jax(flat_pair, rng, name):
    batch, jb = flat_pair
    lvl, jlvl = batch.level0, jb.levels[0]
    on_edges = name in ("abs_b1_s2t", "masked_mean_edges", "apply_edge_mask")
    x = rng.standard_normal((lvl.num_edges if on_edges else lvl.num_nodes, 4)).astype(np.float32)
    extra = (batch.num_graphs,) if name.startswith("masked_mean") else ()
    out = getattr(dispatch, name)(lvl, _t(x), *extra)
    ref = getattr(jdispatch, name)(jlvl, jnp.asarray(x), *extra)
    np.testing.assert_allclose(out.numpy(), ref, **F32)


def test_cast_operators_casts_coo_and_ell_values(flat_pair):
    batch, _ = flat_pair
    assert dispatch.cast_operators(batch, torch.float32) is batch
    cast = dispatch.cast_operators(batch, torch.bfloat16)
    for m in (cast.level0.l0, cast.level0.l1):
        assert m.vals.dtype == m.ell_vals.dtype == torch.bfloat16
        assert m.ell_cols.dtype == m.rows.dtype == torch.int32 and m.symmetric
    assert cast.level0.deg.dtype == cast.level0.node_mask.dtype == torch.float32
    assert batch.level0.l0.ell_vals.dtype == torch.float32  # the input is left alone
    import dataclasses

    coo = batch.replace(levels=(dataclasses.replace(
        batch.level0, l0=_without_ell(batch.level0.l0), l1=_without_ell(batch.level0.l1)),))
    assert dispatch.cast_operators(coo, torch.bfloat16).level0.l0.ell_vals is None
