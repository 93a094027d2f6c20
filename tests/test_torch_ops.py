"""Port's dense-layout dispatch and segment ops vs the JAX package's, on a
packed batch with random features (float32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hl_hgat_tpu.complex.dense import collate_dense_packed as jcollate
from hl_hgat_tpu.nn.gemm import stack_gemm as jstack_gemm
from hl_hgat_tpu.ops import dispatch as jd
from hl_hgat_tpu.ops import segment as jseg
from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
from hl_hgat_tpu_torch.data.synthetic import zinc_like_samples
from hl_hgat_tpu_torch.nn.gemm import stack_gemm
from hl_hgat_tpu_torch.ops import dispatch as d
from hl_hgat_tpu_torch.ops import segment as seg

TOL = dict(rtol=1e-5, atol=1e-5)  # f32, summation order only


@pytest.fixture(scope="module")
def batches():
    samples = zinc_like_samples(np.random.default_rng(7), 20)
    return (
        collate_dense_packed(samples, node_cap=64, edge_cap=64).to("cpu"),
        jax.tree.map(jnp.asarray, jcollate(samples, node_cap=64, edge_cap=64)),
    )


def _feat(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def test_operator_products_match_jax(batches, rng):
    tb, jb = batches
    tl, jl = tb.level0, jb.levels[0]
    g, s = tl.l0.shape[:2]
    xt, xj = _feat(rng, (g, s, 5))
    np.testing.assert_allclose(d.lap_matvec(tl.l0, xt), jd.lap_matvec(jl.l0, xj), **TOL)
    np.testing.assert_allclose(d.lap_matvec(tl.l1, xt), jd.lap_matvec(jl.l1, xj), **TOL)
    np.testing.assert_allclose(d.abs_b1_s2t(tl, xt), jd.abs_b1_s2t(jl, xj), **TOL)
    np.testing.assert_allclose(d.abs_b1_t2s(tl, xt), jd.abs_b1_t2s(jl, xj), **TOL)
    np.testing.assert_allclose(d.b1_t2s(tl, xt), jd.b1_t2s(jl, xj), **TOL)
    np.testing.assert_allclose(d.apply_node_mask(tl, xt), jd.apply_node_mask(jl, xj))
    np.testing.assert_allclose(d.apply_edge_mask(tl, xt), jd.apply_edge_mask(jl, xj))


@pytest.mark.parametrize("scatter", [False, True])
def test_masked_means_match_jax(batches, rng, monkeypatch, scatter):
    tb, jb = batches
    if scatter:  # budget 0 forces the index_add_ / segment_sum branch
        monkeypatch.setattr(d, "_MATMUL_READOUT_MAX_BYTES", 0)
        monkeypatch.setattr(jd, "_MATMUL_READOUT_MAX_BYTES", 0)
    g, s = tb.level0.l0.shape[:2]
    xt, xj = _feat(rng, (g, s, 6))
    for ours, ref in ((d.masked_mean_nodes, jd.masked_mean_nodes),
                      (d.masked_mean_edges, jd.masked_mean_edges)):
        out = ours(tb.level0, xt, tb.num_graphs)
        assert out.shape == (20, 6)
        np.testing.assert_allclose(out, ref(jb.levels[0], xj, jb.num_graphs), **TOL)


def test_segment_means_and_embedding_match_jax(rng):
    ids = rng.integers(0, 6, 50).astype(np.int32)  # 5 = dump bucket
    w = (rng.random(50) > 0.3).astype(np.float32)
    x, xj = _feat(rng, (50, 4))
    ti, tw = torch.from_numpy(ids), torch.from_numpy(w)
    ji, jw = jnp.asarray(ids), jnp.asarray(w)
    np.testing.assert_allclose(
        seg.segment_mean_onehot(x, ti, 5, weights=tw),
        jseg.segment_mean_onehot(xj, ji, 5, weights=jw), **TOL)
    np.testing.assert_allclose(
        seg.segment_mean(x, ti, 5, weights=tw),
        jseg.segment_mean(xj, ji, 5, weights=jw), **TOL)
    np.testing.assert_allclose(
        seg.segment_mean(x, ti, 5), jseg.segment_mean(xj, ji, 5), **TOL)
    table, tablej = _feat(rng, (28, 3))
    tok = rng.integers(0, 28, (4, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        seg.embed_lookup(table, torch.from_numpy(tok).long()),
        jseg.embed_lookup(tablej, jnp.asarray(tok)))


def test_cast_operators_and_bf16_products(batches, rng):
    tb, jb = batches
    cb = d.cast_operators(tb, torch.bfloat16)
    cj = jd.cast_operators(jb, jnp.bfloat16)
    assert d.cast_operators(tb, torch.float32) is tb
    assert cb.level0.l0.dtype == torch.bfloat16 and cb.level0.b1.dtype == torch.bfloat16
    assert cb.level0.node_mask.dtype == torch.float32 and cb.level0.deg.dtype == torch.float32
    for f in ("l0", "l1", "b1"):
        np.testing.assert_array_equal(
            getattr(cb.level0, f).float(), np.asarray(getattr(cj.levels[0], f), np.float32))
    g, s = tb.level0.l0.shape[:2]
    x = rng.standard_normal((g, s, 8)).astype(np.float32)
    xt, xj = torch.from_numpy(x).bfloat16(), jnp.asarray(x, jnp.bfloat16)
    out = d.abs_b1_t2s(cb.level0, xt)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float(), np.asarray(jd.abs_b1_t2s(cj.levels[0], xj), np.float32),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_gemm_matches_jax(rng, dtype):
    x = rng.standard_normal((3, 16, 24)).astype(np.float32)
    w = rng.standard_normal((24, 10)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out = stack_gemm(xt, torch.from_numpy(w))
    assert out.dtype == torch.float32  # the f32 accumulator
    ref = jstack_gemm(jnp.asarray(x, dtype), jnp.asarray(w))
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-4)
