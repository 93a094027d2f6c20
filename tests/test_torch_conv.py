"""Port's Laguerre kernels (plain versions on the CPU), conv routes, BN and
NodeEdgeInt vs the JAX package.  The JAX Pallas kernels run in interpret
mode on the CPU, as tests/test_pallas_hodge.py runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hl_hgat_tpu.complex.dense import collate_dense_packed as jcollate
from hl_hgat_tpu.nn import conv as jconv
from hl_hgat_tpu.nn.conv import laguerre_matvec as jlaguerre_matvec
from hl_hgat_tpu.nn.interaction import NodeEdgeInt as JNodeEdgeInt
from hl_hgat_tpu.nn.norm import MaskedBatchNorm as JMaskedBatchNorm
from hl_hgat_tpu.ops import pallas_hodge
from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
from hl_hgat_tpu_torch.data.synthetic import zinc_like_samples
from hl_hgat_tpu_torch.nn import conv
from hl_hgat_tpu_torch.nn.interaction import NodeEdgeInt
from hl_hgat_tpu_torch.nn.norm import MaskedBatchNorm
from hl_hgat_tpu_torch.ops import laguerre_dense as lg
from hl_hgat_tpu_torch.weights import from_flax_variables
from torch_counters import recorded  # noqa: F401  (a fixture)

F32 = dict(rtol=1e-5, atol=1e-5)  # same f32 arithmetic, summation order only
BF16_ATOL = 2e-2  # one bf16 ulp of O(1) terms, rounding points identical


def _kernel_inputs(rng, g=3, s=16, c=8, f=8, k=4):
    l = rng.standard_normal((g, s, s)).astype(np.float32)
    l = (l + l.transpose(0, 2, 1)) / 4  # symmetric, like a Hodge Laplacian
    x = rng.standard_normal((g, s, c)).astype(np.float32)
    w = rng.standard_normal((k, c, f)).astype(np.float32) * 0.1
    b = rng.standard_normal(f).astype(np.float32)
    return l, x, w, b


def _close(ours, ref, dtype):
    ours = ours.float().numpy()
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, **F32)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,c,f", [(1, 8, 8), (2, 8, 8), (3, 12, 20), (6, 8, 8)])
def test_fused_plain_matches_pallas(rng, dtype, k, c, f):
    l, x, w, b = _kernel_inputs(rng, c=c, f=f, k=k)
    td = getattr(torch, dtype)
    ours = lg.laguerre_dense_fused(
        torch.from_numpy(l).to(td), torch.from_numpy(x).to(td),
        torch.from_numpy(w), torch.from_numpy(b))
    assert ours.dtype == td and ours.shape == (3, 16, f)
    ref = pallas_hodge.laguerre_dense_fused(
        jnp.asarray(l, dtype), jnp.asarray(x, dtype), jnp.asarray(w), jnp.asarray(b))
    _close(ours, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_bwd_plain_matches_pallas_vjp_at_a_wide_output(dtype):
    """The VJP of the JAX fused kernel (interpret mode) against the port's
    plain backward over 128 rows at F = 1600, wider than any cotangent whose
    rows a CTA of the card's band kernel can hold in shared memory: the
    function the card must compute there.  float32 at the gradient
    tolerance of test_torch_grad.py; bfloat16 at 2e-2 of each output's
    max|ref| (the card's band tolerance): b̄_k sums 1600 columns before its
    one rounding, so a flipped rounding moves dx by an ulp of a sum much
    larger than any one term, which a fixed atol set for F <= 20 does not
    cover."""
    rng = np.random.default_rng(16)
    g_, s, c, f, k = 1, 136, 8, 1600, 3
    l = rng.standard_normal((g_, s, s)).astype(np.float32)
    l = (l + l.transpose(0, 2, 1)) / (2 * np.sqrt(s))  # symmetric, spectrum O(1)
    x = rng.standard_normal((g_, s, c)).astype(np.float32)
    w = (rng.uniform(-1, 1, (k, c, f)) * np.sqrt(6.0 / (c + f))).astype(np.float32)
    b = rng.standard_normal(f).astype(np.float32)
    cot = rng.standard_normal((g_, s, f)).astype(np.float32)
    td = getattr(torch, dtype)
    _, vjp = jax.vjp(lambda x_, w_, b_: pallas_hodge.laguerre_dense_fused(
        jnp.asarray(l, dtype), x_, w_, b_), jnp.asarray(x, dtype), jnp.asarray(w), jnp.asarray(b))
    refs = vjp(jnp.asarray(cot, dtype))
    ours = lg.laguerre_dense_fused_bwd_plain(
        torch.from_numpy(l).to(td), torch.from_numpy(x).to(td), torch.from_numpy(w),
        torch.from_numpy(cot).to(td))
    assert ours[0].dtype == td and ours[1].dtype == ours[2].dtype == torch.float32
    for mine, ref in zip(ours, refs):
        mine, ref = mine.float().numpy(), np.asarray(ref, np.float32)
        assert mine.shape == ref.shape
        if dtype == "float32":
            np.testing.assert_allclose(mine, ref, rtol=2e-3, atol=1e-5)
        else:
            np.testing.assert_allclose(mine, ref, rtol=0, atol=2e-2 * np.abs(ref).max())


def test_fused_plain_matches_pallas_over_two_channel_tiles(rng):
    """C = 600: the JAX kernel splits the channels into two tiles and carries
    its accumulator across them; the port's kernel loops over its slices."""
    l, x, w, b = _kernel_inputs(rng, g=2, c=600, f=8, k=3)
    ours = lg.laguerre_dense_fused(*(torch.from_numpy(a) for a in (l, x, w, b)))
    ref = pallas_hodge.laguerre_dense_fused(*(jnp.asarray(a) for a in (l, x, w, b)))
    _close(ours, ref, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [2, 3, 6])
def test_terms_plain_matches_pallas(rng, dtype, k):
    l, x, _, _ = _kernel_inputs(rng, c=10, k=k)
    td = getattr(torch, dtype)
    ours = lg.laguerre_terms_dense(torch.from_numpy(l).to(td), torch.from_numpy(x).to(td), k)
    assert ours.dtype == td and ours.shape == (k, 3, 16, 10)
    ref = pallas_hodge.laguerre_terms_dense(jnp.asarray(l, dtype), jnp.asarray(x, dtype), k)
    _close(ours, ref, dtype)


def test_cpu_wrappers_run_plain_and_count_no_launch(rng, recorded):
    l, x, w, b = _kernel_inputs(rng)
    args = [torch.from_numpy(a) for a in (l, x, w, b)]
    torch.testing.assert_close(lg.laguerre_dense_fused(*args),
                               lg.laguerre_dense_fused_plain(*args), rtol=0, atol=0)
    torch.testing.assert_close(lg.laguerre_terms_dense(args[0], args[1], 4),
                               lg.laguerre_terms_dense_plain(args[0], args[1], 4), rtol=0, atol=0)
    assert recorded.launches() == {"laguerre_dense_fused": 0, "laguerre_terms_dense": 0,
                                   "laguerre_dense_fused_bwd": 0, "laguerre_terms_dense_bwd": 0}


@pytest.mark.parametrize("route", ["fused", "terms", "plain"])
@pytest.mark.parametrize("k", [1, 3])
def test_laguerre_conv_routes_match_jax(rng, route, k):
    l, x, w, b = _kernel_inputs(rng, c=6, f=5, k=k)
    prev = conv.use_fused_dense(), conv.use_terms_kernel()
    try:
        conv.use_fused_dense(route == "fused")
        conv.use_terms_kernel(route == "terms")
        m = conv.LaguerreConv(6, 5, k)
        m.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
        with torch.no_grad():
            ours = m(torch.from_numpy(x), torch.from_numpy(l))
    finally:
        conv.use_fused_dense(prev[0])
        conv.use_terms_kernel(prev[1])
    ref = jlaguerre_matvec(jnp.asarray(x), jnp.asarray(l), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(ours, ref, **F32)


@pytest.mark.parametrize("route", ["fused", "terms"])
def test_kernel_routes_at_256_rows_match_jax_default_route(rng, route, recorded):
    """On the CPU both kernel routes take S = 256 blocks (the wrappers' plain
    versions have no block limit; on the card such blocks go to the band
    kernels) and equal the JAX package's default conv route (plain XLA, Pallas
    kernels off) on the same inputs."""
    g, s, c, f, k = 2, 256, 6, 5, 4
    l = rng.standard_normal((g, s, s)).astype(np.float32)
    l = (l + l.transpose(0, 2, 1)) / (2 * np.sqrt(s))  # symmetric, spectrum O(1)
    x = rng.standard_normal((g, s, c)).astype(np.float32)
    w = rng.standard_normal((k, c, f)).astype(np.float32) * 0.1
    b = rng.standard_normal(f).astype(np.float32)
    prev = conv.use_fused_dense(), conv.use_terms_kernel()
    try:
        conv.use_fused_dense(route == "fused")
        conv.use_terms_kernel(route == "terms")
        ours = conv.laguerre_matvec(*(torch.from_numpy(a) for a in (x, l, w, b)))
    finally:
        conv.use_fused_dense(prev[0])
        conv.use_terms_kernel(prev[1])
    assert all(n == 0 for n in recorded.launches().values())  # CPU tensors: no launch
    assert not jconv.use_fused_dense() and not jconv.use_terms_kernel()  # the JAX default
    ref = jlaguerre_matvec(jnp.asarray(x), jnp.asarray(l), jnp.asarray(w), jnp.asarray(b))
    assert ours.shape == (g, s, f)
    np.testing.assert_allclose(ours, ref, **F32)


def test_laguerre_conv_init_is_seeded_glorot():
    a = conv.LaguerreConv(30, 34, 6, generator=torch.Generator().manual_seed(1))
    b = conv.LaguerreConv(30, 34, 6, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a.weight, b.weight, rtol=0, atol=0)
    assert a.weight.shape == (6, 30, 34)
    w = a.weight.detach()
    assert float(w.abs().max()) <= (6.0 / 64) ** 0.5
    assert float(w.std()) == pytest.approx((2.0 / 64) ** 0.5, rel=0.1)


def _random_stats(rng, tree):
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
                      else rng.uniform(-0.2, 0.2, a.shape)).astype(np.float32),
        tree,
    )


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_batchnorm_matches_jax(rng, train, masked):
    x = rng.standard_normal((4, 16, 6)).astype(np.float32) * 2 + 0.5
    mask = (rng.random((4, 16)) > 0.3).astype(np.float32) if masked else None
    jm = JMaskedBatchNorm(6)
    jmask = None if mask is None else jnp.asarray(mask)
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jnp.asarray(x), jmask,
                                         use_running_average=True))
    v["params"] = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
                   "offset": rng.standard_normal(6).astype(np.float32)}
    v["batch_stats"] = _random_stats(rng, v["batch_stats"])
    m = MaskedBatchNorm(6)
    m.load_state_dict(from_flax_variables(v))
    m.train(train)
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        ours = m(torch.from_numpy(x), tmask)
    if train:
        ref, upd = jm.apply(v, jnp.asarray(x), jmask, use_running_average=False,
                            mutable=["batch_stats"])
        np.testing.assert_allclose(m.running_mean, upd["batch_stats"]["mean"], **F32)
        np.testing.assert_allclose(m.running_var, upd["batch_stats"]["var"], **F32)
    else:
        ref = jm.apply(v, jnp.asarray(x), jmask, use_running_average=True)
    np.testing.assert_allclose(ours, ref, **F32)


@pytest.mark.parametrize("train", [False, True])
def test_node_edge_int_matches_jax(rng, train):
    samples = zinc_like_samples(np.random.default_rng(8), 10)
    tb = collate_dense_packed(samples, node_cap=64, edge_cap=64).to("cpu")
    jb = jax.tree.map(jnp.asarray, jcollate(samples, node_cap=64, edge_cap=64))
    g, s = tb.level0.l0.shape[:2]
    # virtual-concat stacks: two column pieces per operand
    pt = [rng.standard_normal((g, s, c)).astype(np.float32) for c in (8, 4)]
    ps = [rng.standard_normal((g, s, c)).astype(np.float32) for c in (8, 4)]
    deg = np.array(jb.levels[0].deg)  # deg_eps 0: the zinc quirk
    jm = JNodeEdgeInt(dv=6)
    jargs = (tuple(map(jnp.asarray, pt)), tuple(map(jnp.asarray, ps)),
             jb.levels[0], jnp.asarray(deg))
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(1), *jargs, deterministic=True))
    v["batch_stats"] = _random_stats(rng, v["batch_stats"])
    m = NodeEdgeInt(12, 12, 6)
    m.load_state_dict(from_flax_variables(v))
    m.train(train)
    with torch.no_grad():
        ours = m(tuple(map(torch.from_numpy, pt)), tuple(map(torch.from_numpy, ps)),
                 tb.level0, torch.from_numpy(deg))
    if train:
        ref, _ = jm.apply(v, *jargs, deterministic=False, mutable=["batch_stats"])
    else:
        ref = jm.apply(v, *jargs, deterministic=True)
    for a, r in zip(ours, ref):
        assert a.shape == (g, s, 6)
        np.testing.assert_allclose(a, r, rtol=1e-4, atol=1e-5)
