"""The port's zinc_pyr forward vs the JAX model on the same weights (CPU).

Weights come from the JAX ``model.init`` with random positive batch
statistics, carried over by ``weights.from_flax_variables``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hl_hgat_tpu.complex.dense import collate_dense_packed as jcollate
from hl_hgat_tpu.models import presets as jpresets
from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
from hl_hgat_tpu_torch.data.synthetic import zinc_like_samples
from hl_hgat_tpu_torch.models import presets
from hl_hgat_tpu_torch.nn import conv
from hl_hgat_tpu_torch.weights import from_flax_variables

SMALL = dict(channels=(1, 2), filters=(16, 32), k=3, keig=15, mlp_channels=(16,))


def _random_stats(rng, tree):
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
                      else rng.uniform(0.0, 0.1, a.shape)).astype(np.float32),
        tree,
    )


@pytest.fixture(scope="module")
def setup():
    samples = zinc_like_samples(np.random.default_rng(11), 14)
    batch = collate_dense_packed(samples)
    assert 2 <= batch.x_t.shape[0] <= 3  # 2-3 packed blocks of S=128
    jbatch = jax.tree.map(jnp.asarray, jcollate(samples))
    jmodel, _ = jpresets.zinc_pyr(**SMALL)
    v = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.key(0)}, jbatch, deterministic=True))
    v["batch_stats"] = _random_stats(np.random.default_rng(12), v["batch_stats"])
    ref, extras = jmodel.apply(v, jbatch, deterministic=True, return_latent=True)
    return batch, jbatch, jmodel, v, np.asarray(ref), np.asarray(extras["latent"])


def _port_model(v, **kw):
    model, meta = presets.zinc_pyr(**SMALL, device="cpu", **kw)
    model.load_state_dict(from_flax_variables(v))
    assert meta["task"] == "regression"
    return model.eval()


@pytest.mark.parametrize("route", ["fused", "terms", "plain"])
def test_zinc_pyr_forward_matches_jax(setup, route):
    batch, _, _, v, ref, latent = setup
    model = _port_model(v)
    pooled = []  # the readout [edges ‖ nodes] the MLP head receives
    model.head.register_forward_hook(lambda m, args, out: pooled.append(args[0]))
    prev = conv.use_fused_dense(), conv.use_terms_kernel()
    try:
        conv.use_fused_dense(route == "fused")
        conv.use_terms_kernel(route == "terms")
        with torch.inference_mode():
            out = model(batch.to("cpu"))
    finally:
        conv.use_fused_dense(prev[0])
        conv.use_terms_kernel(prev[1])
    assert out.shape == (14, 1) and out.dtype == torch.float32
    assert float(np.std(ref)) > 1e-4  # outputs differ across graphs
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)
    assert pooled[0].shape == latent.shape == (14, 64)
    np.testing.assert_allclose(pooled[0].numpy(), latent, rtol=0,
                               atol=1e-4 * np.abs(latent).max())


def test_zinc_pyr_bf16_forward_tracks_jax_bf16(setup):
    """bf16 compute: both packages round at the same points; they differ by
    accumulated bf16 ulps, not by algorithm."""
    batch, jbatch, jmodel, v, _, _ = setup
    import dataclasses

    jm16 = dataclasses.replace(
        jmodel, cfg=dataclasses.replace(jmodel.cfg, compute_dtype="bfloat16"))
    ref = np.asarray(jm16.apply(v, jbatch, deterministic=True))
    model = _port_model(v, compute_dtype="bfloat16")
    with torch.inference_mode():
        out = model(batch.to("cpu")).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2 * np.abs(ref).max())


@pytest.mark.parametrize("use_embedding", [True, False])
def test_full_width_zinc_pyr_matches_jax_parameter_tree(use_embedding):
    samples = zinc_like_samples(np.random.default_rng(13), 6)
    jbatch = jax.tree.map(jnp.asarray, jcollate(samples))
    jmodel, _ = jpresets.zinc_pyr(use_embedding=use_embedding)
    shapes = jax.eval_shape(
        lambda b: jmodel.init({"params": jax.random.key(0)}, b, deterministic=True),
        jbatch)
    expect = from_flax_variables(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    model, _ = presets.zinc_pyr(use_embedding=use_embedding, device="cpu")
    got = model.state_dict()
    assert set(got) == set(expect)
    for name, t in expect.items():
        assert got[name].shape == t.shape, name
    # 18 Laguerre convs: 2 init (K=1 with the embedding) + 16 in the blocks
    ks = sorted(int(t.shape[0]) for n, t in got.items() if n.endswith("conv.weight"))
    assert ks == ([1, 1] if use_embedding else [6, 6]) + [6] * 16


def test_seeded_init_is_reproducible():
    a, _ = presets.zinc_pyr(**SMALL, device="cpu", seed=3)
    b, _ = presets.zinc_pyr(**SMALL, device="cpu", seed=3)
    c, _ = presets.zinc_pyr(**SMALL, device="cpu", seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    for name in sa:
        torch.testing.assert_close(sa[name], sb[name], rtol=0, atol=0)
    w = "backbone.NEConv10.node.conv.weight"
    assert not torch.equal(sa[w], sc[w])
