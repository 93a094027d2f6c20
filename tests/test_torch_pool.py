"""The pooled and gated family against the JAX package on the CPU.

MLGC pyramids and both multi-level collates (the same arrays), the pooling
step on both layouts, the gate-mode NodeEdgeInt and SAPool, the six presets'
forwards on the same parameters (``weights.from_flax_variables``) and one
pooled training step's gradients against ``jax.grad``.  Widths are narrow;
the inputs come from one numpy seed for both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hl_hgat_tpu.complex.build import collate as jcollate_flat
from hl_hgat_tpu.complex.dense import collate_dense_packed as jcollate_dense
from hl_hgat_tpu.data.synthetic import random_simplex_sample as jrandom_sample
from hl_hgat_tpu.models import presets as jpresets
from hl_hgat_tpu.nn.interaction import NodeEdgeInt as JNodeEdgeInt
from hl_hgat_tpu.nn.pool import SAPool as JSAPool
from hl_hgat_tpu.nn.pool import global_mean_pool as jglobal_mean_pool
from hl_hgat_tpu.ops.dispatch import pool_to_coarse as jpool_to_coarse
from hl_hgat_tpu.train.losses import focal_loss as jfocal_loss
from hl_hgat_tpu.train.losses import softmax_ce_loss as jce_loss
from hl_hgat_tpu_torch.complex.build import collate
from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
from hl_hgat_tpu_torch.data.synthetic import pooled_like_samples, random_simplex_sample
from hl_hgat_tpu_torch.models import presets
from hl_hgat_tpu_torch.nn.interaction import NodeEdgeInt
from hl_hgat_tpu_torch.nn.pool import SAPool, global_mean_pool
from hl_hgat_tpu_torch.ops.dispatch import pool_to_coarse
from hl_hgat_tpu_torch.train.losses import focal_loss, softmax_ce_loss
from hl_hgat_tpu_torch.weights import from_flax_variables, to_flax_paths

# float32: the same arithmetic in another summation order
F32 = dict(rtol=1e-5, atol=1e-5)
# whole-model forwards (the JAX tests' model tolerance)
MODEL_ATOL = 1e-4
# gradients: tests/test_reference_parity.py's model-level bounds
GRAD = dict(rtol=2e-3, atol=1e-5)
# bf16 forwards: both round at the same points and differ by accumulated
# bf16 ulps, relative to max|ref|
BF16_REL = 2e-2


def _pooled_samples(seed, count, num_pool=1, benchmark="cifar10sp"):
    """The same pooled samples from each package's generator."""
    ours = pooled_like_samples(np.random.default_rng(seed), count, benchmark=benchmark,
                               num_pool=num_pool)
    rng = np.random.default_rng(seed)
    theirs = []
    for _ in range(count):
        s = jrandom_sample(rng, n_nodes=int(rng.integers(20, 60)), node_feat=9, edge_feat=3,
                           keig=10, num_pool=num_pool, y_dim=10 if benchmark == "pepfunc" else 1)
        s.y = ((s.y > 0).astype(np.float32) if benchmark == "pepfunc"
               else np.asarray([int(abs(s.y[0]) * 7) % 10], np.float32))
        theirs.append(s)
    return ours, theirs


def _arrays(obj, prefix=""):
    """Every array leaf of a (nested) batch dataclass, by path."""
    if obj is None or isinstance(obj, (int, float, str)):
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
    return {prefix.rstrip("."): np.asarray(obj)}


@pytest.mark.parametrize("seed,num_pool", [(0, 1), (1, 2), (2, 3)])
def test_build_pyramid_matches_jax(seed, num_pool):
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(4):
        n, extra = int(rng_a.integers(10, 60)), int(rng_a.integers(0, 12))
        rng_b.integers(10, 60), rng_b.integers(0, 12)
        ours = random_simplex_sample(rng_a, n_nodes=n, extra_edges=extra, num_pool=num_pool)
        ref = jrandom_sample(rng_b, n_nodes=n, extra_edges=extra, num_pool=num_pool)
        assert len(ours.levels) == len(ref.levels) == num_pool + 1
        for (cn, ce), (rcn, rce) in zip(ours.pools, ref.pools):
            np.testing.assert_array_equal(cn, rcn)
            np.testing.assert_array_equal(ce, rce)
        for a, b in zip(ours.levels, ref.levels):
            for f in ("src", "dst", "l0_rows", "l0_cols", "l1_rows", "l1_cols"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
            np.testing.assert_array_equal(a.l0_vals, b.l0_vals)
            np.testing.assert_array_equal(a.l1_vals, b.l1_vals)


@pytest.mark.parametrize("layout", ["flat", "dense", "dense_edge_cap_256"])
def test_multilevel_collate_matches_jax(layout):
    ours, theirs = _pooled_samples(3, 12, num_pool=2)
    if layout == "flat":
        got, ref = collate(ours, with_ell=True), jcollate_flat(theirs, with_ell=True)
    else:
        cap = 256 if layout.endswith("256") else 128
        got = collate_dense_packed(ours, node_cap=128, edge_cap=cap)
        ref = jcollate_dense(theirs, node_cap=128, edge_cap=cap)
        if cap == 256:
            assert got.x_s.shape[1] == 256
    a, b = _arrays(got), _arrays(ref)
    a.pop("num_graphs", None)
    assert len(got.levels) == 3 and len(got.pools) == 2
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    # every dense-only JAX field the port leaves out is empty (no spill)
    for key in set(b) - set(a):
        assert b[key] is None or b[key].dtype == object, key


@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_pool_to_coarse_matches_jax(layout):
    ours, theirs = _pooled_samples(4, 10)
    rng = np.random.default_rng(5)
    if layout == "flat":
        got_b, ref_b = collate(ours), jcollate_flat(theirs)
    else:
        got_b = collate_dense_packed(ours, edge_cap=256)
        ref_b = jcollate_dense(theirs, edge_cap=256)
    x_t = rng.standard_normal(got_b.x_t.shape[:-1] + (6,)).astype(np.float32)
    x_s = rng.standard_normal(got_b.x_s.shape[:-1] + (5,)).astype(np.float32)
    got_b = got_b.to("cpu")
    ref_b = jax.tree.map(jnp.asarray, ref_b)
    got = pool_to_coarse(got_b.pools[0], got_b.levels[0], got_b.levels[1],
                         torch.from_numpy(x_t), torch.from_numpy(x_s))
    ref = jpool_to_coarse(ref_b.pools[0], ref_b.levels[0], ref_b.levels[1],
                          jnp.asarray(x_t), jnp.asarray(x_s))
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        assert float(np.abs(np.asarray(r)).max()) > 0
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **F32)


def _gate_setup(layout, seed=6):
    ours, theirs = _pooled_samples(seed, 6)
    if layout == "flat":
        got_b, ref_b = collate(ours).to("cpu"), jax.tree.map(jnp.asarray, jcollate_flat(theirs))
    else:
        got_b = collate_dense_packed(ours, edge_cap=256).to("cpu")
        ref_b = jax.tree.map(jnp.asarray, jcollate_dense(theirs, edge_cap=256))
    rng = np.random.default_rng(seed)
    x_t = rng.standard_normal(got_b.x_t.shape[:-1] + (12,)).astype(np.float32)
    x_s = rng.standard_normal(got_b.x_s.shape[:-1] + (10,)).astype(np.float32)
    return got_b, ref_b, x_t, x_s


@pytest.mark.parametrize("sigma", ["sigmoid", "relu"])
@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_gate_mode_node_edge_int_matches_jax(layout, sigma):
    got_b, ref_b, x_t, x_s = _gate_setup(layout)
    jmod = JNodeEdgeInt(dk=8, only_att=True, sigma=sigma, lam=0.7)
    lvl = ref_b.levels[0]
    deg = lvl.deg + 1e-6
    v = jmod.init(jax.random.key(1), jnp.asarray(x_t), jnp.asarray(x_s), lvl, deg, True)
    ref = jmod.apply(v, jnp.asarray(x_t), jnp.asarray(x_s), lvl, deg, True)
    mod = NodeEdgeInt(12, 10, only_att=True, dk=8, sigma=sigma, lam=0.7)
    mod.load_state_dict(from_flax_variables(jax.tree.map(np.asarray, v)))
    lvl_t = got_b.levels[0]
    got = mod(torch.from_numpy(x_t), torch.from_numpy(x_s), lvl_t, lvl_t.deg + 1e-6)
    for a, r in zip(got, ref):
        assert a.dtype == torch.float32 and a.shape == r.shape and a.shape[-1] == 1
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), **F32)


@pytest.mark.parametrize("max_normalize", [False, True])
@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_sapool_matches_jax(layout, max_normalize):
    got_b, ref_b, x_t, x_s = _gate_setup(layout, seed=7)
    jmod = JSAPool(dk=8, sigma="relu", lam=0.5, max_normalize=max_normalize)
    args = (ref_b.pools[0], ref_b.levels[0], ref_b.levels[1], ref_b.levels[0].deg)
    v = jmod.init(jax.random.key(2), jnp.asarray(x_t), jnp.asarray(x_s), *args)
    ref = jmod.apply(v, jnp.asarray(x_t), jnp.asarray(x_s), *args)
    mod = SAPool(12, 10, dk=8, sigma="relu", lam=0.5, max_normalize=max_normalize)
    mod.load_state_dict(from_flax_variables(jax.tree.map(np.asarray, v)))
    got = mod(torch.from_numpy(x_t), torch.from_numpy(x_s), got_b.pools[0],
              got_b.levels[0], got_b.levels[1], got_b.levels[0].deg)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), **F32)


def test_global_mean_pool_matches_jax():
    """Per-graph means over the valid rows of a flat pooled batch's coarse
    level (padding rows carry the dump id and weigh 0)."""
    ours, theirs = _pooled_samples(8, 6)
    lvl, jlvl = collate(ours).levels[1], jcollate_flat(theirs).levels[1]
    x = np.random.default_rng(8).standard_normal((lvl.num_nodes, 7)).astype(np.float32)
    got = global_mean_pool(torch.from_numpy(x), torch.as_tensor(lvl.n_id), 6,
                           torch.as_tensor(lvl.node_mask))
    ref = jglobal_mean_pool(jnp.asarray(x), jnp.asarray(jlvl.n_id), 6, jnp.asarray(jlvl.node_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


# narrow versions of the six presets: two blocks, small widths
NARROW = {
    "zinc_attpool": dict(channels=(1, 1), filters=(8, 16)),
    "zinc_poolint3_pyr": dict(channels=(2, 1), filters=(8, 16)),
    "pepfunc_pyr": dict(channels=(1, 1), filters=(8, 16)),
    "pepfunc_attpool": dict(channels=(1, 1), filters=(8, 16), k=3, mlp_channels=(16,),
                            pool_loc=0),
    "cifar10sp_pyr": dict(channels=(1, 1), filters=(8, 16)),
    "cifar10sp_attpool": dict(channels=(1, 1), filters=(8, 16), k=3, mlp_channels=(16,)),
}


def _random_stats(rng, tree):
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
                      else rng.uniform(0.0, 0.1, a.shape)).astype(np.float32),
        tree,
    )


def _preset_pair(name, jbatch, **kw):
    """The JAX preset's variables (random positive BN statistics) and the
    port's preset carrying them."""
    jmodel, jmeta = getattr(jpresets, name)(**NARROW[name])
    if kw:
        jmodel = dataclasses.replace(jmodel, cfg=dataclasses.replace(jmodel.cfg, **kw))
    v = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.key(0)}, jbatch, deterministic=True))
    v["batch_stats"] = _random_stats(np.random.default_rng(8), v["batch_stats"])
    model, meta = getattr(presets, name)(**NARROW[name], device="cpu", in_t=18, in_s=12, **kw)
    model.load_state_dict(from_flax_variables(v))
    assert meta == jmeta
    return jmodel, v, model


@pytest.fixture(scope="module")
def pooled_batches():
    ours, theirs = _pooled_samples(9, 10)
    return {
        "dense": (collate_dense_packed(ours, edge_cap=256).to("cpu"),
                  jax.tree.map(jnp.asarray, jcollate_dense(theirs, edge_cap=256))),
        "flat": (collate(ours).to("cpu"), jax.tree.map(jnp.asarray, jcollate_flat(theirs))),
    }


@pytest.mark.parametrize("layout", ["dense", "flat"])
@pytest.mark.parametrize("name", list(NARROW))
def test_pooled_presets_forward_match_jax(pooled_batches, name, layout):
    batch, jbatch = pooled_batches[layout]
    jmodel, v, model = _preset_pair(name, jbatch)
    ref = np.asarray(jmodel.apply(v, jbatch, deterministic=True))
    with torch.inference_mode():
        out = model.eval()(batch)
    assert out.shape == ref.shape == (10, 10 if "zinc" not in name else 1)
    assert float(np.std(ref)) > 1e-4
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=MODEL_ATOL)


@pytest.mark.parametrize("name", ["cifar10sp_attpool", "pepfunc_attpool"])
def test_pooled_bf16_forward_tracks_jax_bf16(pooled_batches, name):
    """bf16 compute: the gates stay float32 while the gated multiply runs
    in bf16, in both packages."""
    batch, jbatch = pooled_batches["dense"]
    jmodel, v, model = _preset_pair(name, jbatch, compute_dtype="bfloat16")
    ref = np.asarray(jmodel.apply(v, jbatch, deterministic=True))
    gates = []
    for name, mod in model.backbone.named_children():
        if name.startswith("NEAtt"):
            mod.register_forward_hook(lambda m, a, out: gates.extend(out))
    with torch.inference_mode():
        out = model.eval()(batch).numpy()
    assert gates and all(a.dtype == torch.float32 for a in gates)
    np.testing.assert_allclose(out, ref, rtol=0, atol=BF16_REL * np.abs(ref).max())


@pytest.mark.parametrize("name", ["cifar10sp_attpool", "pepfunc_attpool"])
@pytest.mark.parametrize("layout", ["dense", "flat"])
def test_pooled_training_step_gradients_match_jax(pooled_batches, layout, name):
    """One pooled model (no dropout) in train mode, BN on batch statistics:
    the loss and every parameter gradient.  cifar10sp_attpool gates the
    last outputs, which the pool never reads, so its gate parameters get no
    gradient (zero in JAX, none in torch); pepfunc_attpool gates the stacks
    the pool moves; its gates after the last block move stacks that the
    readout never reads (no gradient either).  Losses: cross-entropy and
    the focal loss of the trainer's classification and multilabel tasks,
    the focal loss without its constant 1e4 factor, so that the bounds
    mean what they mean for the other losses."""
    batch, jbatch = pooled_batches[layout]
    jmodel, v, model = _preset_pair(name, jbatch, dropout=0.0)
    if name == "cifar10sp_attpool":
        jloss = lambda out: jce_loss(out, jbatch.y.reshape(-1).astype(jnp.int32))  # noqa: E731
        loss_of = lambda out: softmax_ce_loss(out, batch.y.reshape(-1).long())  # noqa: E731
    else:
        jloss = lambda out: jfocal_loss(out, jbatch.y, scale=1.0)  # noqa: E731
        loss_of = lambda out: focal_loss(out, batch.y, scale=1.0)  # noqa: E731

    def loss_fn(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": v["batch_stats"]}, jbatch,
                              deterministic=False, mutable=["batch_stats"])
        return jloss(out)

    ref_loss, grads = jax.value_and_grad(loss_fn)(v["params"])
    ref = {tuple(p.key for p in path): np.asarray(leaf)
           for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    model.train()
    loss = loss_of(model(batch))
    loss.backward()
    got = to_flax_paths(model, {n: torch.zeros_like(p) if p.grad is None else p.grad
                                for n, p in model.named_parameters()})
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    assert set(got) == set(ref)
    gate_paths = [p for p in ref if p[1].startswith("NEAtt")]
    assert gate_paths
    live = any(np.abs(ref[p]).max() > 0 for p in gate_paths)
    assert live == (name == "pepfunc_attpool")
    for path in sorted(ref):
        np.testing.assert_allclose(got[path], ref[path], err_msg="/".join(path), **GRAD)
