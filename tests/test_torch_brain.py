"""The port's brain family against the JAX package on the CPU: the brain
options of MLGC and the brain pyramid, ``fc2mask``, ``brain_sample`` and
``BrainLoader``, ``collate_dense_shared``, the shared-operator conv route
(the terms of the folded features) against the JAX broadcast einsum,
``Inception1D``, ``HLHGCNNAbcd`` and ``HLHGATAttpool`` on the flat and the
shared layouts with BN on running and on batch statistics, one gradient
of ``hgat_attpool`` against ``jax.grad``, the DEMO recurrence, ``ChebConv``,
``HLFilter``, ``BrainPredictor`` and the brain trainer task.

Inputs are seeded with numpy; parameters cross from flax with
``weights.from_flax_variables``.  Tolerance: 1e-5 relative to max|ref| in
float32 unless a test states another, with its reason.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hl_hgat_tpu.complex import coarsen as jcoarsen
from hl_hgat_tpu.complex.build import build_structure as jbuild_structure
from hl_hgat_tpu.complex.build import collate as jcollate
from hl_hgat_tpu.complex.dense import collate_dense_shared as jshared
from hl_hgat_tpu.data import brain as jbrain
from hl_hgat_tpu.data import datasets as jdatasets
from hl_hgat_tpu.data.synthetic import synthetic_brain_batch, synthetic_fmri_series as jfmri
from hl_hgat_tpu.models import presets as jpresets
from hl_hgat_tpu.nn import blocks as jblocks
from hl_hgat_tpu.nn import conv as jconv
from hl_hgat_tpu.nn.inception import Inception1D as JInception1D
from hl_hgat_tpu.serving import BrainPredictor as JBrainPredictor
from hl_hgat_tpu.train.trainer import Trainer as JTrainer
from hl_hgat_tpu.train.trainer import TrainerConfig as JTrainerConfig
from hl_hgat_tpu.train.trainer import TrainState
from hl_hgat_tpu_torch.complex import coarsen
from hl_hgat_tpu_torch.complex.build import build_complex, build_structure, collate
from hl_hgat_tpu_torch.complex.dense import collate_dense_shared
from hl_hgat_tpu_torch.data import brain, datasets
from hl_hgat_tpu_torch.data.synthetic import synthetic_brain_samples, synthetic_fmri_series
from hl_hgat_tpu_torch.models import presets
from hl_hgat_tpu_torch.nn import conv
from hl_hgat_tpu_torch.nn.blocks import HLFilter
from hl_hgat_tpu_torch.nn.inception import Inception1D
from hl_hgat_tpu_torch.ops.laguerre_dense import _band_operator, laguerre_terms_dense_plain
from hl_hgat_tpu_torch.serving import BrainPredictor
from hl_hgat_tpu_torch.train import Trainer, TrainerConfig, mse_loss
from hl_hgat_tpu_torch.weights import from_flax_variables, to_flax_paths

RTOL = 1e-5


def _close(got, ref, rtol=RTOL, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30) if ref.size else 1.0
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= rtol * scale, f"{what}: max|err| {err:.3e} > {rtol}·{scale:.3e}"


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _perturbed(module, seed):
    """``module`` with every parameter and BN statistic moved off its init
    (seeded), so eval mode reads statistics that are not 0 and 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            if t.is_floating_point():
                step = 0.1 * torch.randn(t.shape, generator=gen)
                t.copy_(t.abs() + 0.5 + step.abs() if name.endswith("running_var") else t + step)
    return module


def _flax_variables(module):
    """The port module's tensors as flax variables (the inverse of
    ``from_flax_variables``): building the JAX model's tree this way skips
    its traced init."""
    out = {"params": {}, "batch_stats": {}}
    for path, arr in to_flax_paths(module, module.state_dict()).items():
        node = out["batch_stats" if path[-1] in ("mean", "var") else "params"]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.asarray(arr)
    return out


def _jit_apply(jmodel):
    return jax.jit(jmodel.apply, static_argnames=("deterministic", "mutable"))


def _skeleton(rng, n=30, extra=60):
    """A canonical (src < dst, row-major) connected skeleton with weights."""
    pairs = {(i, i + 1) for i in range(n - 1)}
    for a, b in rng.integers(0, n, (extra, 2)):
        if a != b:
            pairs.add((int(min(a, b)), int(max(a, b))))
    arr = np.array(sorted(pairs), np.int64)
    return arr[:, 0], arr[:, 1], rng.uniform(0.05, 1.0, arr.shape[0])


# ---------------------------------------------------------------------------
# MLGC brain options and the brain pyramid: exact
# ---------------------------------------------------------------------------

_MLGC_CASES = {
    "weighted": dict(weighted=True),
    "pruned": dict(weighted=True, prune_single_fine_edges=True, drop_isolated_nodes=True),
    "visit_directed": dict(weighted=False, visit=True, directed_match=True),
    "brain": dict(weighted=True, x_s=True, prune_single_fine_edges=True,
                  drop_isolated_nodes=True, visit=True, directed_match=True),
}


@pytest.mark.parametrize("case", list(_MLGC_CASES))
def test_brain_mlgc_options_match_jax(case):
    opts = dict(_MLGC_CASES[case])
    rng = np.random.default_rng(3)
    src, dst, w = _skeleton(rng)
    kw = {}
    if opts.pop("weighted"):
        kw["edge_weight"] = w
    if opts.pop("x_s", False):
        kw["x_s"] = np.stack([w, 2 * w], axis=1)
    if opts.pop("visit", False):
        kw["visit"] = rng.permutation(30)
    kw.update(opts)
    ours = coarsen.mlgc(build_structure(src.astype(np.int32), dst.astype(np.int32), 30), **kw)
    ref = jcoarsen.mlgc(jbuild_structure(src.astype(np.int32), dst.astype(np.int32), 30), **kw)
    np.testing.assert_array_equal(ours.c_node, ref.c_node)
    np.testing.assert_array_equal(ours.c_edge, ref.c_edge)
    np.testing.assert_array_equal(ours.structure.src, ref.structure.src)
    np.testing.assert_array_equal(ours.structure.dst, ref.structure.dst)
    assert ours.structure.num_nodes == ref.structure.num_nodes
    if "x_s" in kw:
        np.testing.assert_array_equal(ours.x_s_pool, ref.x_s_pool)
    else:
        assert ours.x_s_pool is None and ref.x_s_pool is None


def test_brain_pyramid_matches_the_jax_loop_under_torch_seed():
    """The port draws its visit orders from a ``torch.Generator`` seeded with
    10086; the JAX package seeds torch's global generator, as the notebook
    does.  Both must give the same pyramid."""
    rng = np.random.default_rng(4)
    src, dst, w = _skeleton(rng, n=40, extra=120)
    levels, pools = brain.brain_pyramid(src, dst, w, pool_num=2, seed=10086)
    jlevels = [jbuild_structure(src.astype(np.int32), dst.astype(np.int32), 40)]
    torch.manual_seed(10086)
    weight = w
    for k in range(2):
        lvl = jcoarsen.mlgc(jlevels[-1], edge_weight=weight, x_s=weight.reshape(-1, 1),
                            prune_single_fine_edges=True, drop_isolated_nodes=True,
                            visit=torch.randperm(jlevels[-1].num_nodes).numpy(),
                            directed_match=True)
        jlevels.append(lvl.structure)
        np.testing.assert_array_equal(pools[k][0], lvl.c_node)
        np.testing.assert_array_equal(pools[k][1], lvl.c_edge)
        weight = lvl.x_s_pool.reshape(-1)
    for a, b in zip(levels, jlevels):
        np.testing.assert_array_equal(a.src, b.src)
        np.testing.assert_array_equal(a.dst, b.dst)
        _close(a.l1_vals, b.l1_vals, what="L1 values")


# ---------------------------------------------------------------------------
# fc2mask, brain_sample, BrainLoader, synthetic series: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_fc2mask_matches_jax(mode):
    rng = np.random.default_rng(5)
    fcs = np.stack([np.corrcoef(rng.standard_normal((24, 40))) for _ in range(5)])
    np.testing.assert_array_equal(datasets.fc2mask(fcs, percent=0.2, mode=mode),
                                  jdatasets.fc2mask(fcs, percent=0.2, mode=mode))
    with pytest.raises(ValueError):
        datasets.fc2mask(fcs, percent=0.0, mode=mode)


def _brain_structure(num_pool=2, n=24):
    rng = np.random.default_rng(6)
    src, dst, w = _skeleton(rng, n=n, extra=50)
    levels, pools = brain.brain_pyramid(src, dst, w, pool_num=num_pool)
    return levels, pools


def test_brain_sample_and_synthetic_series_match_jax():
    levels, pools = _brain_structure()
    series, scores = synthetic_fmri_series(np.random.default_rng(7), 3, 24, 50)
    jseries, jscores = jfmri(np.random.default_rng(7), 3, 24, 50)
    np.testing.assert_array_equal(series, jseries)
    np.testing.assert_array_equal(scores, jscores)
    src, dst = levels[0].src, levels[0].dst
    for crop in (None, 32):
        ours = datasets.brain_sample(series[1], src, dst, levels, pools, y=scores[1],
                                     crop_len=crop, rng=np.random.default_rng(8))
        ref = jdatasets.brain_sample(series[1], src, dst, levels, pools, y=scores[1],
                                     crop_len=crop, rng=np.random.default_rng(8))
        for name in ("x_t", "x_s", "y"):
            np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
        assert ours.levels == list(levels) and ours.pools == list(pools)


def test_brain_loader_batches_match_jax():
    levels, pools = _brain_structure()
    series, scores = synthetic_fmri_series(np.random.default_rng(9), 7, 24, 40)
    ts = [series[i][:, : 36 + i] for i in range(7)]
    kw = dict(batch_size=3, crop_len=32, seed=1)
    ours = brain.BrainLoader(ts, scores, levels, pools, **kw)
    ref = jbrain.BrainLoader(ts, scores, levels, pools, **kw)
    assert len(ours) == len(ref) == 2
    for _ in range(2):  # two epochs: the crops re-roll in both
        for a, b in zip(ours, ref, strict=True):
            _assert_dense_equal(a, b)


def test_synthetic_brain_samples_are_synthetic_brain_batch():
    samples = synthetic_brain_samples(3, seed=2, n_rois=32, num_pool=2)
    ref, n_final, e_final = synthetic_brain_batch(3, seed=2, n_rois=32, num_pool=2)
    ours = collate(samples, multiple=1)
    np.testing.assert_array_equal(ours.x_t, np.asarray(ref.x_t))
    np.testing.assert_array_equal(ours.x_s, np.asarray(ref.x_s))
    np.testing.assert_array_equal(ours.y, np.asarray(ref.y))
    assert (samples[0].levels[-1].num_nodes, samples[0].levels[-1].num_edges) == (
        n_final, e_final)


# ---------------------------------------------------------------------------
# collate_dense_shared: array by array, exact; its three refusals
# ---------------------------------------------------------------------------


def _assert_dense_equal(ours, ref):
    np.testing.assert_array_equal(ours.x_t, ref.x_t)
    np.testing.assert_array_equal(ours.x_s, ref.x_s)
    np.testing.assert_array_equal(ours.y, ref.y)
    assert ours.num_graphs == ref.num_graphs
    assert len(ours.levels) == len(ref.levels) and len(ours.pools) == len(ref.pools)
    for a, b in zip(ours.levels, ref.levels):
        for name in ("l0", "l1", "b1", "node_mask", "edge_mask", "deg"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
        assert a.n_gid is None and a.s_gid is None and b.n_gid is None
    for a, b in zip(ours.pools, ref.pools):
        np.testing.assert_array_equal(a.p_t, b.p_t)
        np.testing.assert_array_equal(a.p_s, b.p_s)


@pytest.mark.parametrize("num_pool", [1, 2])
def test_collate_dense_shared_matches_jax(num_pool):
    """At the one padding the port builds: none (JAX's ``multiple=1``)."""
    samples = synthetic_brain_samples(3, seed=1, n_rois=32, num_pool=num_pool)
    ours = collate_dense_shared(samples)
    _assert_dense_equal(ours, jshared(samples, multiple=1))
    lvl = ours.levels[0]
    assert lvl.l0.shape[0] == lvl.l1.shape[0] == lvl.b1.shape[0] == 1
    assert ours.x_t.shape[0] == 3 and ours.pools[0].p_t.shape[0] == 1


@pytest.mark.parametrize("what", ["structure", "values", "pools"])
def test_collate_dense_shared_refuses_differing_samples(what):
    samples = synthetic_brain_samples(2, seed=1, n_rois=32, num_pool=1)
    other = samples[1]
    lvl = other.levels[0]
    if what == "structure":
        lvl = dataclasses.replace(lvl, dst=lvl.dst.copy())
        lvl.dst[-1] = (lvl.dst[-1] + 1) % lvl.num_nodes
        other = dataclasses.replace(other, levels=[lvl] + other.levels[1:])
    elif what == "values":
        lvl = dataclasses.replace(lvl, l1_vals=lvl.l1_vals * 2)
        other = dataclasses.replace(other, levels=[lvl] + other.levels[1:])
    else:
        c_node, c_edge = other.pools[0]
        other = dataclasses.replace(other, pools=[(c_node[::-1].copy(), c_edge)])
    with pytest.raises(ValueError, match="identical"):
        collate_dense_shared([samples[0], other])


# ---------------------------------------------------------------------------
# the shared-operator conv route
# ---------------------------------------------------------------------------


def _shared_inputs(k, c=5, f=6, g=3):
    sample = synthetic_brain_samples(1, seed=1, n_rois=32, num_pool=0)[0]
    lap = collate_dense_shared([sample]).levels[0].l1
    rng = np.random.default_rng(10 + k)
    s = lap.shape[1]
    x = rng.standard_normal((g, s, c)).astype(np.float32)
    w = (rng.uniform(-1, 1, (k, c, f)) * np.sqrt(6.0 / (c + f))).astype(np.float32)
    b = rng.standard_normal(f).astype(np.float32)
    return lap, x, w, b


@pytest.mark.parametrize("k", [1, 2, 4])
def test_shared_operator_route_matches_jax_broadcast(k):
    """On the kernel routes a [1, S, S] operator with [G, S, C] features takes
    the terms of the folded [1, S, G·C] features (the plain version of the
    terms kernel here): output and gradients against the JAX package's
    broadcast einsum recurrence and ``jax.grad``."""
    lap, x, w, b = _shared_inputs(k)
    cot = np.random.default_rng(0).standard_normal((x.shape[0], x.shape[1], w.shape[2]))

    def jloss(x, w, b):
        out = jconv.laguerre_matvec(x, jnp.asarray(lap), w, b)
        return jnp.sum(out * cot), out

    (_, ref), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    for route in ((True, False), (False, True)):
        conv.use_fused_dense(route[0])
        conv.use_terms_kernel(route[1])
        try:
            xs, ws, bs = (_t(a).requires_grad_() for a in (x, w, b))
            out = conv.laguerre_matvec(xs, _t(lap), ws, bs)
            (out * _t(cot).float()).sum().backward()
        finally:
            conv.use_fused_dense(True)
            conv.use_terms_kernel(False)
        _close(out.detach(), ref, what="out")
        for got, want, name in zip((xs, ws, bs), grads, "xwb"):
            _close(got.grad, want, what=f"d{name}")


def test_folded_terms_are_the_per_graph_terms():
    lap, x, _, _ = _shared_inputs(4)
    got = conv.folded_terms(_t(lap), _t(x), 4)
    want = laguerre_terms_dense_plain(_t(lap).expand(3, -1, -1), _t(x), 4)
    _close(got, want, what="terms")
    assert conv.is_shared(_t(lap), _t(x)) and not conv.is_shared(_t(lap), _t(x[:1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [136, 137, 1001])
def test_band_operator_rows_start_on_16_bytes(dtype, s):
    """The band kernels' L (odd S as the Shen-268 level-0 L1's 8997): rows
    whose bytes are not a multiple of 16 are copied into rows padded to 16
    bytes, the first S columns equal to L; other rows stay as they are."""
    g = 2
    lap = torch.arange(g * s * s, dtype=torch.float32).reshape(g, s, s)
    got, ld = _band_operator(lap, dtype)
    per = 16 // got.element_size()
    assert ld % per == 0 and s <= ld < s + per and got.shape == (g, s, ld)
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got[..., :s], lap.to(dtype))
    if s % per == 0:
        assert ld == s

def test_shared_route_bfloat16_matches_jax():
    """bfloat16: the same rounding points in both packages; sums of up to S
    products in another order may round one bf16 ulp apart, so 2e-2 of
    max|ref| (the kernels' bf16 bound)."""
    lap, x, w, b = _shared_inputs(3)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jconv.laguerre_matvec(xb, jnp.asarray(lap).astype(jnp.bfloat16), jnp.asarray(w),
                                jnp.asarray(b))
    out = conv.laguerre_matvec(_t(x).bfloat16(), _t(lap).bfloat16(), _t(w), _t(b))
    assert out.dtype == torch.bfloat16
    _close(out.float(), np.asarray(ref.astype(jnp.float32)), rtol=2e-2, what="bf16")


@pytest.mark.parametrize("layout", ["dense", "shared"])
def test_demo_recurrence_matches_jax(layout):
    """The DEMO recurrence takes the plain route whatever the route flags."""
    lap, x, w, b = _shared_inputs(4)
    if layout == "dense":
        lap = np.repeat(lap, x.shape[0], axis=0)
    ref = jconv.laguerre_matvec(jnp.asarray(x), jnp.asarray(lap), jnp.asarray(w),
                                jnp.asarray(b), demo_compat=True)
    out = conv.laguerre_matvec(_t(x), _t(lap), _t(w), _t(b), demo_compat=True)
    _close(out, ref, what="demo")
    canonical = conv.laguerre_matvec(_t(x), _t(lap), _t(w), _t(b))
    assert not torch.allclose(out, canonical)


def test_chebconv_matches_jax():
    lap, x, w, b = _shared_inputs(4)
    mod = conv.ChebConv(5, 6, 4)
    mod.load_state_dict({"weight": _t(w), "bias": _t(b)})
    ref = jconv.ChebConv(6, 4).apply({"params": {"weights": jnp.asarray(w),
                                                 "bias": jnp.asarray(b)}},
                                     jnp.asarray(x), jnp.asarray(lap))
    with torch.no_grad():
        _close(mod(_t(x), _t(lap)), ref, what="cheb")


@pytest.mark.parametrize("if_dense", [True, False])
def test_hlfilter_matches_jax(if_dense):
    """Train-mode BN on a flat level; the running statistics too."""
    rng = np.random.default_rng(11)
    src, dst, _ = _skeleton(rng, n=14, extra=20)
    sample = build_complex(np.stack([src, dst]), 14,
                           x_t=rng.standard_normal((14, 6)), x_s=rng.standard_normal((len(src), 5)))
    level = collate([sample], multiple=1).to("cpu").level0
    jlevel = jax.tree.map(jnp.asarray, jcollate([sample], multiple=1)).level0
    deg = (level.deg + 1e-6).numpy()
    jmod = jblocks.HLFilter(channels=2, filters=8, k=3, if_dense=if_dense)
    args = (jnp.asarray(sample.x_t), jnp.asarray(sample.x_s), jlevel, jnp.asarray(deg))
    mod = _perturbed(HLFilter(6, 5, channels=2, filters=8, k=3, if_dense=if_dense), 3)
    v = _flax_variables(mod)
    (ref_t, ref_s), upd = _jit_apply(jmod)(v, *args, deterministic=False,
                                           mutable=("batch_stats",))
    mod.train()
    with torch.no_grad():
        out_t, out_s = mod(_t(sample.x_t), _t(sample.x_s), level, _t(deg))
    _close(out_t, ref_t, what="x_t")
    _close(out_s, ref_s, what="x_s")
    ours = to_flax_paths(mod, {n: b for n, b in mod.named_buffers()})
    for path, leaf in jax.tree_util.tree_flatten_with_path(upd["batch_stats"])[0]:
        _close(ours[tuple(p.key for p in path)], leaf, what="/".join(p.key for p in path))


# ---------------------------------------------------------------------------
# Inception1D
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("readout", ["mean", "max_mean"])
def test_inception1d_matches_jax(readout, dtype):
    """BN on running statistics, then on batch statistics (two masked
    rows).  bfloat16: the convolutions run in bf16 in both packages, with
    other summation orders, so 2e-2 of max|ref| (one bf16 ulp is 7.8e-3)."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((10, 24)).astype(np.float32)
    mask = np.ones(10, np.float32)
    mask[-2:] = 0.0
    jmod = JInception1D(in_channels=16, num_channels=4, if_readout=True,
                        readout_mode=readout, compute_dtype=dtype)
    mod = _perturbed(Inception1D(16, 4, readout_mode=readout,
                                 compute_dtype=dtype), 2)
    v = _flax_variables(mod)
    apply = _jit_apply(jmod)
    rtol = RTOL if dtype == "float32" else 2e-2
    ref = apply(v, jnp.asarray(x), jnp.asarray(mask), deterministic=True)
    with torch.no_grad():
        out = mod.eval()(_t(x), _t(mask))
    assert out.dtype == getattr(torch, dtype) and out.shape[1] == mod.out_features
    _close(out.float(), np.asarray(ref.astype(jnp.float32)), rtol=rtol, what="eval")
    ref, _ = apply(v, jnp.asarray(x), jnp.asarray(mask), deterministic=False,
                   mutable=("batch_stats",))
    with torch.no_grad():
        out = mod.train()(_t(x), _t(mask))
    _close(out.float(), np.asarray(ref.astype(jnp.float32)), rtol=rtol, what="train")


def test_inception1d_round_trips_through_flax_paths():
    """Conv1d weights go to flax ``kernel`` leaves [k, in, out] and back."""
    jmod = JInception1D(in_channels=16, num_channels=4, if_readout=True)
    v = jmod.init(jax.random.key(4), jnp.ones((3, 20)), deterministic=True)
    mod = Inception1D(16, 4)
    mod.load_state_dict(from_flax_variables(v))
    paths = to_flax_paths(mod, mod.state_dict())
    ref = {}
    for tree in (v["params"], v["batch_stats"]):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            ref[tuple(p.key for p in path)] = np.asarray(leaf)
    assert set(paths) == set(ref)
    assert paths[("embedding", "kernel")].shape == (5, 1, 16)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(paths[path], leaf, err_msg="/".join(path))


# ---------------------------------------------------------------------------
# the two brain models on both layouts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def brain_data():
    samples = synthetic_brain_samples(3, seed=0, n_rois=32, t_len=48, num_pool=2)
    for i, s in enumerate(samples):  # z-scored-like targets
        s.y = np.asarray([0.3 * i - 0.2], np.float32)
    levels = samples[0].levels
    return dict(
        samples=samples, levels=levels, pools=samples[0].pools,
        port={"flat": collate(samples, multiple=1).to("cpu"),
              "shared": collate_dense_shared(samples).to("cpu")},
        jax={"flat": jax.tree.map(jnp.asarray, jcollate(samples, multiple=1)),
             "shared": jax.tree.map(jnp.asarray, jshared(samples, multiple=1))},
    )


def _model_kw(name, levels):
    final = levels[2 if name == "hgat" else 1]
    kw = dict(channels=(1, 1, 1), filters=(8, 8, 16), mlp_channels=(8,),
              nodes_per_graph=final.num_nodes, edges_per_graph=final.num_edges)
    if name == "hgat":
        return dict(kw, k=3, pool_num=2, fine_nodes_per_graph=levels[0].num_nodes,
                    fine_edges_per_graph=levels[0].num_edges)
    return dict(kw, k=2, pool_num=1)


@pytest.fixture(scope="module")
def brain_models(brain_data):
    """Per model: the JAX module, its variables (from the perturbed, seeded
    port model) and its jitted apply."""
    out = {}
    for name in ("hgat", "abcd"):
        make = jpresets.hgat_attpool if name == "hgat" else jpresets.abcd_attpool
        jmodel, _ = make(**_model_kw(name, brain_data["levels"]))
        port = presets.hgat_attpool if name == "hgat" else presets.abcd_attpool
        model = _perturbed(port(**_model_kw(name, brain_data["levels"]), device="cpu")[0], 5)
        v = jax.tree.map(np.asarray, _flax_variables(model))
        out[name] = (jmodel, v, _jit_apply(jmodel))
    return out


def _port_model(name, v, levels, compute_dtype="float32"):
    make = presets.hgat_attpool if name == "hgat" else presets.abcd_attpool
    model, _ = make(**_model_kw(name, levels), compute_dtype=compute_dtype, device="cpu")
    model.load_state_dict(from_flax_variables(v))
    return model


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("layout", ["flat", "shared"])
@pytest.mark.parametrize("name", ["hgat", "abcd"])
def test_brain_models_match_jax(brain_data, brain_models, name, layout, mode):
    """Every output (pred, latent, node_att, edge_att of HLHGATAttpool; the
    prediction of HLHGCNNAbcd); train mode also the BN running statistics.
    Train mode normalizes the head's BN over three subjects, which
    amplifies summation-order differences: 1e-4 of max|ref| there."""
    jmodel, v, apply = brain_models[name]
    model = _port_model(name, v, brain_data["levels"])
    jbatch, batch = brain_data["jax"][layout], brain_data["port"][layout]
    if mode == "eval":
        ref = apply(v, jbatch, deterministic=True)
        model.eval()
    else:
        ref, upd = apply(v, jbatch, deterministic=False, mutable=("batch_stats",))
        model.train()
    rtol = RTOL if mode == "eval" else 1e-4
    with torch.no_grad():
        out = model(batch)
    outs, refs = (out, ref) if name == "hgat" else ((out,), (ref,))
    assert len(outs) == len(refs) == (4 if name == "hgat" else 1)
    for o, r, field in zip(outs, refs, ("pred", "latent", "node_att", "edge_att")):
        _close(o.float(), r, rtol=rtol, what=field)
    if mode == "train":
        ours = to_flax_paths(model, dict(model.named_buffers()))
        for path, leaf in jax.tree_util.tree_flatten_with_path(upd["batch_stats"])[0]:
            key = tuple(p.key for p in path)
            _close(ours[key], leaf, rtol=1e-4, what="/".join(key))


def test_hgat_gradients_match_jax_grad_on_the_shared_layout(brain_data, brain_models):
    """Train-mode BN, MSE on the z-scored targets: the loss and every
    parameter gradient against ``jax.grad``.  The head's BN normalizes over
    three subjects, which amplifies summation-order noise: the loss within
    1e-4, each gradient within 5e-4 of its leaf's max|ref| (measured: 1.1e-4
    at most), plus 1e-4 of the largest gradient anywhere for the leaves whose
    gradient is rounding noise (the biases in front of a BN, analytically 0,
    measured at 1e-8 to 1e-6)."""
    jmodel, v, _ = brain_models["hgat"]
    jbatch, batch = brain_data["jax"]["shared"], brain_data["port"]["shared"]

    def jloss(params):
        (pred, *_), _ = jmodel.apply({"params": params, "batch_stats": v["batch_stats"]},
                                     jbatch, deterministic=False, mutable=["batch_stats"])
        return jnp.mean((pred.reshape(-1) - jbatch.y.reshape(-1)) ** 2)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(v["params"])
    model = _port_model("hgat", v, brain_data["levels"]).train()
    loss = mse_loss(model(batch)[0].reshape(-1), batch.y.reshape(-1))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-4)
    got = to_flax_paths(model, {n: p.grad for n, p in model.named_parameters()})
    ref = {tuple(p.key for p in path): np.asarray(g)
           for path, g in jax.tree_util.tree_flatten_with_path(ref_grads)[0]}
    assert set(got) == set(ref)
    noise = 1e-4 * max(float(np.abs(g).max()) for g in ref.values())
    for path, g in ref.items():
        scale = float(np.abs(g).max())
        err = float(np.abs(got[path] - g).max())
        assert err <= 5e-4 * scale + noise, f"{'/'.join(path)}: {err:.3e} of {scale:.3e}"


def test_brain_predictor_matches_jax(brain_data, brain_models):
    """Three subjects in batches of two: the second batch carries a filler
    subject, stripped; every field in input order."""
    jmodel, v, _ = brain_models["hgat"]
    levels, pools = brain_data["levels"], brain_data["pools"]
    series = [s.x_t for s in brain_data["samples"]]
    ref = JBrainPredictor(jmodel, v, levels, pools, batch_size=2)(series)
    pred = BrainPredictor(_port_model("hgat", v, levels), levels, pools, batch_size=2,
                          device="cpu")
    out = pred(series)
    assert set(out) == set(ref) == set(BrainPredictor.FIELDS)
    for field in BrainPredictor.FIELDS:
        assert out[field].shape[0] == 3
        _close(out[field], ref[field], what=field)
    abcd_j, abcd_v, _ = brain_models["abcd"]
    out = BrainPredictor(_port_model("abcd", abcd_v, levels), levels, pools, batch_size=2,
                         device="cpu")(series)
    ref = JBrainPredictor(abcd_j, abcd_v, levels, pools, batch_size=2)(series)
    assert set(out) == set(ref) == {"pred"}
    _close(out["pred"], ref["pred"], what="abcd pred")


def test_brain_trainer_steps_and_pearson_match_jax(brain_data, brain_models):
    """Two ``Trainer(task="brain")`` steps (MSE, lr = l2 = 1e-4) on the
    shared layout, then ``evaluate``'s loss and Pearson r, against the JAX
    trainer.  Losses rtol 1e-4 (Adam's first steps move every weight by
    about lr, so rounding-noise gradients of pre-BN biases may point either
    way in the two packages); the metric abs 1e-4."""
    jmodel, v, _ = brain_models["hgat"]
    jbatch, batch = brain_data["jax"]["shared"], brain_data["port"]["shared"]
    cfg = dict(task="brain", lr=1e-4, weight_decay=1e-4, metric_mode="max")
    jtrainer = JTrainer(jmodel, JTrainerConfig(**cfg))
    state = TrainState(params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=jtrainer.tx.init(v["params"]), step=jnp.zeros((), jnp.int32),
                       rng=jax.random.key(0))
    ref_losses = []
    step = jax.jit(jtrainer._train_step_impl)
    for _ in range(2):
        state, loss = step(state, jbatch)
        ref_losses.append(float(loss))
    ref_eval = jtrainer.evaluate(state, [jbatch])

    trainer = Trainer(_port_model("hgat", v, brain_data["levels"]), TrainerConfig(**cfg),
                      device="cpu")
    losses = [float(trainer.train_step(batch)) for _ in range(2)]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    val_loss, r = trainer.evaluate([batch])
    assert val_loss == pytest.approx(ref_eval[0], rel=1e-4)
    assert -1.0 <= r <= 1.0 and r == pytest.approx(ref_eval[1], abs=1e-4)


def test_bfloat16_hgat_matches_jax(brain_data, brain_models):
    """A bfloat16 trunk (Inception1D, the convs and the gates in bf16) on the
    shared layout, BN on running statistics: the two packages round at the
    same points but sum in other orders, so each output within 5e-2 of its
    max|ref|."""
    jmodel, v, _ = brain_models["hgat"]
    jb = dataclasses.replace(jmodel, cfg=dataclasses.replace(jmodel.cfg,
                                                             compute_dtype="bfloat16"))
    ref = _jit_apply(jb)(v, brain_data["jax"]["shared"], deterministic=True)
    model = _port_model("hgat", v, brain_data["levels"], compute_dtype="bfloat16").eval()
    with torch.no_grad():
        out = model(brain_data["port"]["shared"])
    for o, r, field in zip(out, ref, BrainPredictor.FIELDS):
        _close(o.float(), np.asarray(jnp.asarray(r, jnp.float32)), rtol=5e-2, what=field)


def test_brain_models_refuse_a_packed_batch_and_final_pools(brain_data):
    """A packed batch puts several graphs in a block, so the flatten readout
    would read other graphs' rows: the models raise.  ``abcd_attpool``
    refuses a pool at its last block, as the JAX preset does."""
    from hl_hgat_tpu_torch.complex.dense import collate_dense_packed

    model, _ = presets.abcd_attpool(**_model_kw("abcd", brain_data["levels"]), device="cpu")
    packed = collate_dense_packed(brain_data["samples"]).to("cpu")
    with pytest.raises(ValueError, match="packed"):
        model(packed)
    with pytest.raises(ValueError, match="non-final"):
        presets.abcd_attpool(channels=(1, 1), filters=(8, 8), pool_num=2, device="cpu")


def test_brain_group_data_loaders_match_jax(tmp_path):
    """``load_group_fc``, ``load_affiliations``, ``real_skeleton``,
    ``build_real_brain_pyramid`` and ``lobe_sorted_matrix`` on synthetic
    ``.mat`` files in the DEMO's layout, against the JAX loaders."""
    from scipy.io import savemat

    rng = np.random.default_rng(13)
    n = 40
    fc = np.corrcoef(rng.standard_normal((n, 80)))
    mask = np.triu((rng.random((n, n)) < 0.3).astype(np.float64), 1)
    mask[np.arange(n - 1), np.arange(1, n)] = 1.0
    savemat(tmp_path / "Group_FC.mat", {"fc_mean": fc, "sc_mean": 2 * fc})
    savemat(tmp_path / "Group_FCMask.mat", {"sf_mask": mask})
    lobes = np.empty((20, 1), dtype=object)  # a 20 x 1 cell of strings
    for i in range(20):
        lobes[i, 0] = np.array([f"lobe{i}"])
    labels = np.zeros((1, 1), dtype=[("Lobes_20Ns", object)])
    labels[0, 0]["Lobes_20Ns"] = lobes
    aff = np.ones((n, 6), np.int64)
    aff[:, 5] = rng.integers(1, 21, n)
    savemat(tmp_path / "affiliations.mat", {"affiliation": aff, "labels": labels})

    ours, ref = brain.load_group_fc(str(tmp_path)), jbrain.load_group_fc(str(tmp_path))
    for key in ("fc_mean", "sc_mean", "sf_mask"):
        np.testing.assert_array_equal(ours[key], ref[key])
    a, b = brain.load_affiliations(str(tmp_path)), jbrain.load_affiliations(str(tmp_path))
    np.testing.assert_array_equal(a["affiliation"], b["affiliation"])
    assert a["lobe_names"] == b["lobe_names"] == [f"lobe{i}" for i in range(20)]
    for x, y in zip(brain.real_skeleton(fc, mask), jbrain.real_skeleton(fc, mask)):
        np.testing.assert_array_equal(x, y)
    levels, pools, w = brain.build_real_brain_pyramid(str(tmp_path), pool_num=2)
    jlevels, jpools, jw = jbrain.build_real_brain_pyramid(str(tmp_path), pool_num=2)
    np.testing.assert_array_equal(w, jw)
    for x, y in zip(levels, jlevels):
        np.testing.assert_array_equal(x.src, y.src)
        np.testing.assert_array_equal(x.dst, y.dst)
    for x, y in zip(pools, jpools):
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_array_equal(x[1], y[1])
    m = rng.standard_normal((n, n))
    got = brain.lobe_sorted_matrix(m, a["affiliation"], a["lobe_names"])
    want = jbrain.lobe_sorted_matrix(m, b["affiliation"], b["lobe_names"])
    for key in ("matrix", "perm", "sizes"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["labels"] == want["labels"]
