"""The port's three example programs on the CPU: ``brain_demo`` against the
JAX package's demo flow (its init bit-equal to the JAX calls of
``examples/brain_demo.py``; one epoch from the JAX model's initial weights
against the same optax loop), ``figures`` writing its three PNGs, and
``gp_brain`` training over two gloo ranks.  The examples refuse to run on
the CPU unless asked.

Tolerances (float32): epoch losses rtol 1e-4; the gradient that Adam
reads, each leaf within 5e-4 of its max|ref| plus 1e-4 of the largest
gradient anywhere (``test_torch_brain``'s rule for this model: BN over a
few subjects amplifies summation-order noise); the evaluate
stage on the JAX loop's trained weights: validation predictions atol 1e-4,
the attention matrix atol 1e-5 (gates in [0, 1]).  The port's own trained
predictions are held within STEPPED_PRED_ATOL: a bias in front of a
BatchNorm has no true gradient, so its float32 gradient is rounding noise
(|g| ~ 1e-7, either sign) that Adam's first step turns into a move of ±lr,
and BN on running statistics passes that move to the predictions.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from hl_hgat_tpu.complex.build import build_structure as jbuild_structure
from hl_hgat_tpu.complex.coarsen import mlgc as jmlgc
from hl_hgat_tpu.complex.dense import collate_dense_shared as jshared
from hl_hgat_tpu.data.datasets import brain_sample as jbrain_sample
from hl_hgat_tpu.data.datasets import fc2mask as jfc2mask
from hl_hgat_tpu.models import presets as jpresets
from hl_hgat_tpu.train.metrics import pearson_corr as jpearson_corr
from hl_hgat_tpu.utils import attention_fc_matrix as jattention_fc_matrix
from hl_hgat_tpu.utils import sort_by_parcels as jsort_by_parcels
from hl_hgat_tpu_torch.examples import brain_demo, figures, gp_brain
from hl_hgat_tpu_torch.weights import from_flax_variables, to_flax_paths

SMALL = ["--real", "off", "--rois", "16", "--subjects", "8", "--t", "32"]
LOSS_RTOL = 1e-4
PRED_ATOL = 1e-4
ATT_ATOL = 1e-5
GRAD_LEAF_REL, GRAD_NOISE_REL = 5e-4, 1e-4
STEPPED_PRED_ATOL = 5e-3


def _jax_init(rois=16, subjects=8, t=32, percent=0.2):
    """The JAX demo's init stage on synthetic data, call for call
    (``examples/brain_demo.py``): skeleton, pyramid, samples, generator."""
    rng = np.random.default_rng(0)
    k = 4
    mixing = rng.standard_normal((rois, k))
    ts_all = np.empty((subjects, rois, t))
    scores = np.empty(subjects)
    for s in range(subjects):
        strength = rng.uniform(0.5, 2.0)
        lat = rng.standard_normal((k, t))
        lat[0] *= strength
        ts_all[s] = mixing @ lat + 0.5 * rng.standard_normal((rois, t))
        scores[s] = 95.1377 + 7.3 * (strength - 1.25)
    fcs = np.stack([np.corrcoef(ts) for ts in ts_all])
    mask = jfc2mask(fcs, percent=percent, mode=1)
    src, dst = np.nonzero(mask)
    order = np.argsort(src * mask.shape[0] + dst)
    src, dst = src[order].astype(np.int32), dst[order].astype(np.int32)
    levels = [jbuild_structure(src, dst, rois)]
    pools = []
    weight = np.abs(fcs.mean(0))[src, dst]
    for _ in range(2):
        step = jmlgc(levels[-1], edge_weight=weight, prune_single_fine_edges=True,
                     drop_isolated_nodes=True)
        levels.append(step.structure)
        pools.append((step.c_node, step.c_edge))
        weight = None
    samples = [jbrain_sample(ts_all[s], src, dst, levels, pools, y=scores[s], rng=rng)
               for s in range(subjects)]
    n_val = max(subjects // 4, 1)
    return dict(src=src, dst=dst, levels=levels, pools=pools, train=samples[n_val:],
                val=samples[:n_val], rng=rng)


@pytest.fixture(scope="module")
def inits():
    args = brain_demo.build_argparser().parse_args(SMALL + ["--cpu"])
    return brain_demo.init_stage(args, log=lambda *a: None), _jax_init()


def test_brain_demo_init_is_bit_equal_to_the_jax_calls(inits):
    ours, ref = inits
    np.testing.assert_array_equal(ours.src, ref["src"])
    np.testing.assert_array_equal(ours.dst, ref["dst"])
    assert len(ours.levels) == len(ref["levels"]) == 3
    for a, b in zip(ours.levels, ref["levels"]):
        for name in ("src", "dst", "l0_rows", "l0_cols", "l0_vals", "l1_rows", "l1_cols",
                     "l1_vals"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    for (a_n, a_e), (b_n, b_e) in zip(ours.pools, ref["pools"]):
        np.testing.assert_array_equal(a_n, b_n)
        np.testing.assert_array_equal(a_e, b_e)
    for a, b in zip(ours.train + ours.val, ref["train"] + ref["val"]):
        for name in ("x_t", "x_s", "y"):
            assert getattr(a, name).dtype == getattr(b, name).dtype
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert ours.rng.bit_generator.state == ref["rng"].bit_generator.state


def _jax_epoch(ref, bs=8):
    """The JAX demo's model, init, one optax epoch and evaluation."""
    final, fine = ref["levels"][-1], ref["levels"][0]
    model, meta = jpresets.hgat_attpool(
        **brain_demo.MODEL, nodes_per_graph=final.num_nodes, edges_per_graph=final.num_edges,
        fine_nodes_per_graph=fine.num_nodes, fine_edges_per_graph=fine.num_edges)
    dev = lambda b: jax.tree.map(jnp.asarray, b)  # noqa: E731

    def batches(split):
        b = min(bs, len(split))
        return [dev(jshared(split[i:i + b], multiple=1)) for i in range(0, len(split) - b + 1, b)]

    train, val = batches(ref["train"]), batches(ref["val"])
    variables = jax.jit(model.init, static_argnames="deterministic")(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, train[0],
        deterministic=True)
    params, bstats = variables["params"], variables["batch_stats"]
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)

    @jax.jit
    def train_step(params, bstats, opt_state, batch, key):
        def loss_fn(p):
            (pred, *_), mut = model.apply({"params": p, "batch_stats": bstats}, batch,
                                          deterministic=False, mutable=["batch_stats"],
                                          rngs={"dropout": key})
            return jnp.mean((pred.reshape(-1) - batch.y.reshape(-1)) ** 2), mut
        (loss, mut), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), mut["batch_stats"], opt_state, loss,
                grads)

    key = jax.random.key(2)
    losses, grads = [], []
    for batch in train:
        key, sk = jax.random.split(key)
        params, bstats, opt_state, loss, g = train_step(params, bstats, opt_state, batch, sk)
        losses.append(float(loss))
        grads.append(jax.tree.map(np.asarray, g))
    infer = jax.jit(lambda b: model.apply({"params": params, "batch_stats": bstats}, b,
                                          deterministic=True))
    preds, ys, atts = [], [], []
    for batch in val:
        pred, _, _, edge_att = infer(batch)
        preds.append(np.asarray(pred).reshape(-1))
        ys.append(np.asarray(batch.y).reshape(-1))
        atts.append(np.asarray(edge_att))
    pred, y = np.concatenate(preds), np.concatenate(ys)
    trained = jax.tree.map(np.asarray, {"params": params, "batch_stats": bstats})
    return dict(variables=jax.tree.map(np.asarray, variables), trained=trained, grads=grads,
                loss=float(np.mean(losses)),
                pred=pred, y=y, corr=float(jpearson_corr(jnp.asarray(pred), jnp.asarray(y))),
                rmse=float(np.sqrt(np.mean((pred - y) ** 2))) * meta["y_std"],
                edge_att=np.concatenate(atts))


def _flat(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def test_brain_demo_epoch_from_the_jax_weights_matches_the_jax_loop(inits, monkeypatch):
    ours, ref = inits
    want = _jax_epoch(ref)
    train = brain_demo.batches(ours.train, 8, "cpu")
    val = brain_demo.batches(ours.val, 8, "cpu")
    assert len(train) == len(want["grads"]) == 1
    model, meta = brain_demo.build_model(ours, "cpu")
    model.load_state_dict(from_flax_variables(want["variables"]))

    # the gradient each Adam step reads, captured as the step is called
    read = []
    make_adam = brain_demo.adam_l2

    def spying_adam(params, lr):
        opt = make_adam(params, lr=lr)
        step = opt.step

        def spy(*a, **k):
            read.append({n: p.grad.clone() for n, p in model.named_parameters()})
            return step(*a, **k)

        opt.step = spy
        return opt

    monkeypatch.setattr(brain_demo, "adam_l2", spying_adam)
    losses = brain_demo.train_stage(model, train, 1, log=lambda *a: None)
    np.testing.assert_allclose(losses, [want["loss"]], rtol=LOSS_RTOL)
    got_grads = to_flax_paths(model, read[0])
    ref_grads = dict(_flat(want["grads"][0]))
    assert sorted(got_grads) == sorted(ref_grads)
    noise = GRAD_NOISE_REL * max(float(np.abs(g).max()) for g in ref_grads.values())
    for path, g in ref_grads.items():
        scale, err = float(np.abs(g).max()), float(np.abs(got_grads[path] - g).max())
        assert err <= GRAD_LEAF_REL * scale + noise, f"{'/'.join(path)}: {err:.3e} of {scale:.3e}"
    stepped = brain_demo.evaluate_stage(model, val, meta, log=lambda *a: None)
    np.testing.assert_allclose(stepped["pred"], want["pred"], rtol=0, atol=STEPPED_PRED_ATOL)

    # the evaluate and analyze stages on the JAX loop's trained weights
    model.load_state_dict(from_flax_variables(want["trained"]))
    got = brain_demo.evaluate_stage(model, val, meta, log=lambda *a: None)
    np.testing.assert_array_equal(got["y"], want["y"])
    np.testing.assert_allclose(got["pred"], want["pred"], rtol=0, atol=PRED_ATOL)
    assert got["corr"] == pytest.approx(want["corr"], abs=1e-3)
    assert got["rmse"] == pytest.approx(want["rmse"], abs=PRED_ATOL * meta["y_std"])
    analysis = brain_demo.analyze_stage(ours, got["edge_att"], log=lambda *a: None)
    fc_att = jattention_fc_matrix(want["edge_att"].mean(0), ref["src"], ref["dst"], 16)
    np.testing.assert_allclose(analysis["fc_att"], fc_att, rtol=0, atol=ATT_ATOL)
    sorted_m, perm, bounds = jsort_by_parcels(fc_att, ref["rng"].integers(0, 4, 16))
    np.testing.assert_array_equal(analysis["perm"], perm)
    np.testing.assert_array_equal(analysis["bounds"], bounds)
    np.testing.assert_allclose(analysis["sorted"], sorted_m, rtol=0, atol=ATT_ATOL)


def test_brain_demo_main_runs_on_the_cpu_when_asked(capsys):
    out = brain_demo.main(SMALL + ["--epochs", "2", "--cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "skeleton: 16 ROIs, 17 edges"
    assert [ln.split(":")[0] for ln in lines[3:5]] == ["epoch 0", "epoch 1"]
    assert lines[5].startswith("validation: corr") and lines[6].startswith("attention FC")
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["analysis"]["fc_att"].shape == (16, 16)


def test_figures_main_writes_three_pngs_on_the_cpu(tmp_path):
    outs = figures.main(["--out_dir", str(tmp_path), "--device", "cpu"])
    assert {os.path.basename(o) for o in outs} == {
        "tsp_trend.png", "cifar_attention.png", "brain_fc_attention.png"}
    for o in outs:
        assert os.path.isfile(o) and os.path.getsize(o) > 10_000, o


def test_figure_arrays_are_finite_and_shaped():
    trends = figures.tsp_trend_arrays(0, "cpu")
    assert trends["node"].shape == trends["edge"].shape == (4,)
    assert np.isfinite(trends["node"]).all() and (trends["edge"] > 0).all()
    cifar = figures.cifar_attention_arrays(0, "cpu")
    assert cifar["a_t"].shape == cifar["node_mask"].shape
    assert ((cifar["a_s"] >= 0) & (cifar["a_s"] <= 1)).all()
    brain = figures.brain_fc_arrays(0)
    assert brain["matrix"].shape == (100, 100) and brain["sizes"].sum() == 100


def test_gp_brain_main_trains_over_two_gloo_ranks(capsys):
    results = gp_brain.main(["--cpu", "--parts", "2", "--steps", "2", "--rois", "24"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "graph-parallel training OK on mesh (1, 2)"
    assert out[0].startswith("complex: 24 nodes,")
    assert len(results) == 2 and results[0]["losses"] == results[1]["losses"]
    assert np.isfinite(results[0]["losses"]).all() and len(results[0]["losses"]) == 2


@pytest.mark.parametrize("call", [
    lambda: brain_demo.main(SMALL),
    lambda: figures.main(["--out_dir", "unused"]),
    lambda: gp_brain.main(["--parts", "2"]),
])
def test_examples_refuse_the_cpu_unless_asked(call, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
