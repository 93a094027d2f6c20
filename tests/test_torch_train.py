"""The port's training layer against the JAX package on the CPU: losses,
metrics, Adam with L2, the plateau scheduler, three full train steps of a
narrow zinc_pyr, and the Trainer's epoch loop."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hl_hgat_tpu.complex.dense import collate_dense_packed as jcollate
from hl_hgat_tpu.models import presets as jpresets
from hl_hgat_tpu.train import losses as JL
from hl_hgat_tpu.train import metrics as JM
from hl_hgat_tpu.train import optim as jopt
from hl_hgat_tpu.train.trainer import Trainer as JTrainer
from hl_hgat_tpu.train.trainer import TrainerConfig as JTrainerConfig
from hl_hgat_tpu.train.trainer import TrainState
from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
from hl_hgat_tpu_torch.data.synthetic import zinc_like_samples
from hl_hgat_tpu_torch.models import presets
from hl_hgat_tpu_torch.train import losses as L
from hl_hgat_tpu_torch.train import metrics as M
from hl_hgat_tpu_torch.train import optim
from hl_hgat_tpu_torch.train.trainer import Trainer, TrainerConfig
from hl_hgat_tpu_torch.weights import from_flax_variables, to_flax_paths

NARROW = dict(channels=(1, 1), filters=(16, 32), k=3, keig=15, mlp_channels=(16,))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# losses and metrics: same f32 formulas, rtol 1e-6
# ---------------------------------------------------------------------------

_LOSSES = ["l1_loss", "mse_loss", "bce_logits_loss", "focal_loss", "soft_dice_loss",
           "weighted_mse_loss"]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", _LOSSES)
def test_elementwise_losses_match_jax(rng, name, masked):
    pred = rng.standard_normal((24, 3)).astype(np.float32) * 3
    pred[0, 0], pred[1, 1] = 45.0, -50.0  # beyond the ±30 logit clip
    target = rng.standard_normal((24, 3)).astype(np.float32)
    if name in ("bce_logits_loss", "focal_loss", "soft_dice_loss"):
        target = (target > 0).astype(np.float32)
    # soft dice flattens everything, so its mask is per element
    mshape = (24, 3) if name == "soft_dice_loss" else (24,)
    mask = (rng.random(mshape) > 0.4).astype(np.float32) if masked else None
    ours = getattr(L, name)(_t(pred), _t(target), None if mask is None else _t(mask))
    ref = getattr(JL, name)(jnp.asarray(pred), jnp.asarray(target),
                            None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_ce_matches_jax(rng, masked):
    logits = rng.standard_normal((30, 10)).astype(np.float32) * 2
    labels = rng.integers(0, 10, 30)
    mask = (rng.random(30) > 0.4).astype(np.float32) if masked else None
    ours = L.softmax_ce_loss(_t(logits), _t(labels), None if mask is None else _t(mask))
    ref = JL.softmax_ce_loss(jnp.asarray(logits), jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


def test_all_masked_out_gives_zero_not_nan():
    x, m = torch.ones(4, 2), torch.zeros(4)
    assert float(L.l1_loss(x, torch.zeros(4, 2), m)) == 0.0


def test_loss_gradients_match_jax(rng):
    pred = rng.standard_normal((16, 2)).astype(np.float32)
    target = (rng.random((16, 2)) > 0.5).astype(np.float32)
    mask = (rng.random(16) > 0.3).astype(np.float32)
    for name in ("l1_loss", "mse_loss", "focal_loss"):
        p = _t(pred).requires_grad_()
        getattr(L, name)(p, _t(target), _t(mask)).backward()
        ref = jax.grad(lambda q: getattr(JL, name)(q, jnp.asarray(target), jnp.asarray(mask)))(
            jnp.asarray(pred))
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-5, atol=1e-7, err_msg=name)


def test_tensor_metrics_match_jax(rng):
    pred = rng.standard_normal((20, 1)).astype(np.float32)
    target = rng.standard_normal((20, 1)).astype(np.float32)
    np.testing.assert_allclose(float(M.mae(_t(pred), _t(target), denorm=2.0109)),
                               float(JM.mae(jnp.asarray(pred), jnp.asarray(target), denorm=2.0109)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(M.pearson_corr(_t(pred), _t(target))),
                               float(JM.pearson_corr(jnp.asarray(pred), jnp.asarray(target))),
                               rtol=1e-5)
    logits = rng.standard_normal((40, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 40)
    assert float(M.accuracy(_t(logits), _t(labels))) == pytest.approx(
        float(JM.accuracy(jnp.asarray(logits), jnp.asarray(labels))))
    edge_logits = rng.standard_normal(60).astype(np.float32)
    edge_t = (rng.random(60) > 0.5).astype(np.float32)
    seg = np.sort(rng.integers(0, 5, 60))
    emask = (rng.random(60) > 0.2).astype(np.float32)
    np.testing.assert_allclose(
        float(M.per_graph_binary_f1(_t(edge_logits), _t(edge_t), _t(seg), 5, _t(emask))),
        float(JM.per_graph_binary_f1(jnp.asarray(edge_logits), jnp.asarray(edge_t),
                                     jnp.asarray(seg), 5, jnp.asarray(emask))),
        rtol=1e-6)


def test_ranking_metrics_match_jax(rng):
    y_true = (rng.random((50, 4)) > 0.6).astype(np.float64)
    y_true[:, 3] = 1.0  # a task without both classes is skipped
    y_pred = rng.standard_normal((50, 4))
    y_pred[:10, 0] = y_pred[0, 0]  # ties
    assert M.eval_ap(y_true, y_pred) == pytest.approx(JM.eval_ap(y_true, y_pred), rel=1e-12)
    assert M.average_precision(y_true[:, 0], y_pred[:, 0]) == pytest.approx(
        JM.average_precision(y_true[:, 0], y_pred[:, 0]), rel=1e-12)
    logits = rng.standard_normal((80, 6))
    labels = rng.integers(0, 5, 80)
    keep = rng.random(80) > 0.3
    assert M.macro_f1(logits, labels, 6, keep) == pytest.approx(
        JM.macro_f1(logits, labels, 6, keep), rel=1e-12)
    pos, neg = rng.standard_normal(12), rng.standard_normal((12, 9))
    assert M.mrr(pos, neg) == pytest.approx(JM.mrr(pos, neg), rel=1e-12)


# ---------------------------------------------------------------------------
# optimizer and schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weight_decay", [0.0, 1e-3])
def test_adam_l2_matches_optax_over_ten_steps(rng, weight_decay):
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 3, 4)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(10)]
    tx = jopt.adam_l2(1e-2, weight_decay)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    params = {k: torch.nn.Parameter(_t(v).clone()) for k, v in init.items()}
    opt = optim.adam_l2(params.values(), 1e-2, weight_decay)
    for step, g in enumerate(grads):
        if step == 5:  # the lr the plateau scheduler would inject
            state = jopt.set_learning_rate(state, 5e-3)
            optim.set_learning_rate(opt, 5e-3)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = _t(g[k]).clone()
        opt.step()
    for k in shapes:
        # same update rule; f32 rounding differs in the bias correction and
        # the sqrt.  The parameters move ~0.1 in all: atol is 1e-5 of that
        np.testing.assert_allclose(params[k].detach().numpy(), jparams[k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_plateau_matches_jax_state_machine(mode):
    seq = [1.0, 0.9, 0.95, 0.96, 0.89995, 0.97, 0.98, 0.99, 0.5, 0.6, 0.7, 0.8, 0.9,
           1.0, 1.1, 1.2, 1.3]
    if mode == "max":
        seq = [2.0 - m for m in seq]
    kw = dict(lr=1e-3, patience=2, factor=0.5, min_lr=2e-4, mode=mode)
    ours, ref = optim.ReduceLROnPlateau(**kw), jopt.ReduceLROnPlateau(**kw)
    lrs = []
    for m in seq:
        assert ours.step(m) == ref.step(m)
        assert (ours.best, ours.num_bad) == (ref.best, ref.num_bad)
        lrs.append(ours.lr)
    assert lrs[0] == 1e-3 and lrs[-1] == 2e-4 and 5e-4 in lrs  # halved, then floored
    with pytest.raises(ValueError):
        optim.ReduceLROnPlateau(lr=1.0, mode="sideways")


# ---------------------------------------------------------------------------
# three train steps of a narrow zinc_pyr against the JAX trainer
# ---------------------------------------------------------------------------


def test_three_train_steps_match_jax_trainer():
    samples = zinc_like_samples(np.random.default_rng(31), 12)
    batch = collate_dense_packed(samples)
    jbatch = jax.tree.map(jnp.asarray, jcollate(samples))
    jmodel, _ = jpresets.zinc_pyr(**NARROW)
    v = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.key(0)}, jbatch, deterministic=True))
    cfg = dict(task="regression", lr=1e-3, weight_decay=1e-3)

    jtrainer = JTrainer(jmodel, JTrainerConfig(**cfg))
    state = TrainState(
        params=v["params"], batch_stats=v["batch_stats"],
        opt_state=jtrainer.tx.init(v["params"]), step=jnp.zeros((), jnp.int32),
        rng=jax.random.key(0))
    step = jax.jit(jtrainer._train_step_impl)
    ref_losses = []
    for _ in range(3):
        state, loss = step(state, jbatch)
        ref_losses.append(float(loss))

    model, _ = presets.zinc_pyr(**NARROW, device="cpu")
    model.load_state_dict(from_flax_variables(v))
    trainer = Trainer(model, TrainerConfig(**cfg), device="cpu")
    losses = [trainer.train_step(batch) for _ in range(3)]
    assert all(l.dim() == 0 and not l.requires_grad for l in losses)
    np.testing.assert_allclose([float(l) for l in losses], ref_losses, rtol=1e-4)
    assert losses[2] < losses[0]

    ours = to_flax_paths(model, model.state_dict())
    ref = {}
    for tree in (state.params, state.batch_stats):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            ref[tuple(p.key for p in path)] = np.asarray(leaf)
    assert set(ours) == set(ref)
    # Adam's first steps move every weight by ~lr whatever its gradient's
    # size.  A bias in front of a BN has a gradient of rounding noise (~1e-7,
    # its sign differs between the packages), so after 3 steps of 1e-3 such
    # biases may differ by up to 6e-3, and the BN batch means they shift by
    # 0.1 (momentum) of that per step.  Everything else: rtol 1e-4.
    atol = {"bias": 7e-3, "mean": 1e-3}
    for path in sorted(ref):
        pre_bn = path != ("head", "out", "bias")  # the only bias no BN follows
        np.testing.assert_allclose(ours[path], ref[path], rtol=1e-4,
                                   atol=atol.get(path[-1], 1e-5) if pre_bn else 1e-5,
                                   err_msg="/".join(path))


# ---------------------------------------------------------------------------
# Trainer behaviour on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    samples = zinc_like_samples(np.random.default_rng(41), 16)
    return [collate_dense_packed(samples[:8]), collate_dense_packed(samples[8:])]


def _tiny_trainer(**cfg):
    model, meta = presets.zinc_pyr(channels=(1,), filters=(16,), k=2, keig=15,
                                   mlp_channels=(8,), device="cpu", seed=5)
    return Trainer(model, TrainerConfig(task=meta["task"], **cfg), device="cpu")


def test_fit_records_history_and_calls_on_improve_only_on_improvement(tiny, tmp_path):
    log = tmp_path / "log.jsonl"
    trainer = _tiny_trainer(denorm=2.0109, log_path=str(log))
    seen = []
    out = trainer.fit(lambda: tiny, lambda: tiny[:1], epochs=3, verbose=False,
                      on_improve=lambda t, m: seen.append((t is trainer, m)))
    assert out is trainer and len(trainer.history) == 3
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["epoch"] for r in recs] == [1, 2, 3]
    for rec, logged in zip(trainer.history, recs):
        assert set(rec) == {"epoch", "time", "train_loss", "val_loss", "val_metric", "lr",
                            "improved"}
        assert logged["val_metric"] == rec["val_metric"]
        # regression metric: MAE × denorm of the same predictions as the L1 loss
        assert rec["val_metric"] == pytest.approx(rec["val_loss"] * 2.0109, rel=1e-5)
    improved = [r["val_metric"] for r in trainer.history if r["improved"]]
    assert [m for _, m in seen] == improved and all(flag for flag, _ in seen)
    assert improved == sorted(improved, reverse=True) and len(improved) >= 1
    assert trainer.best_metric == min(r["val_metric"] for r in trainer.history)
    assert trainer.history[2]["train_loss"] < trainer.history[0]["train_loss"]


def test_save_gate_and_metric_mode(tiny):
    trainer = _tiny_trainer(save_gate=1e-9)  # no MAE gets under the gate
    seen = []
    trainer.fit(lambda: tiny, lambda: tiny[:1], epochs=2, verbose=False,
                on_improve=lambda t, m: seen.append(m))
    assert seen == [] and not any(r["improved"] for r in trainer.history)
    up = _tiny_trainer(metric_mode="max")
    assert up.best_metric == -np.inf and up._improved(0.1)
    up.best_metric = 0.5
    assert not up._improved(0.4) and up._improved(0.6)


def test_plateau_halves_lr_and_early_stop_ends_fit(tiny, monkeypatch):
    trainer = _tiny_trainer(lr=1e-3, plateau_patience=1, early_stop_lr=3e-4)
    # a validation loss that never improves after the first epoch
    monkeypatch.setattr(trainer, "evaluate", lambda batches: (1.0, 1.0))
    trainer.fit(lambda: tiny[:1], lambda: tiny[:1], epochs=20, verbose=False)
    lrs = [r["lr"] for r in trainer.history]
    assert lrs == [1e-3, 1e-3, 5e-4, 5e-4, 2.5e-4]  # patience 1, then stop < 3e-4
    assert trainer.optimizer.param_groups[0]["lr"] == 2.5e-4


def test_eval_step_uses_running_stats_and_leaves_them_alone(tiny):
    trainer = _tiny_trainer()
    trainer.train_step(tiny[0])
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    out, loss = trainer.eval_step(tiny[0])
    assert out.shape == (8, 1) and loss.dim() == 0
    assert not trainer.model.training
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    val_loss, mae = trainer.evaluate(tiny)
    assert mae == pytest.approx(val_loss, rel=1e-5)  # denorm 1


@pytest.mark.parametrize("cfg", [
    dict(ckpt_dir="x"), dict(ckpt_every=1), dict(pe_flip_node_static=1),
    dict(pe_flip_edge_static=1), dict(prefetch=2),
])
def test_unported_options_raise(cfg):
    model = torch.nn.Linear(2, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        Trainer(model, TrainerConfig(**cfg), device="cpu")


def test_resume_and_unknown_task_raise(tiny):
    with pytest.raises(NotImplementedError, match="resume"):
        _tiny_trainer().fit(lambda: tiny, lambda: tiny, epochs=1, resume=True)
    with pytest.raises(ValueError, match="unknown task"):
        Trainer(torch.nn.Linear(2, 1), TrainerConfig(task="ranking"), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(torch.nn.Linear(2, 1), TrainerConfig())  # no card here, none asked for


def test_config_fields_follow_the_jax_config():
    import dataclasses

    ours = {f.name: f.default for f in dataclasses.fields(TrainerConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JTrainerConfig)}
    assert set(ref) - set(ours) == {"prng_impl"}  # a JAX generator choice
    assert set(ours) <= set(ref)
    differs = {k for k in ours if ours[k] != ref[k]}
    assert differs == {"prefetch"}  # no prefetcher here yet: 0, not 2


@pytest.mark.parametrize("task", ["classification", "multilabel", "brain"])
def test_other_tasks_train_and_evaluate(rng, task):
    """The task heads that need no new model: a stand-in module on a stub
    batch, loss falls over a few steps and the metric is finite."""
    import types

    n, c = 32, 4
    x = torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32))
    if task == "classification":
        y = torch.from_numpy(rng.integers(0, c, n))
    elif task == "multilabel":
        y = torch.from_numpy((rng.random((n, c)) > 0.5).astype(np.float32))
    else:
        y, c = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)), 1

    class Batch(types.SimpleNamespace):
        def to(self, device):
            return self

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(6, c)

        def forward(self, batch):
            return self.lin(batch.x), "aux"  # tuple outputs: the first counts

    torch.manual_seed(0)
    batch = Batch(x=x, y=y, num_graphs=n)
    trainer = Trainer(Net(), TrainerConfig(task=task, lr=1e-2, weight_decay=0.0,
                                           metric_mode="max"), device="cpu")
    losses = [float(trainer.train_step(batch)) for _ in range(20)]
    assert losses[-1] < losses[0]
    loss, metric = trainer.evaluate([batch, batch])
    assert np.isfinite(loss) and np.isfinite(metric)
    if task == "classification":
        assert 0.0 <= metric <= 1.0
