"""The port's trainer on the flat layout against the JAX trainer (CPU):
three ``train_step``s of a narrow ``zinc_pyr``, ``pascalvoc_node`` and
``pcqm_link`` (losses rtol 1e-4, every parameter and BN statistic after
the third step), the evaluation metrics of the two new tasks (macro-F1
over valid nodes, MRR over the [Q, 1 + n_neg] groups), and which tasks the
port's ``Trainer`` still refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_flat_model as fm
from hl_hgat_tpu.train.trainer import Trainer as JTrainer
from hl_hgat_tpu.train.trainer import TrainerConfig as JTrainerConfig
from hl_hgat_tpu.train.trainer import TrainState
from hl_hgat_tpu_torch.train.trainer import Trainer, TrainerConfig
from hl_hgat_tpu_torch.weights import from_flax_variables, to_flax_paths


def _jax_state(jtrainer, v):
    return TrainState(
        params=v["params"], batch_stats=v["batch_stats"],
        opt_state=jtrainer.tx.init(v["params"]), step=jnp.zeros((), jnp.int32),
        rng=jax.random.key(0))


@pytest.mark.parametrize("name", fm.CASES)
def test_three_flat_train_steps_match_jax_trainer(name):
    _, host, jb, jmodel, make = fm.make_case(name, seed=31)
    v = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.key(0)}, jb, deterministic=True))
    cfg = dict(task=fm.TASKS[name], lr=1e-3, weight_decay=1e-3)

    jtrainer = JTrainer(jmodel, JTrainerConfig(**cfg))
    state = _jax_state(jtrainer, v)
    step = jax.jit(jtrainer._train_step_impl)
    ref_losses = []
    for _ in range(3):
        state, loss = step(state, jb)
        ref_losses.append(float(loss))

    model, _ = make()
    model.load_state_dict(from_flax_variables(v))
    trainer = Trainer(model, TrainerConfig(**cfg), device="cpu")
    losses = [trainer.train_step(host) for _ in range(3)]
    assert all(l.dim() == 0 and not l.requires_grad for l in losses)
    np.testing.assert_allclose([float(l) for l in losses], ref_losses, rtol=1e-4)
    assert losses[2] < losses[0]

    ours = to_flax_paths(model, model.state_dict())
    ref = {}
    for tree in (state.params, state.batch_stats):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            ref[tuple(p.key for p in path)] = np.asarray(leaf)
    assert set(ours) == set(ref)
    # As in the packed-layout test: Adam's first steps move every weight by
    # ~lr whatever its gradient's size, and a bias in front of a BN has a
    # gradient of rounding noise whose sign differs between the packages,
    # so after 3 steps of 1e-3 such biases may differ by up to 6e-3 and the
    # BN batch means they shift by 0.1 (momentum) of that per step.  The
    # biases no BN follows are the output layer's.  Everything else: rtol
    # 1e-4, with an atol of 5e-5 (under 2 % of the 3e-3 the three steps can
    # move a weight): Adam normalises a near-zero gradient entry to a step
    # whose size, too, is set by rounding.
    atol = {"bias": 7e-3, "mean": 1e-3}
    for path in sorted(ref):
        pre_bn = path[-2:] != ("out", "bias")
        np.testing.assert_allclose(ours[path], ref[path], rtol=1e-4,
                                   atol=atol.get(path[-1], 5e-5) if pre_bn else 5e-5,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("name", ["pascalvoc_node", "pcqm_link"])
def test_flat_evaluate_matches_jax_trainer(name):
    """Two batches through ``evaluate``: the mean loss and the task's
    metric, from the same weights."""
    cases = [fm.make_case(name, seed=s) for s in (41, 43)]
    _, _, jb0, jmodel, make = cases[0]
    v = fm.init_variables(jmodel, jb0)
    cfg = dict(task=fm.TASKS[name], metric_mode="max")
    jtrainer = JTrainer(jmodel, JTrainerConfig(**cfg))
    ref_loss, ref_metric = jtrainer.evaluate(_jax_state(jtrainer, v), [c[2] for c in cases])
    model, _ = make()
    model.load_state_dict(from_flax_variables(v))
    trainer = Trainer(model, TrainerConfig(**cfg), device="cpu")
    loss, metric = trainer.evaluate([c[1] for c in cases])
    assert loss == pytest.approx(ref_loss, rel=1e-4)
    # the metrics count argmax hits and ranks: equal unless a logit pair is
    # within rounding of a tie
    assert metric == pytest.approx(ref_metric, abs=1e-6)
    assert 0.0 < metric <= 1.0
    out, step_loss = trainer.eval_step(cases[0][1])
    assert not trainer.model.training and step_loss.dim() == 0
    assert out.shape[0] == (cases[0][1].x_t.shape[0] if name == "pascalvoc_node"
                            else cases[0][1].pairs.shape[0])


def test_flat_fit_runs_the_epoch_loop_on_the_node_task():
    cases = [fm.make_case("pascalvoc_node", seed=s) for s in (51, 53)]
    model, meta = cases[0][4](seed=5)
    trainer = Trainer(model, TrainerConfig(task=meta["task"], lr=5e-3, metric_mode="max"),
                      device="cpu")
    batches = [c[1] for c in cases]
    seen = []
    trainer.fit(lambda: batches, lambda: batches[:1], epochs=3, verbose=False,
                on_improve=lambda t, m: seen.append(m))
    assert len(trainer.history) == 3
    assert trainer.history[2]["train_loss"] < trainer.history[0]["train_loss"]
    assert seen and trainer.best_metric == max(r["val_metric"] for r in trainer.history)


@pytest.mark.parametrize("task", ["node_classification", "link_prediction"])
def test_flat_tasks_are_accepted(task):
    trainer = Trainer(torch.nn.Linear(2, 1), TrainerConfig(task=task), device="cpu")
    assert trainer.cfg.task == task


def test_train_step_gives_unreached_parameters_a_zero_gradient():
    """The link head never reads the last edge conv: its parameters still
    decay under the L2 term, as every leaf does in the JAX trainer."""
    _, host, _, _, make = fm.make_case("pcqm_link")
    model, meta = make()
    trainer = Trainer(model, TrainerConfig(task=meta["task"], lr=1e-2, weight_decay=1e-1),
                      device="cpu")
    w = model.backbone.NEConv11.edge.conv.weight
    before = w.detach().clone()
    trainer.train_step(host)
    assert w.grad is not None and not w.grad.any()
    assert not torch.equal(w.detach(), before)
