"""The port's checkpoints (``train/checkpoint.py``) and resume
(``Trainer.maybe_restore``, ``fit(resume=True)``) on the CPU, against the
JAX trainer's semantics, and the conversion of the shipped JAX checkpoint
``weights/zinc_fold0`` (``scripts/convert_jax_checkpoint.py``) against the
JAX model restored from it."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hl_hgat_tpu.complex.dense import collate_dense_packed as jcollate
from hl_hgat_tpu.train.trainer import Trainer as JTrainer
from hl_hgat_tpu.train.trainer import TrainerConfig as JTrainerConfig
from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
from hl_hgat_tpu_torch.data.loader import BucketedLoader
from hl_hgat_tpu_torch.data.synthetic import zinc_like_samples
from hl_hgat_tpu_torch.models import presets
from hl_hgat_tpu_torch.serving import Predictor
from hl_hgat_tpu_torch.train.checkpoint import (
    FULL_SECTIONS,
    load_metadata,
    load_state,
    restore_checkpoint,
    save_checkpoint,
)
from hl_hgat_tpu_torch.train.trainer import Trainer, TrainerConfig
from hl_hgat_tpu_torch.weights import from_flax_variables, to_flax_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(ROOT, "weights", "zinc_fold0")
CONVERTED = os.path.join(ROOT, "weights", "torch", "zinc_fold0")
NARROW = dict(channels=(1, 1), filters=(16, 32), k=3, keig=15, mlp_channels=(16,))


@pytest.fixture(scope="module")
def splits():
    samples = zinc_like_samples(np.random.default_rng(3), 40)
    return samples[8:], samples[:8]


def _trainer(tmp, dropout=0.3, **cfg):
    model, _ = presets.zinc_pyr(**NARROW, dropout=dropout, device="cpu", seed=1)
    cfg = dict(dict(ckpt_dir=str(tmp), save_gate=None, pe_flip_node_static=1,
                    pe_flip_edge_static=1, seed=2), **cfg)
    return Trainer(model, TrainerConfig(task="regression", **cfg), device="cpu")


def _fit(trainer, splits, epochs, resume=False):
    """The CLI's recipe: shuffled derived batches positioned by epoch."""
    train = BucketedLoader(splits[0], batch_size=8, shuffle=True, layout="dense_packed",
                           transfer="derived", seed=4)
    val = BucketedLoader(splits[1], batch_size=8, shuffle=False, layout="dense_packed",
                         transfer="derived")
    return trainer.fit(lambda: train.set_epoch(trainer.epoch - 1),
                       lambda: val.set_epoch(trainer.epoch - 1),
                       epochs=epochs, resume=resume, verbose=False)


def _assert_same_tree(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}/{i}")
    else:
        assert a == b, path


# ---------------------------------------------------------------------------
# save and load
# ---------------------------------------------------------------------------


def test_round_trip_restores_every_section_bit_for_bit(tmp_path, splits):
    trainer = _fit(_trainer(tmp_path / "a", ckpt_dir=None), splits, epochs=1)
    torch.manual_seed(9)
    path = save_checkpoint(str(tmp_path / "ck"), trainer, extra=dict(epoch=1))
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert set(saved) == set(FULL_SECTIONS)
    expect_rng = torch.get_rng_state()
    fresh = _trainer(tmp_path / "b", ckpt_dir=None)
    torch.manual_seed(123)
    restore_checkpoint(str(tmp_path / "ck"), fresh)
    _assert_same_tree(fresh.model.state_dict(), trainer.model.state_dict())
    _assert_same_tree(fresh.optimizer.state_dict(), trainer.optimizer.state_dict())
    assert torch.equal(fresh.generator.get_state(), trainer.generator.get_state())
    assert torch.equal(torch.get_rng_state(), expect_rng)
    # Adam's step counts stay on the CPU, as in a fresh optimizer
    steps = [s["step"] for s in fresh.optimizer.state.values()]
    assert steps and all(s.device.type == "cpu" and float(s) == 4.0 for s in steps)
    # and the two trainers go on alike
    batch = collate_dense_packed(splits[0][:8])
    torch.manual_seed(5)
    a = trainer.train_step(batch)
    torch.manual_seed(5)
    b = fresh.train_step(batch)
    assert torch.equal(a, b)
    assert load_metadata(str(tmp_path / "ck")) == dict(epoch=1)
    assert load_metadata(str(tmp_path / "nothing")) == {}


def test_four_epochs_equal_two_plus_resumed_two(tmp_path, splits, capsys):
    """Dropout 0.3, PE flips and ckpt_every on: the resumed run's epochs 3-4
    and its final state equal the straight run's bit for bit."""
    torch.manual_seed(0)
    straight = _fit(_trainer(tmp_path / "a", ckpt_every=1), splits, epochs=4)
    torch.manual_seed(0)
    _fit(_trainer(tmp_path / "b", ckpt_every=1), splits, epochs=2)
    torch.manual_seed(77)  # whatever the stream, the resume restores it
    resumed = _fit(_trainer(tmp_path / "b", ckpt_every=1), splits, epochs=4, resume=True)
    assert "resumed from epoch 2" not in capsys.readouterr().out  # verbose=False
    assert [r["epoch"] for r in resumed.history] == [3, 4]
    for a, b in zip(straight.history[2:], resumed.history):
        for key in ("train_loss", "val_loss", "val_metric", "lr", "improved"):
            assert a[key] == b[key], (a["epoch"], key)
    _assert_same_tree(straight.model.state_dict(), resumed.model.state_dict())
    _assert_same_tree(straight.optimizer.state_dict(), resumed.optimizer.state_dict())
    assert torch.equal(straight.generator.get_state(), resumed.generator.get_state())
    assert resumed.best_metric == straight.best_metric
    for sub in ("", "latest"):
        _assert_same_tree(load_state(str(tmp_path / "a" / sub)),
                          load_state(str(tmp_path / "b" / sub)))


def test_resume_prints_the_epoch(tmp_path, splits, capsys):
    trainer = _trainer(tmp_path, ckpt_every=1)
    _fit(trainer, splits, epochs=1)
    again = _trainer(tmp_path, ckpt_every=1)
    again.fit(lambda: [collate_dense_packed(splits[0][:8])],
              lambda: [collate_dense_packed(splits[1])], epochs=2, resume=True)
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out and "Epoch 002" in out and "Epoch 001" not in out


def test_files_load_with_weights_only(tmp_path, splits):
    trainer = _fit(_trainer(tmp_path, ckpt_every=1), splits, epochs=1)
    for sub in ("", "latest"):
        state = torch.load(os.path.join(tmp_path, sub, "state.pt"), map_location="cpu",
                           weights_only=True)
        assert set(state) == set(FULL_SECTIONS)
        assert all(v.device.type == "cpu" for v in state["model"].values())
    assert trainer.optimizer.state_dict()["param_groups"][0]["lr"] == 1e-3


# ---------------------------------------------------------------------------
# restore choices and metadata (tests/test_train.py's checkpoint tests)
# ---------------------------------------------------------------------------


def _one_batch_trainer(tmp_path, **cfg):
    model, _ = presets.zinc_pyr(channels=(1,), filters=(8,), k=2, keig=7, mlp_channels=(8,),
                                device="cpu", seed=0)
    return Trainer(model, TrainerConfig(task="regression", ckpt_dir=str(tmp_path / "ck"),
                                        **cfg), device="cpu")


@pytest.fixture(scope="module")
def batches():
    return [collate_dense_packed(zinc_like_samples(np.random.default_rng(s), 4, keig=8))
            for s in range(2)]


def test_auto_resume(tmp_path, batches):
    t1 = _one_batch_trainer(tmp_path, save_gate=None)
    t1.fit(lambda: batches[:1], lambda: batches[1:], epochs=3, verbose=False)
    saved_epochs = [h["epoch"] for h in t1.history if h["improved"]]
    assert saved_epochs, "no checkpoint was written"
    t2 = _one_batch_trainer(tmp_path, save_gate=None)
    assert t2.maybe_restore() == saved_epochs[-1] + 1
    assert t2.best_metric == t1.best_metric
    assert t2.plateau.lr == t1.plateau.lr


def test_periodic_checkpoint_resumes_without_improvement(tmp_path, batches):
    cfg = dict(save_gate=-1.0, metric_mode="min", ckpt_every=2)  # impossible gate
    t1 = _one_batch_trainer(tmp_path, **cfg)
    t1.fit(lambda: batches[:1], lambda: batches[1:], epochs=4, verbose=False)
    assert not any(h["improved"] for h in t1.history)
    assert not os.path.exists(tmp_path / "ck" / "state.pt")
    t2 = _one_batch_trainer(tmp_path, **cfg)
    assert t2.maybe_restore() == 5  # the epoch-4 periodic save is the newest
    steps = {float(s["step"]) for s in t2.optimizer.state.values()}
    assert steps == {4.0}
    assert t2.best_metric == np.inf
    # prefer="best" (test, serving) ignores the periodic save
    assert _one_batch_trainer(tmp_path, **cfg).maybe_restore(prefer="best") == 1
    with pytest.raises(ValueError, match="prefer"):
        t2.maybe_restore(prefer="latest")
    # no ckpt_dir: nothing to restore
    model, _ = presets.zinc_pyr(channels=(1,), filters=(8,), k=2, keig=7, mlp_channels=(8,),
                                device="cpu")
    assert Trainer(model, TrainerConfig(), device="cpu").maybe_restore() == 1


def test_newest_picks_the_higher_epoch(tmp_path, batches):
    """Improvement at epoch 1 only, periodic saves at 1 and 2: the newest is
    latest/ (epoch 2), the best the improvement checkpoint (epoch 1)."""
    t1 = _one_batch_trainer(tmp_path, save_gate=None, ckpt_every=1)
    scores = iter([(1.0, 0.5), (1.0, 0.9)])
    t1.evaluate = lambda b: next(scores)  # a metric that improves once
    t1.fit(lambda: batches[:1], lambda: batches[1:], epochs=2, verbose=False)
    assert [h["improved"] for h in t1.history] == [True, False]
    assert _one_batch_trainer(tmp_path, save_gate=None).maybe_restore() == 3
    best = _one_batch_trainer(tmp_path, save_gate=None)
    assert best.maybe_restore(prefer="best") == 2 and best.best_metric == 0.5
    assert load_metadata(str(tmp_path / "ck" / "latest"))["best_metric"] == 0.5


def test_meta_json_has_the_jax_trainers_keys(tmp_path, batches):
    """The same run through both trainers (one batch an epoch, an
    improvement and a periodic save): the same meta.json keys."""
    cfg = dict(save_gate=None, ckpt_every=1)
    _one_batch_trainer(tmp_path / "port", **cfg).fit(
        lambda: batches[:1], lambda: batches[1:], epochs=1, verbose=False)
    from hl_hgat_tpu.models import BackboneConfig, HLHGCNNGraph

    jb = [jax.tree.map(jnp.asarray, jcollate(zinc_like_samples(np.random.default_rng(s), 4,
                                                                keig=8))) for s in range(2)]
    jmodel = HLHGCNNGraph(cfg=BackboneConfig(channels=(1,), filters=(8,), k=2, init_k=2),
                          num_classes=1)
    jt = JTrainer(jmodel, JTrainerConfig(task="regression", ckpt_dir=str(tmp_path / "jax"),
                                         **cfg))
    jt.fit(jt.init_state(jb[0]), lambda: jb[:1], lambda: jb[1:], epochs=1, verbose=False)
    for sub in ("", "latest"):
        ours = load_metadata(str(tmp_path / "port" / "ck" / sub))
        ref = load_metadata(str(tmp_path / "jax" / sub))
        assert ref and set(ours) == set(ref), sub
        assert ours["epoch"] == ref["epoch"] == 1 and ours["lr"] == ref["lr"]


# ---------------------------------------------------------------------------
# model-only files
# ---------------------------------------------------------------------------


def test_model_only_file_serves_and_tests_but_does_not_resume(tmp_path, batches):
    trainer = _one_batch_trainer(tmp_path, save_gate=None)
    trainer.fit(lambda: batches[:1], lambda: batches[1:], epochs=1, verbose=False)
    only = tmp_path / "only"
    save_checkpoint(str(only), {"model": trainer.model.state_dict()},
                    extra=dict(epoch=1, metric=0.5, lr=1e-3))
    assert set(load_state(str(only))) == {"model"}
    samples = zinc_like_samples(np.random.default_rng(8), 5, keig=8)
    model, _ = presets.zinc_pyr(channels=(1,), filters=(8,), k=2, keig=7, mlp_channels=(8,),
                                device="cpu", seed=9)
    served = Predictor.from_checkpoint(model, str(only), samples[:1], device="cpu")(samples)
    np.testing.assert_array_equal(
        served, Predictor(trainer.model, device="cpu")(samples))
    cfg = dict(ckpt_dir=str(only), save_gate=None)
    tester = Trainer(presets.zinc_pyr(channels=(1,), filters=(8,), k=2, keig=7,
                                      mlp_channels=(8,), device="cpu", seed=9)[0],
                     TrainerConfig(**cfg), device="cpu")
    assert tester.maybe_restore(prefer="best") == 2 and tester.best_metric == 0.5
    resumer = Trainer(presets.zinc_pyr(channels=(1,), filters=(8,), k=2, keig=7,
                                       mlp_channels=(8,), device="cpu")[0],
                      TrainerConfig(**cfg), device="cpu")
    with pytest.raises(ValueError, match=r"missing section\(s\) \['optimizer', 'generator', "
                                         r"'rng'\]"):
        resumer.fit(lambda: batches[:1], lambda: batches[1:], epochs=2, resume=True)
    with pytest.raises(ValueError, match="'model' section"):
        save_checkpoint(str(tmp_path / "bad"), {"optimizer": {}})


# ---------------------------------------------------------------------------
# the shipped JAX checkpoint, converted
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shipped():
    """(converter module, JAX CLI flags, JAX model, restored TrainState, meta)."""
    from scripts import convert_jax_checkpoint as conv

    args = conv.jax_args(conv.DEFAULT_CLI + ["--fold", "0"])
    jmodel, state, meta = conv.restore_jax(SHIPPED, args)
    return conv, args, jmodel, state, meta


def test_committed_conversion_equals_a_fresh_one(shipped):
    conv, args, _, state, meta = shipped
    sections = conv.convert(state, args, full=False)
    committed = load_state(CONVERTED)
    assert set(committed) == {"model"}
    _assert_same_tree(committed["model"], sections["model"])
    assert load_metadata(CONVERTED) == meta == load_metadata(SHIPPED)
    n = sum(v.numel() for k, v in committed["model"].items()
            if not k.endswith(("running_mean", "running_var")))
    assert n == sum(np.asarray(x).size for x in jax.tree.leaves(state.params)) == 6_885_009


def test_converted_forward_matches_the_jax_model(shipped):
    conv, args, jmodel, state, _ = shipped
    samples = zinc_like_samples(np.random.default_rng(0), 24, keig=16)
    ref = conv.jax_forward(jmodel, state, samples, batch_size=12)
    model = conv.port_model(args)
    pred = Predictor.from_checkpoint(model, CONVERTED, batch_size=12, device="cpu")
    out = pred(samples)
    np.testing.assert_allclose(out, ref.reshape(out.shape), rtol=0, atol=1e-4)
    # the committed reference holds the same forward on these graphs
    committed = np.load(os.path.join(CONVERTED, "jax_reference.npz"))["out"]
    np.testing.assert_allclose(committed[:24], ref.reshape(out.shape), rtol=0, atol=1e-6)


def _flat(tree):
    return {tuple(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(got, ref):
    """Whole-vector relative error over the leaves of ``ref``."""
    a = np.concatenate([ref[p].ravel() for p in ref])
    b = np.concatenate([got[p].ravel() for p in ref])
    return float(np.linalg.norm(b - a) / np.linalg.norm(a))


def test_converted_full_state_steps_like_the_jax_trainer(shipped, tmp_path):
    """One training step from the converted full state against one JAX
    ``_train_step`` from the restored state.

    The losses agree within rtol 1e-4.  The train-mode gradient (BN on
    batch statistics) of these trained weights is ill-conditioned: the
    port's own gradient moves by 4.9e-3 of its norm when the PE inputs
    change by 1e-6 relative, and the two packages' gradients differ by
    4.0e-3 (measured); so that gradient is held as a whole vector (2e-2),
    the eval-mode gradient element for element, and the optimizer state
    (moments, count, lr, weight decay) by one Adam update of both packages
    from the same gradient, element for element at rtol 1e-4."""
    conv, args, jmodel, state, _ = shipped
    sections = conv.convert(state, args, full=True)
    assert set(sections) == set(FULL_SECTIONS)
    save_checkpoint(str(tmp_path / "full"), sections, extra=dict(epoch=1))

    def port_trainer():
        t = Trainer(conv.port_model(args), TrainerConfig(lr=args.lr, weight_decay=args.l2),
                    device="cpu")
        restore_checkpoint(str(tmp_path / "full"), t)
        return t

    port = port_trainer()
    assert {float(s["step"]) for s in port.optimizer.state.values()} == {2.0}
    assert port.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3)
    samples = zinc_like_samples(np.random.default_rng(6), 8, keig=16)
    jbatch = jax.tree.map(jnp.asarray, jcollate(samples))
    jt = JTrainer(jmodel, JTrainerConfig(lr=args.lr, weight_decay=args.l2))
    _, jloss = jt._train_step(jax.tree.map(lambda x: x.copy(), state), jbatch)
    loss = port.train_step(collate_dense_packed(samples))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)

    def jgrad(train):
        def f(params):
            out, _ = jt._apply(params, state.batch_stats, jbatch, train=train,
                               rng=jax.random.key(0) if train else None)
            return jt._loss_fn(out, jbatch)
        return jax.grad(f)(state.params)

    jg = jgrad(True)
    got = to_flax_paths(port.model, {n: p.grad for n, p in port.model.named_parameters()})
    assert _rel(got, _flat(jg)) < 2e-2
    # eval mode: BN on running statistics, well conditioned
    evaluated = port_trainer()
    batch = collate_dense_packed(samples).to("cpu")
    evaluated.model.eval()
    _, eval_loss = evaluated._forward_loss(batch)
    eval_loss.backward()
    got = to_flax_paths(evaluated.model,
                        {n: p.grad for n, p in evaluated.model.named_parameters()})
    ref = _flat(jgrad(False))
    assert _rel(got, ref) < 1e-5
    for path in ref:
        scale = max(float(np.abs(ref[path]).max()), 1e-30)
        assert np.abs(got[path] - ref[path]).max() <= 1e-4 * scale, path
    # one Adam update of each package from the JAX gradient
    updates, opt_state = jt.tx.update(jg, state.opt_state, state.params)
    params = jax.tree.map(lambda p, u: p + u, state.params, updates)
    stepped = port_trainer()
    grads = from_flax_variables({"params": jg})
    for name, p in stepped.model.named_parameters():
        p.grad = grads[name].clone()
    stepped.optimizer.step()
    named = dict(stepped.model.named_parameters())
    got = to_flax_paths(stepped.model, named)
    ref = _flat(params)
    assert set(got) == set(ref)
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], rtol=1e-4, atol=1e-7,
                                   err_msg="/".join(path))
    _, mu, nu, _ = conv._adam_state(opt_state)
    for name, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        ref = _flat(tree)
        got = to_flax_paths(stepped.model, {n: stepped.optimizer.state[p][name]
                                            for n, p in named.items()})
        for path in ref:
            np.testing.assert_allclose(got[path], ref[path], rtol=1e-4,
                                       atol=1e-6 * float(np.abs(ref[path]).max()),
                                       err_msg=f"{name} {'/'.join(path)}")
    assert {float(s["step"]) for s in stepped.optimizer.state.values()} == {3.0}
