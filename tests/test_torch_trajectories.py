"""The port's ``Trainer`` against the reference's executed training runs
(``tests/golden/reference/traj_*.npz``), at the bars the JAX package holds
itself to (``tests/test_reference_parity.py``: the zinc trajectories, the
second seed's band, TSP, the gated and pooled CIFAR10-SP attpool loop and
pepfunc).

Same data, same initial weights (the fixture's state dict through the
importer table), torch-Adam with L2 and the reference's plateau
(patience 3, factor 0.5, threshold 1e-3); every epoch runs
``Trainer.train_epoch`` (``train_step`` on each batch), ``evaluate`` on
the whole set and the plateau step, as ``Trainer.fit`` does.  The early
epochs are the parity signal; later ones diverge chaotically from float32
noise, so the tail is held to a basin bar, and the plateau's decisions to
the reference's own loss sequence, replayed.  ``traj_zinc`` also runs
through ``DataParallelTrainer`` at world size 1 (gloo, in this process).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from hl_hgat_tpu_torch.complex.build import build_complex, collate
from hl_hgat_tpu_torch.models.backbone import BackboneConfig, HLHGCNNGraph, HLHGCNNTsp
from hl_hgat_tpu_torch.train import Trainer, TrainerConfig
from hl_hgat_tpu_torch.train import losses as L
from hl_hgat_tpu_torch.train.optim import ReduceLROnPlateau, set_learning_rate
from hl_hgat_tpu_torch.utils.torch_import import _translate_hgcnn
from hl_hgat_tpu_torch.weights import from_flax_variables

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_pool_fixtures import (  # noqa: E402
    FIX_DIR,
    _load,
    _prefixed,
    _samples,
    _split_graphs,
)

pytestmark = pytest.mark.skipif(
    not os.path.isdir(FIX_DIR), reason="reference fixtures not generated")

ZINC = dict(channels=(2, 2), filters=(8, 16), k=3, init_k=3, deg_eps=0.0)


def _load_weights(model, fx, head):
    variables = {"params": {}, "batch_stats": {}}
    entries, _ = _translate_hgcnn(_prefixed(fx, "sd/"), head=head)
    for (col, path), val in entries.items():
        node = variables[col]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    model.load_state_dict(from_flax_variables(variables))
    return model


def _plain_samples(fx, y_per_edge=False):
    e_off = np.concatenate([[0], np.cumsum(fx["num_edge1"].astype(int))])
    out = []
    for i, g in enumerate(_split_graphs(fx)):
        y = fx["y"][e_off[i]:e_off[i + 1]] if y_per_edge else fx["y"][i:i + 1]
        out.append(build_complex(g["edge_index"], g["n"], x_t=g["x_t"], x_s=g["x_s"], y=y))
    return out


def _batches(fx, samples, **kw):
    bs = int(fx["batch_size"])
    return ([collate(samples[i:i + bs], multiple=1, **kw) for i in range(0, len(samples), bs)],
            collate(samples, multiple=1, **kw))


def _run(trainer, fx, batches, full, *, mode="min", extra=None):
    """The fixture's epochs through the trainer: (train losses, valid
    losses, metrics, lrs); ``extra(trainer, full)`` adds to the valid loss
    (the CIFAR eval's attention penalties)."""
    lr0 = trainer.optimizer.param_groups[0]["lr"]
    trainer.plateau = ReduceLROnPlateau(lr=lr0, patience=3, factor=0.5, min_lr=1e-6,
                                        threshold=1e-3, mode=mode)
    train, valid, metrics, lrs = [], [], [], []
    for _ in range(fx["train_losses"].shape[0]):
        train.append(trainer.train_epoch(batches))
        loss, metric = trainer.evaluate([full])
        if extra is not None:
            loss += extra(trainer, full)
        valid.append(loss)
        metrics.append(metric)
        lr = trainer.plateau.step(loss if mode == "min" else metric)
        set_learning_rate(trainer.optimizer, lr)
        lrs.append(lr)
    return train, valid, metrics, lrs


def _replay_lrs(fx, lr0, seq, mode="min"):
    """The reference's own metric sequence through the trainer's plateau."""
    plateau = ReduceLROnPlateau(lr=lr0, patience=3, factor=0.5, min_lr=1e-6, threshold=1e-3,
                                mode=mode)
    lrs = [plateau.step(float(v)) for v in seq]
    np.testing.assert_allclose(np.asarray(lrs), fx["lrs"], rtol=1e-12)
    assert fx["lrs"][-1] < fx["lrs"][0]


def _zinc_run(name, trainer_cls=Trainer):
    fx = _load(name)
    samples = _plain_samples(fx)
    batches, full = _batches(fx, samples)
    model = _load_weights(HLHGCNNGraph(BackboneConfig(**ZINC), samples[0].x_t.shape[1],
                                       samples[0].x_s.shape[1], mlp_channels=(8,),
                                       num_classes=1), fx, "graph")
    trainer = trainer_cls(model, TrainerConfig(task="regression", lr=3e-3, weight_decay=1e-3),
                          device="cpu")
    return fx, _run(trainer, fx, batches, full)


@pytest.fixture(scope="module")
def zinc_runs():
    return {name: _zinc_run(name) for name in ("traj_zinc", "traj_zinc_s2")}


def _final(seq):
    return float(np.mean(seq[-5:]))


def test_zinc_trajectory_matches_reference(zinc_runs):
    fx, (train, valid, _, lrs) = zinc_runs["traj_zinc"]
    np.testing.assert_allclose(train[:12], fx["train_losses"][:12], rtol=4e-3)
    np.testing.assert_allclose(valid[:12], fx["valid_losses"][:12], rtol=4e-3)
    ref_final = _final(fx["valid_losses"])
    seed_band = abs(ref_final - _final(zinc_runs["traj_zinc_s2"][0]["valid_losses"]))
    assert abs(_final(valid) - ref_final) < max(seed_band, 0.05 * ref_final)
    _replay_lrs(fx, 3e-3, fx["valid_losses"])


def test_zinc_second_seed_sits_in_the_noise_band(zinc_runs):
    finals = {name: _final(fx["valid_losses"]) for name, (fx, _) in zinc_runs.items()}
    seed_band = abs(finals["traj_zinc"] - finals["traj_zinc_s2"])
    for name, (fx, (train, valid, _, _)) in zinc_runs.items():
        np.testing.assert_allclose(train[:12], fx["train_losses"][:12], rtol=4e-3, err_msg=name)
        assert abs(_final(valid) - finals[name]) < max(seed_band, 0.02 * finals[name]), name


def test_zinc_trajectory_through_the_data_parallel_trainer_at_world_one(zinc_runs):
    """World 1 on gloo: the gradient and statistics averages are
    identities, so every epoch equals the plain trainer's bit for bit."""
    import torch.distributed as dist

    from hl_hgat_tpu_torch.parallel.distributed import free_port, init_distributed
    from hl_hgat_tpu_torch.parallel.dp_trainer import DataParallelTrainer

    assert init_distributed(0, 1, init_method=f"tcp://localhost:{free_port()}",
                            device_type="cpu")
    try:
        fx, (train, valid, _, lrs) = _zinc_run("traj_zinc", DataParallelTrainer)
    finally:
        dist.destroy_process_group()
    _, (ref_train, ref_valid, _, ref_lrs) = zinc_runs["traj_zinc"]
    assert train == ref_train and valid == ref_valid and lrs == ref_lrs
    np.testing.assert_allclose(train[:12], fx["train_losses"][:12], rtol=4e-3)


def test_tsp_trajectory_matches_reference():
    fx = _load("traj_tsp")
    samples = _plain_samples(fx, y_per_edge=True)
    batches, full = _batches(fx, samples, y_per_edge=True)
    model = _load_weights(HLHGCNNTsp(BackboneConfig(channels=(2, 2), filters=(8, 16), k=2,
                                                    init_k=2), samples[0].x_t.shape[1],
                                     samples[0].x_s.shape[1], mlp_channels=(8,),
                                     num_classes=1), fx, "tsp")
    trainer = Trainer(model, TrainerConfig(task="edge_binary", lr=1e-3, weight_decay=1e-3),
                      device="cpu")
    train, valid, _, _ = _run(trainer, fx, batches, full)
    # the x1e4 focal scale: the JAX test's shorter, looser early window
    np.testing.assert_allclose(train[:8], fx["train_losses"][:8], rtol=3e-2)
    np.testing.assert_allclose(valid[:8], fx["valid_losses"][:8], rtol=3e-2)
    assert abs(_final(valid) - _final(fx["valid_losses"])) / _final(fx["valid_losses"]) < 0.1
    _replay_lrs(fx, 1e-3, fx["valid_losses"])


def _pooled(fx, y, cfg, classes):
    samples = [dataclasses.replace(s, y=y[i:i + 1]) for i, s in enumerate(_samples(fx, True))]
    batches, full = _batches(fx, samples)
    model = _load_weights(HLHGCNNGraph(BackboneConfig(**cfg), samples[0].x_t.shape[1],
                                       samples[0].x_s.shape[1], mlp_channels=(8,),
                                       num_classes=classes), fx, "graph")
    return batches, full, model


def test_cifar_attpool_trajectory_matches_reference():
    """CE through max-normalized ReLU gates and pooling; the eval loss adds
    the attention L1 penalties; the plateau steps on accuracy (max mode)."""
    fx = _load("traj_cifar_attpool")
    cfg = dict(channels=(2, 2), filters=(8, 16), k=2, init_k=1, deg_eps=1e-6, pool_locs=(0,),
               att_sigma="relu", att_lam=0.5, att_dk=32, gate_input="last",
               gate_target="last", max_normalize_gates=True)
    batches, full, model = _pooled(fx, fx["y"].astype(np.float32), cfg, 4)
    trainer = Trainer(model, TrainerConfig(task="classification", lr=1e-3, weight_decay=1e-3),
                      device="cpu")
    gate_zero = []

    def penalty(tr, batch):
        with torch.inference_mode():
            b = tr._on_device(batch)
            _, _, atts = tr.model.backbone(b.x_t, b.x_s, b, return_atts=True)
        a_t, a_s = atts[0]
        gate_zero.append(min(float(a_t.max()), float(a_s.max())) == 0.0)
        return float(a_t.abs().mean() + a_s.abs().mean())

    train, valid, accs, _ = _run(trainer, fx, batches, full, mode="max", extra=penalty)
    # the reference's NaN eval epochs are the all-zero-gate epochs
    ref_nan = ~np.isfinite(fx["valid_losses"])
    assert ref_nan.any()
    np.testing.assert_array_equal(np.asarray(gate_zero), ref_nan)
    np.testing.assert_allclose(train[:6], fx["train_losses"][:6], rtol=1e-3)
    np.testing.assert_allclose(train[:12], fx["train_losses"][:12], rtol=2e-2)
    fin = np.isfinite(fx["valid_losses"][:12])
    np.testing.assert_allclose(np.asarray(valid[:12])[fin], fx["valid_losses"][:12][fin],
                               rtol=2e-2)
    assert np.abs(np.asarray(accs[:12]) - fx["valid_accs"][:12]).max() <= 1.0 / 12 + 1e-6
    assert abs(_final(valid) - _final(fx["valid_losses"])) / _final(fx["valid_losses"]) < 0.05
    assert abs(_final(accs) - _final(fx["valid_accs"])) <= 1.0 / 12 + 1e-6
    _replay_lrs(fx, 1e-3, fx["valid_accs"], mode="max")


def test_pepfunc_trajectory_matches_reference():
    """Focal ×1e4 on NaN-masked multilabel targets (the reference script's
    criterion, set as the trainer's loss), macro AP, the plateau on AP."""
    fx = _load("traj_pepfunc")
    y = fx["y"].astype(np.float32)
    assert np.isnan(y).any()
    cfg = dict(channels=(2, 2), filters=(8, 16), k=2, init_k=1, deg_eps=1e-6, pool_locs=(0,),
               att_locs=(0, 1), att_sigma="sigmoid", att_lam=0.5, att_dk=32,
               gate_input="stack", gate_target="stack")
    batches, full, model = _pooled(fx, y, cfg, 6)
    trainer = Trainer(model, TrainerConfig(task="multilabel", lr=1e-3, weight_decay=1e-3),
                      device="cpu")

    def masked_focal(out, batch):
        mask = ~torch.isnan(batch.y)
        return L.focal_loss(out, torch.nan_to_num(batch.y), mask)

    trainer._loss_fn = masked_focal
    train, valid, aps, _ = _run(trainer, fx, batches, full, mode="max")
    np.testing.assert_allclose(train[:8], fx["train_losses"][:8], rtol=3e-2)
    np.testing.assert_allclose(valid[:8], fx["valid_losses"][:8], rtol=3e-2)
    assert np.abs(np.asarray(aps[:8]) - fx["valid_aps"][:8]).max() < 0.06
    assert abs(_final(valid) - _final(fx["valid_losses"])) / _final(fx["valid_losses"]) < 0.15
    assert abs(_final(aps) - _final(fx["valid_aps"])) < 0.08
    _replay_lrs(fx, 1e-3, fx["valid_aps"], mode="max")
