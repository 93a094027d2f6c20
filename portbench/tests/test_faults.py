"""Runs of small cells on the CPU, held to the cells' own limits: a sound run
comes out correct, and so does not a run whose timed path is broken
underneath (the look for a card skipped; the rest of the run as on the
card).  One case a fault the cell can have: a training step that returns
its state unchanged; a step on half of the batch, the mean over the rest;
a served answer altered where the predictor makes it.  (No cell spans
chips, so none leaves out an exchange between them.)"""

from __future__ import annotations

import numpy as np
import pytest

from portbench.reference import ops
from portbench.tests.conftest import small_cell

TRAIN = ["zinc_pyr.train.b2048", "hgat_attpool.train.b64"]


def _run(cell):
    return cell.driver.run(cell, 2**31 + 29, 0.5, False, "cpu", 0.0, workers=1)


def _small(name, tmp_path, skel):
    cell = small_cell(name, tmp_path)
    cell.config["data"]["rois"] = int(skel["num_node"][0])
    return cell


@pytest.mark.parametrize("name", ["zinc_pyr.train.b2048", "zinc_pyr.serve.r1024"])
def test_sound_run_is_correct(name, tmp_path, small_skeleton):
    rec = _run(_small(name, tmp_path, small_skeleton))
    assert rec.correct, rec.checks


def _patch_trainer(cell, monkeypatch, patch):
    make = cell.adapter.program_trainer

    def patched(cfg, model, device):
        trainer = make(cfg, model, device)
        patch(trainer)
        return trainer
    monkeypatch.setattr(cell.adapter, "program_trainer", patched)


@pytest.mark.parametrize("name", TRAIN)
def test_unchanged_state_is_caught(name, tmp_path, monkeypatch, small_skeleton):
    cell = _small(name, tmp_path, small_skeleton)
    _patch_trainer(cell, monkeypatch,
                   lambda t: setattr(t.optimizer, "step", lambda *a, **k: None))
    rec = _run(cell)
    assert not rec.correct
    assert rec.checks["change_gap"][0] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_is_caught(name, tmp_path, monkeypatch, small_skeleton):
    cell = _small(name, tmp_path, small_skeleton)

    def half(trainer):
        loss = trainer._loss_fn

        def first_half(out, batch):
            g = batch.num_graphs // 2
            return loss(out[:g], batch.replace(y=batch.y[:g]))
        trainer._loss_fn = first_half
    _patch_trainer(cell, monkeypatch, half)
    assert not _run(cell).correct


def test_altered_answer_is_caught(tmp_path, monkeypatch):
    cell = small_cell("zinc_pyr.serve.r1024", tmp_path)
    make = cell.adapter.program_predictor

    def patched(cfg, model, mix, device):
        predictor = make(cfg, model, mix, device)
        call = predictor.__call__

        class Altered:
            def __getattr__(self, name):
                return getattr(predictor, name)

            def __call__(self, samples):
                out = call(samples)
                out[len(out) // 2] += 1.0
                return out
        return Altered()
    monkeypatch.setattr(cell.adapter, "program_predictor", patched)
    assert not _run(cell).correct


@pytest.mark.parametrize("name", TRAIN)
def test_control_fails_a_limit(name, tmp_path, small_skeleton):
    """The reference computed in TF32, put in the port's place, fails at
    least one of the cell's limits."""
    from portbench import compare, weights
    from portbench.drivers import train

    cell = _small(name, tmp_path, small_skeleton)
    raw = cell.adapter.draw_train(cell.config, cell.mix, 31, 1).get()
    state = weights.make(cell.adapter.param_spec(cell.config), 31, "cpu")
    ref = train.reference_steps(cell, raw, state, "cpu")
    got = train.reference_steps(cell, raw, state, "cpu", prec=ops.CONTROL)
    numbers = compare.train_numbers(got["losses"], got["seen"], state, got["params"], ref)
    assert any(v > cell.limits[k] for k, v in numbers.items()), numbers


def test_control_fails_the_serving_limit(tmp_path):
    from portbench import compare
    from portbench.drivers import serve

    cell = small_cell("zinc_pyr.serve.r1024", tmp_path)
    prog = serve.set_up(cell, 37, "cpu", 3, workers=1)
    ref = serve.reference_answers(cell, prog, range(3), "cpu")
    got = serve.reference_answers(cell, prog, range(3), "cpu", prec=ops.CONTROL)
    gap = compare.serve_numbers(np.asarray(got), ref)["pred_gap"]
    assert gap > cell.limits["pred_gap"]
