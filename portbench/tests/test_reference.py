"""The plain reference against the port on the CPU, at small sizes: the
forward in both BN modes and three training steps (losses, the first
gradient, the parameters' change)."""

from __future__ import annotations

import pytest
import torch

from portbench import compare, weights
from portbench.drivers import train
from portbench.reference import ops
from portbench.tests.conftest import small_cell


def test_zinc_forward_matches_port(tmp_path):
    cell = small_cell("zinc_pyr.train.b2048", tmp_path)
    ad = cell.adapter
    raw = ad.draw_train(cell.config, cell.mix, 5, 1).get()[0]
    state = weights.make(ad.param_spec(cell.config), 5, "cpu")
    model = ad.program_model(cell.config, state, "cpu")
    batch = ad.program_batch(cell.config, raw).to("cpu")
    ref_batch = ad.ref.make_batch(raw, "cpu")
    p64 = {k: v.double() for k, v in state.items()}
    for train_mode in (False, True):
        model.train(train_mode)
        with torch.no_grad():
            ours = model(batch).reshape(-1).double()
        ref = ad.ref.forward(p64, ref_batch, cell.config["model"], train=train_mode,
                             prec=ops.REFERENCE)
        assert (ours - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("workload", ["zinc_pyr.train.b2048", "hgat_attpool.train.b64"])
def test_first_steps_match_port(workload, tmp_path, small_skeleton):
    cell = small_cell(workload, tmp_path)
    cell.config["data"]["rois"] = int(small_skeleton["num_node"][0])
    prog = train.set_up(cell, 2**31 + 17, "cpu", workers=1)
    ref = train.reference_steps(cell, prog.raw, prog.state, "cpu")
    got = compare.train_numbers(prog.losses, prog.first_grad, prog.state, prog.p_steps, ref)
    assert got["first_loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-3
    assert got["change_gap"] < 1e-2


def test_hgat_gates_match_port(tmp_path, small_skeleton):
    cell = small_cell("hgat_attpool.train.b64", tmp_path)
    cell.config["data"]["rois"] = int(small_skeleton["num_node"][0])
    ad = cell.adapter
    raw = ad.draw_train(cell.config, cell.mix, 9, 1).get()[0]
    state = weights.make(ad.param_spec(cell.config), 9, "cpu")
    model = ad.program_model(cell.config, state, "cpu").train()
    with torch.no_grad():
        pred, _, node_att, edge_att = model(ad.program_batch(cell.config, raw).to("cpu"))
    m = cell.config["model"]
    pyr = ad.ref.pyramid(small_skeleton, "cpu", m["pool_num"], m["deg_eps"])
    batch = ad.ref.make_batch(raw[0], raw[1], small_skeleton, "cpu")
    r_pred, r_node, r_edge = ad.ref.forward({k: v.double() for k, v in state.items()}, batch,
                                            pyr, m, train=True, prec=ops.REFERENCE)
    assert (pred.reshape(-1).double() - r_pred).abs().max() <= 1e-5 * r_pred.abs().max()
    assert (node_att.double() - r_node).abs().max() <= 1e-5
    assert (edge_att.double() - r_edge).abs().max() <= 1e-5
