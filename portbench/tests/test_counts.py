"""Work counts: the kernel table's formulas by hand, the operator nonzeros
against dense Laplacians, and the model's products against
``torch.utils.flop_counter.FlopCounterMode`` run over the reference."""

from __future__ import annotations

import numpy as np
import pytest
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, weights
from portbench.reference import ops, zinc_pyr
from portbench.tests.conftest import small_cell
from portbench.traffic import zinc_like


def test_laguerre_formulas_by_hand():
    # G = 2 blocks of S = 4 rows, C = 3, F = 5, K = 3
    assert counts.laguerre_flops(2, 4, 3, 5, 3) == 2 * 2 * 4 * (4 * 3 * 2 + 3 * 3 * 5)
    # backward: K products g·W_kᵀ and T_kᵀ·g, K − 1 with Lᵀ
    assert counts.laguerre_flops(2, 4, 3, 5, 3, backward=True) == 2 * 2 * 4 * (4 * 3 * 2
                                                                               + 2 * 3 * 3 * 5)
    # L 2·16, x 24, W 45, b 5, out 40 floats; a shared L is read once
    assert counts.laguerre_bytes(2, 4, 3, 5, 3) == 4 * (32 + 24 + 45 + 5 + 40)
    assert counts.laguerre_bytes(2, 4, 3, 5, 3, shared=True) == 4 * (16 + 24 + 45 + 5 + 40)
    # backward: L, the 3 terms, W, g in; dx, dW, db out
    assert counts.laguerre_bytes(2, 4, 3, 5, 3, backward=True) == 4 * (32 + 3 * 24 + 45 + 40
                                                                       + 24 + 45 + 5)
    # a conv at 3xTF32's peak: compute-bound, FLOPs over 495/3 TFLOP/s
    big = counts.conv_bound_s((78, 128, 128), (78, 128, 256), (6, 256, 256), backward=False)
    assert big == pytest.approx(counts.laguerre_flops(78, 128, 256, 256, 6) / 165e12)


def test_operator_nonzeros_match_dense():
    mols = zinc_like.molecules(np.random.default_rng(4), 6)
    got = zinc_pyr.shape_of(mols)
    nnz0 = nnz1 = 0
    for m in mols:
        b1 = np.zeros((m["n"], m["src"].size))
        b1[m["src"], np.arange(m["src"].size)] = -1
        b1[m["dst"], np.arange(m["src"].size)] = 1
        nnz0 += np.count_nonzero(b1 @ b1.T)
        nnz1 += np.count_nonzero(b1.T @ b1)
    assert (got["nnz0"], got["nnz1"]) == (nnz0, nnz1)


def test_operator_flops_by_hand():
    # a triangle: L0 and L1 both 3 × 3 and full; K = 3 convs of 4 columns,
    # two applications each, forward; the backward repeats those whose input
    # needs a gradient
    apps = [(9, 4, True), (9, 4, True), (9, 4, False)]
    assert counts.operator_flops(apps, backward=False) == 3 * 2 * 9 * 4
    assert counts.operator_flops(apps, backward=True) == 2 * 2 * 9 * 4


def _flop_counter_total(loss_fn) -> int:
    with FlopCounterMode(display=False) as fc:
        loss_fn().backward()
    return fc.get_total_flops()


@pytest.mark.parametrize("workload", ["zinc_pyr.train.b2048", "hgat_attpool.train.b64"])
def test_products_match_flop_counter(workload, tmp_path, small_skeleton):
    cell = small_cell(workload, tmp_path)
    cell.config["data"]["rois"] = int(small_skeleton["num_node"][0])
    ad = cell.adapter
    raw = ad.draw_train(cell.config, cell.mix, 8, 1).get()[0]
    state = weights.make(ad.param_spec(cell.config), 8, "cpu")
    p = {k: v.double().requires_grad_(not k.endswith(("running_mean", "running_var")))
         for k, v in state.items()}
    loss_of = ad.reference_loss(cell.config, "cpu", ops.REFERENCE)
    measured = _flop_counter_total(lambda: loss_of(p, raw))
    prods = ad.REFERENCE.products(cell.config["model"], ad.shape(cell.config, raw))
    assert measured == counts.product_flops(prods, backward=False) + counts.product_flops(
        prods, backward=True)
    assert counts.model_flops(ad.REFERENCE, cell.config["model"], ad.shape(cell.config, raw),
                              train=True) > measured
