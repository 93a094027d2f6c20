"""The numbers that decide ``correct``, each a gap between the port's reading
and the plain reference's.

Training, over the first three steps the set-up drives (the reference
follows them from the same weights and batches):

* ``first_loss_gap``: |loss − loss_ref| / |loss_ref| of the first step.
  The later steps' losses are not compared: Adam's first updates are near
  ±lr whatever the gradient's size, so float32 rounding in gradients near 0
  moves them, and the reference itself computed in float32 departs from its
  float64 run by as much there (PERF.md gives the readings);
* ``grad_gap``: by the worst leaf, |‖g‖ − ‖g_ref‖| / max(‖g_ref‖, median
  leaf's ‖g_ref‖), g the first gradient as the optimizer took it (its first
  moment after one step over 1 − β1, the L2 term included);
* ``grad_median_gap``: the same gap of the median leaf;
* ``change_gap``: the same of ‖p_3 − p_0‖, the parameters' change over the
  steps, over the leaves whose reference loss gradient is at least a
  thousandth of the median leaf's (a bias ahead of a BN has a gradient of
  rounding alone, and Adam moves it by its sign).

Serving: ``pred_gap``, the largest |pred − pred_ref| over a sample of the
window's answers, over the sample's largest |pred_ref|.

A cell compares the numbers its ``limits/<cell>.json`` gives a limit.
"""

from __future__ import annotations

import torch

GRAD_FLOOR = 1e-3  # a leaf whose reference gradient is under this share of the median's


def _leaf_gaps(ours: dict, ref: dict) -> list[float]:
    """Per leaf, |‖ours‖ − ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖)."""
    a = {n: float(ours[n].double().norm()) for n in ref}
    b = {n: float(ref[n].double().norm()) for n in ref}
    med = float(torch.tensor(list(b.values())).median())
    return [abs(a[n] - b[n]) / max(b[n], med, 1e-300) for n in ref]


def train_numbers(losses, first_grad, p0, p_steps, ref) -> dict[str, float]:
    """``losses`` the port's per step, ``first_grad`` its first gradient by
    leaf, ``p0``/``p_steps`` its parameters before and after the steps;
    ``ref`` as ``reference.train.first_steps`` returns it."""
    first_loss_gap = abs(losses[0] - ref["losses"][0]) / abs(ref["losses"][0])
    grad = _leaf_gaps(first_grad, ref["seen"])
    raw = {n: float(g.double().norm()) for n, g in ref["raw"].items()}
    floor = GRAD_FLOOR * float(torch.tensor(list(raw.values())).median())
    counted = [n for n in raw if raw[n] >= floor]
    change = _leaf_gaps({n: p_steps[n].double() - p0[n].double() for n in counted},
                        {n: ref["params"][n] - p0[n].double() for n in counted})
    return dict(first_loss_gap=first_loss_gap, grad_gap=max(grad),
                grad_median_gap=float(torch.tensor(grad).median()), change_gap=max(change))


def serve_numbers(preds, ref_preds) -> dict[str, float]:
    ours = torch.as_tensor(preds, dtype=torch.float64, device=ref_preds.device).reshape(-1)
    ref = ref_preds.double().reshape(-1)
    return dict(pred_gap=float((ours - ref).abs().max() / ref.abs().max()))
