"""The reference's first training steps, from the same weights and batches as
the port's: autograd on the plain model, then torch-style Adam with L2."""

from __future__ import annotations

import torch

from portbench.reference import ops


def first_steps(weights: dict, trainable: list[str], loss_of, batches, *, lr: float,
                weight_decay: float, prec: ops.Precision) -> dict:
    """``len(batches)`` steps of ``loss_of(params, batch)``.  Returns the
    losses, the first step's gradients without (``raw``) and with
    (``seen``) the L2 term, and the parameters after the last step."""
    p = {k: v.detach().to(prec.dtype).clone() for k, v in weights.items()}
    for name in trainable:
        p[name].requires_grad_(True)
    state, losses, raw, seen = {}, [], None, None
    for step, batch in enumerate(batches, start=1):
        loss = loss_of(p, batch)
        grads = torch.autograd.grad(loss, [p[n] for n in trainable])
        losses.append(float(loss.detach()))
        grads = dict(zip(trainable, grads))
        used = ops.adam_l2_step({n: p[n] for n in trainable}, grads, state, step, lr=lr,
                                weight_decay=weight_decay)
        if step == 1:
            raw, seen = grads, used
        del loss, grads
    return dict(losses=losses, raw=raw, seen=seen,
                params={n: p[n].detach() for n in trainable})
