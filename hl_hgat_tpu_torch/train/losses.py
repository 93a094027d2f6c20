"""Losses (``hl_hgat_tpu/train/losses.py``).  All take an optional element
mask so padded simplices or graphs never contribute; reductions divide by
the valid count (torch 'mean' semantics over the unpadded batch).

L1 (reference main_zinc...py:213), CrossEntropy (main_cifar10SP...py:203),
FocalLoss ×1e4 (lib/Loss_function.py:14-26 — a GLOBAL focal term built from
the mean BCE, not per-element), SoftDice and weighted MSE
(lib/Loss_function.py:29-47).
"""

from __future__ import annotations

import torch


def _masked_mean(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Mean over valid elements; mask broadcasts over trailing dims."""
    if mask is None:
        return x.mean()
    m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim)).to(x.dtype)
    denom = m.sum() * (x.numel() / m.numel())
    return (x * m).sum() / denom.clamp(min=1.0)


def l1_loss(pred, target, mask=None) -> torch.Tensor:
    return _masked_mean((pred - target).abs(), mask)


def mse_loss(pred, target, mask=None) -> torch.Tensor:
    return _masked_mean((pred - target) ** 2, mask)


def softmax_ce_loss(logits, labels, mask=None) -> torch.Tensor:
    """labels: int class ids [N]."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None].long())[:, 0]
    return _masked_mean(nll, mask)


def bce_logits_loss(logits, targets, mask=None) -> torch.Tensor:
    """BCEWithLogits, numerically stable (logits clipped to ±30)."""
    z = logits.clamp(-30.0, 30.0)
    per = z.clamp(min=0) - z * targets + torch.log1p(torch.exp(-z.abs()))
    return _masked_mean(per, mask)


def focal_loss(
    logits, targets, mask=None, *, alpha: float = 0.25, gamma: float = 2.0,
    scale: float = 1e4,
) -> torch.Tensor:
    """The reference's global focal term: ``logpt = −mean BCE``,
    ``loss = −(1−e^{logpt})^γ · α · logpt · scale``
    (reference lib/Loss_function.py:21-25)."""
    logpt = -bce_logits_loss(logits, targets, mask)
    pt = torch.exp(logpt)
    return -((1.0 - pt) ** gamma) * alpha * logpt * scale


def soft_dice_loss(logits, targets, mask=None, *, smooth: float = 1.0) -> torch.Tensor:
    """reference lib/Loss_function.py:29-43."""
    probs = torch.sigmoid(logits).reshape(-1)
    t = targets.reshape(-1).to(probs.dtype)
    if mask is not None:
        m = mask.reshape(-1).to(probs.dtype)
        probs, t = probs * m, t * m
    inter = (probs * t).sum()
    score = 2.0 * (inter + smooth) / (probs.sum() + t.sum() + smooth)
    return 1.0 - score


def weighted_mse_loss(pred, target, mask=None) -> torch.Tensor:
    """reference lib/Loss_function.py:46-47 (sum-reduced)."""
    per = torch.exp(target.abs()) * (pred - target) ** 2
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (per.ndim - mask.ndim))
        per = per * m.to(per.dtype)
    return per.sum()
