"""Optimizer and schedule (``hl_hgat_tpu/train/optim.py``).

``adam_l2`` is torch Adam with ``weight_decay``: L2 added to the gradient
BEFORE the moment updates (not decoupled AdamW), the optimizer of every
reference script (e.g. reference main_zinc...py:209).

``ReduceLROnPlateau`` is the package's own host-side state machine
(patience/factor/min_lr, relative threshold, reference
main_zinc...py:210-211), kept step for step like the JAX package's rather
than torch's scheduler; ``set_learning_rate`` writes its lr into the
optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch


def adam_l2(
    params: Iterable[torch.nn.Parameter],
    lr: float,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> torch.optim.Adam:
    return torch.optim.Adam(
        params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Plateau scheduler (torch semantics, rel threshold).

    ``mode='min'`` tracks a loss (improvement = ``m < best*(1-threshold)``);
    ``mode='max'`` tracks a score such as validation accuracy (improvement =
    ``m > best*(1+threshold)``)."""

    lr: float
    patience: int = 10
    factor: float = 0.5
    min_lr: float = 1e-6
    threshold: float = 1e-4
    mode: str = "min"

    best: float | None = None
    num_bad: int = 0

    def __post_init__(self) -> None:
        if self.mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {self.mode!r}")
        if self.best is None:
            self.best = float("inf") if self.mode == "min" else float("-inf")

    def _improved(self, metric: float) -> bool:
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def step(self, metric: float) -> float:
        """Feed the validation metric; returns the (possibly reduced) lr."""
        if self._improved(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr
