"""The NaN-check switch that the hand kernels' wrappers read.

``utils.profiling.enable_nan_checks`` turns it on together with its
dispatch mode, which checks every torch op.  A hand kernel is not a torch
op, so its wrapper calls ``check_kernel_outputs`` after the launch.
"""

from __future__ import annotations

from collections.abc import Iterable

import torch

enabled = False  # set by utils.profiling.enable_nan_checks


def raise_on_nan(what, tensors: Iterable) -> None:
    """Raise ``FloatingPointError`` if a floating tensor among ``tensors``
    holds a NaN (each is read back, so this waits for the card)."""
    for t in tensors:
        if (isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()
                and bool(torch.isnan(t).any())):
            raise FloatingPointError(f"NaN in the output of {what}")


def check_kernel_outputs(name: str, *outputs: torch.Tensor) -> None:
    """Raise ``FloatingPointError`` if NaN checks are on and a hand
    kernel's output holds a NaN (called by the wrappers after a launch)."""
    if enabled:
        raise_on_nan(name, outputs)
