"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The CUDA card unless ``device`` names another; never a quiet fallback.

    ``None`` means the card: without one this raises, so a run that was
    meant for the GPU cannot silently measure the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
