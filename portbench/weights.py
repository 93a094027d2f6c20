"""Seeded weights made on the device, handed to the port and the reference alike.

A parameter spec lists (name, shape, (centre, half width)); one
``torch.rand`` call on a generator seeded with the run's seed fills every
entry in float32, the dtype both configurations are served in.
"""

from __future__ import annotations

import math

import torch


def make(spec, seed: int, device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device, dtype=dtype).mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for name, shape, (centre, half) in spec:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape).mul(half).add_(centre)
        off += n
    return out
