"""Inception1D, the fMRI time-course embedding (``hl_hgat_tpu/nn/inception.py``;
reference lib/Hodge_Cheb_Conv.py:317-362).

Stem Conv1d(1→C, k=5) → stage 1 (kernels 1/3/5 → C/4, C/2, C/4) → masked
BN → LeakyReLU → MaxPool1d(3, stride 2, pad 1) → stage 2 (1/3/5 → nc, 2nc,
nc) → masked BN → LeakyReLU(0.1) → the readout over the time axis:
``"mean"`` (the main lib) or ``"max_mean"``, max and mean concatenated (the
DEMO fork, HL-HGAT-DEMO/lib/Hodge_Cheb_Conv.py:512-514, 2× wider).  Both
brain models read out, so the JAX module's ``if_readout=False`` path and
its ``maxpool``/``leaky_slope`` options, which no model sets, are not
ported.

The JAX module is features-last ([N, T, C], ``nn.Conv`` with "SAME"
padding); this one runs ``nn.Conv1d`` on [N, C, T] with padding k // 2, the
same function.  The convolutions run in ``compute_dtype`` (weights cast to
it, parameters float32); BN statistics are float32 whatever it is, through
``MaskedBatchNorm`` on the [N, T, C] view with the [N] row mask.  A flax
``nn.Conv`` kernel [k, in, out] is the transpose of Conv1d's [out, in, k]
(``weights.from_flax_variables``).  The convolutions stay in torch, as the
JAX package left them to XLA: no Pallas kernel computes them.

On the card the forward turns on cuDNN's autotuner
(``torch.backends.cudnn.benchmark``, a process-wide flag; no other module
of the port runs a cuDNN convolution).  With its default heuristics cuDNN
takes FFT algorithms for the float32 backward, which at the brain batch
(16 subjects × 268 ROIs, T = 128) need about 45 GB of workspace on an
H100 every step; the autotuner's choice needs under 3 GB and less time,
though its trials, once a shape in the first step, may take as much
(``scripts/brain_probe.py --only cudnn``, which clears ``_CUDNN_AUTOTUNE``
to time the heuristics).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from hl_hgat_tpu_torch.nn.norm import MaskedBatchNorm


_CUDNN_AUTOTUNE = True


class _Conv(nn.Conv1d):
    """"SAME"-padded Conv1d computing in its input's dtype; torch's default
    init (U(±1/√fan_in) for weight and bias) from ``generator``."""

    def __init__(self, c_in: int, c_out: int, k: int, generator=None):
        super().__init__(c_in, c_out, k, padding=k // 2)
        bound = 1.0 / math.sqrt(c_in * k)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        padding=self.padding)


class Inception1D(nn.Module):
    def __init__(
        self, in_channels: int = 64, num_channels: int = 8, *, readout_mode: str = "mean",
        compute_dtype: str = "float32", generator=None,
    ):
        super().__init__()
        if readout_mode not in ("mean", "max_mean"):
            raise ValueError(f"unknown readout_mode {readout_mode!r}")
        c, nc = in_channels, num_channels
        self.readout_mode = readout_mode
        self.compute_dtype = compute_dtype
        self.embedding = _Conv(1, c, 5, generator)
        self.channel1_1 = _Conv(c, c // 4, 1, generator)
        self.channel2_1 = _Conv(c, c // 2, 3, generator)
        self.channel3_1 = _Conv(c, c // 4, 5, generator)
        self.bn1 = MaskedBatchNorm(c)
        self.channel1_2 = _Conv(c, nc, 1, generator)
        self.channel2_2 = _Conv(c, nc * 2, 3, generator)
        self.channel3_2 = _Conv(c, nc, 5, generator)
        self.bn2 = MaskedBatchNorm(nc * 4)
        self.out_features = nc * (8 if readout_mode == "max_mean" else 4)

    def _bn_act(self, bn, x, mask):
        # BN over channels-last rows [N, T, C] with the [N] mask
        x = bn(x.transpose(1, 2), mask).transpose(1, 2)
        return F.leaky_relu(x, 0.1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """x [N, T] raw time series, mask [N] row validity → [N, out_features]."""
        if x.is_cuda and _CUDNN_AUTOTUNE:
            torch.backends.cudnn.benchmark = True
        x = x.to(getattr(torch, self.compute_dtype))[:, None, :]  # [N, 1, T]
        x = self.embedding(x)
        x = torch.cat([self.channel1_1(x), self.channel2_1(x), self.channel3_1(x)], dim=1)
        x = self._bn_act(self.bn1, x, mask)
        x = F.max_pool1d(x, 3, stride=2, padding=1)
        x = torch.cat([self.channel1_2(x), self.channel2_2(x), self.channel3_2(x)], dim=1)
        x = self._bn_act(self.bn2, x, mask)
        if self.readout_mode == "max_mean":
            return torch.cat([x.amax(dim=-1), x.mean(dim=-1)], dim=-1)
        return x.mean(dim=-1)
