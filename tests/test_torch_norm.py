"""MaskedBatchNorm's batch statistics against float64 where the mean dwarfs
the spread (torch only): the variance is the mean squared deviation from the
mean, so the normalized output and its gradients keep float32 accuracy there,
where E[x²] − E[x]² in float32 would keep no digit of the spread."""

import numpy as np
import pytest
import torch

from hl_hgat_tpu_torch.nn.norm import EPS, MaskedBatchNorm


def _inputs(masked: bool):
    rng = np.random.default_rng(7)
    # 4 channels at 3 with a spread of 0.01 (variance 1e-4, ten times EPS)
    x = (3.0 + 0.01 * rng.standard_normal((50, 1000, 4))).astype(np.float32)
    mask = (rng.random((50, 1000)) > 0.2).astype(np.float32) if masked else None
    return x, mask


def _reference(x, mask, g):
    """The normalized output, its input gradient and the unbiased variance
    in float64."""
    x64 = torch.from_numpy(x).double().requires_grad_(True)
    m = torch.ones(x.shape[:-1], dtype=torch.float64) if mask is None else \
        torch.from_numpy(mask).double()
    m = m[..., None]
    n = m.sum()
    mean = (x64 * m).sum((0, 1)) / n
    var = (((x64 - mean) * m) ** 2).sum((0, 1)) / n
    y = (x64 - mean) / torch.sqrt(var + EPS) * m
    (dx,) = torch.autograd.grad((y * g.double()).sum(), x64)
    return y.detach(), dx, var.detach() * n / (n - 1)


@pytest.mark.parametrize("masked", [False, True])
def test_batch_statistics_hold_a_large_mean_with_a_small_spread(masked):
    x, mask = _inputs(masked)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(x.shape).astype(np.float32))
    bn = MaskedBatchNorm(4).train()
    bn.running_var.zero_()  # so that it holds a tenth of the batch's unbiased variance
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt, None if mask is None else torch.from_numpy(mask))
    (dx,) = torch.autograd.grad((y * g).sum(), xt)
    y_ref, dx_ref, var_ref = _reference(x, mask, g)
    rel = float((y.double() - y_ref).norm() / y_ref.norm())
    rel_dx = float((dx.double() - dx_ref).norm() / dx_ref.norm())
    # two passes read about 2e-5 and 4e-7 here, one pass about 7e-3 and 9e-3
    assert rel < 1e-4, rel
    assert rel_dx < 1e-4, rel_dx
    unbiased = bn.running_var.double() / 0.1
    assert float((unbiased / var_ref - 1).abs().max()) < 1e-3
