"""CUDA kernels vs their plain versions on the card (skips without one).

Imports no jax, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from hl_hgat_tpu_torch.ops import laguerre_dense as lg

pytestmark = pytest.mark.gpu

# f32: no TF32 anywhere, only the summation order differs;
# bf16: same rounding points, a flipped rounding of a term is one bf16 ulp
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(g, s, c, f, k, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    l = rng.standard_normal((g, s, s)).astype(np.float32)
    l = (l + l.transpose(0, 2, 1)) / (2 * np.sqrt(s))  # symmetric, spectrum O(1)
    x = rng.standard_normal((g, s, c)).astype(np.float32)
    w = rng.uniform(-1, 1, (k, c, f)).astype(np.float32) * np.sqrt(6.0 / (c + f))
    b = rng.standard_normal(f).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(l).to(dtype), t(x).to(dtype), t(w), t(b)


def _check(out, ref, dtype):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * ref.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,s,c,f,k", [
    (3, 128, 64, 64, 6), (2, 128, 100, 72, 3), (5, 13, 7, 130, 1),
    (1, 96, 300, 8, 6), (4, 30, 33, 65, 2),
])
def test_fused_kernel_matches_plain(cuda, dtype, g, s, c, f, k):
    l, x, w, b = _inputs(g, s, c, f, k, dtype, cuda)
    before = lg.LAUNCHES["laguerre_dense_fused"]
    out = lg.laguerre_dense_fused(l, x, w, b)
    torch.cuda.synchronize()
    assert lg.LAUNCHES["laguerre_dense_fused"] == before + 1
    assert out.dtype == dtype and out.shape == (g, s, f)
    _check(out, lg.laguerre_dense_fused_plain(l, x, w, b), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,s,c,k", [(3, 128, 64, 6), (2, 128, 100, 3), (4, 13, 7, 2), (1, 64, 40, 1)])
def test_terms_kernel_matches_plain(cuda, dtype, g, s, c, k):
    l, x, _, _ = _inputs(g, s, c, 1, k, dtype, cuda)
    before = lg.LAUNCHES["laguerre_terms_dense"]
    out = lg.laguerre_terms_dense(l, x, k)
    torch.cuda.synchronize()
    assert lg.LAUNCHES["laguerre_terms_dense"] == before + 1
    assert out.dtype == dtype and out.shape == (k, g, s, c)
    _check(out, lg.laguerre_terms_dense_plain(l, x, k), dtype)


def test_wrappers_reject_what_the_kernel_cannot_take(cuda):
    l, x, w, b = _inputs(1, 136, 8, 8, 2, torch.float32, cuda)
    with pytest.raises(ValueError, match="block size"):
        lg.laguerre_dense_fused(l, x, w, b)
    l, x, w, b = _inputs(1, 16, 8, 8, 2, torch.float16, cuda)
    with pytest.raises(TypeError):
        lg.laguerre_terms_dense(l, x, 2)
