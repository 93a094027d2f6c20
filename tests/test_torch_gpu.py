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


# backward shapes: a main-path one, the ragged one, K = 1, small odd blocks
_BWD_SHAPES = [
    (3, 128, 64, 64, 6), (2, 128, 100, 72, 3), (5, 13, 7, 130, 1),
    (7, 96, 70, 8, 6), (4, 30, 33, 65, 2), (2, 128, 64, 64, 1),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,s,c,f,k", _BWD_SHAPES)
def test_fused_bwd_kernel_matches_plain(cuda, dtype, g, s, c, f, k):
    l, x, w, _ = _inputs(g, s, c, f, k, dtype, cuda)
    cot = torch.from_numpy(
        np.random.default_rng(1).standard_normal((g, s, f)).astype(np.float32)
    ).to(cuda).to(dtype)
    before = lg.LAUNCHES["laguerre_dense_fused_bwd"]
    dx, dw, db = lg.laguerre_dense_fused_bwd(l, x, w, cot)
    torch.cuda.synchronize()
    assert lg.LAUNCHES["laguerre_dense_fused_bwd"] == before + 1
    assert dx.dtype == dtype and dx.shape == (g, s, c)
    assert dw.dtype == db.dtype == torch.float32
    assert dw.shape == (k, c, f) and db.shape == (f,)
    rdx, rdw, rdb = lg.laguerre_dense_fused_bwd_plain(l, x, w, cot)
    _check(dx, rdx, dtype)
    _check(dw, rdw, dtype)
    _check(db, rdb, dtype)
    # fixed summation order: a second run gives the same bits
    dx2, dw2, db2 = lg.laguerre_dense_fused_bwd(l, x, w, cot)
    assert torch.equal(dw, dw2) and torch.equal(db, db2) and torch.equal(dx, dx2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,s,c,k", [(3, 128, 64, 6), (2, 128, 100, 3), (4, 13, 7, 2), (1, 64, 40, 1)])
def test_terms_bwd_kernel_matches_plain(cuda, dtype, g, s, c, k):
    l, _, _, _ = _inputs(g, s, c, 1, k, dtype, cuda)
    dt = torch.from_numpy(
        np.random.default_rng(2).standard_normal((k, g, s, c)).astype(np.float32)
    ).to(cuda).to(dtype)
    before = lg.LAUNCHES["laguerre_terms_dense_bwd"]
    dx = lg.laguerre_terms_dense_bwd(l, dt, k)
    torch.cuda.synchronize()
    assert lg.LAUNCHES["laguerre_terms_dense_bwd"] == before + 1
    assert dx.dtype == dtype and dx.shape == (g, s, c)
    _check(dx, lg.laguerre_terms_dense_bwd_plain(l, dt, k), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_reaches_the_backward_kernels(cuda, dtype):
    """loss.backward() through both public functions launches the backward
    kernels, takes an expanded (non-contiguous) cotangent, and agrees with
    the CPU path (plain forward, plain backward)."""
    l, x, w, b = _inputs(3, 128, 40, 24, 4, dtype, cuda)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    cpu = [t.detach().cpu().requires_grad_() for t in leaves]
    lg.reset_launch_counts()
    lg.laguerre_dense_fused(l, *leaves).float().sum().backward()
    lg.laguerre_dense_fused(l.cpu(), *cpu).float().sum().backward()
    assert lg.LAUNCHES["laguerre_dense_fused_bwd"] == 1
    assert l.grad is None
    for a, r in zip(leaves, cpu):
        assert a.grad.dtype == a.dtype
        _check(a.grad.cpu(), r.grad, dtype)
    xt, xc = x.clone().requires_grad_(), x.detach().cpu().requires_grad_()
    lg.laguerre_terms_dense(l, xt, 4).float().sum().backward()
    lg.laguerre_terms_dense(l.cpu(), xc, 4).float().sum().backward()
    assert lg.LAUNCHES["laguerre_terms_dense_bwd"] == 1
    _check(xt.grad.cpu(), xc.grad, dtype)


def test_backward_wrappers_reject_what_the_kernels_cannot_take(cuda):
    l, x, w, _ = _inputs(1, 16, 8, 8, 9, torch.float32, cuda)
    with pytest.raises(ValueError, match="K <= 8"):
        lg.laguerre_dense_fused_bwd(l, x, w, torch.zeros(1, 16, 8, device=cuda))
    l, x, w, _ = _inputs(1, 128, 8, 8, 8, torch.float32, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        lg.laguerre_dense_fused_bwd(l, x, w, torch.zeros(1, 128, 8, device=cuda))
    with pytest.raises(ValueError, match="dt"):
        lg.laguerre_terms_dense_bwd(l, torch.zeros(3, 1, 128, 8, device=cuda), 2)
