"""CUDA kernels vs their plain versions on the card (skips without one).

Imports no jax, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from hl_hgat_tpu_torch.complex.batch import CooMatrix
from hl_hgat_tpu_torch.complex.build import coo_to_ell
from hl_hgat_tpu_torch.ops import ell_spmm
from hl_hgat_tpu_torch.ops import laguerre_dense as lg
from hl_hgat_tpu_torch.ops.dispatch import lap_matvec

pytestmark = pytest.mark.gpu

# f32: full float32 accuracy (the fused kernels split each operand for three
# TF32 passes, the terms kernels use FMAs), only the summation order differs;
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


# beyond the main-path and ragged shapes: S not a multiple of 16 with odd C
# and F, K = 8 at the largest block, eight 64-wide channel slices under
# F = 256, one graph block, more graph blocks than the card has SMs
_WIDE_SHAPES = [
    (3, 77, 45, 37, 4), (2, 128, 64, 64, 8), (2, 128, 512, 256, 6),
    (1, 128, 128, 128, 6), (200, 64, 40, 48, 3),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,s,c,f,k", [
    (3, 128, 64, 64, 6), (2, 128, 100, 72, 3), (5, 13, 7, 130, 1),
    (1, 96, 300, 8, 6), (4, 30, 33, 65, 2),
] + _WIDE_SHAPES)
def test_fused_kernel_matches_plain(cuda, dtype, g, s, c, f, k):
    l, x, w, b = _inputs(g, s, c, f, k, dtype, cuda)
    before = lg.LAUNCHES["laguerre_dense_fused"]
    out = lg.laguerre_dense_fused(l, x, w, b)
    torch.cuda.synchronize()
    assert lg.LAUNCHES["laguerre_dense_fused"] == before + 1
    assert out.dtype == dtype and out.shape == (g, s, f)
    _check(out, lg.laguerre_dense_fused_plain(l, x, w, b), dtype)
    # no atomics, fixed tiling: a second launch gives the same bits
    assert torch.equal(out, lg.laguerre_dense_fused(l, x, w, b))


def _offset_copy(t, elems=1):
    """``t``'s values in contiguous storage that starts ``elems`` elements
    past an allocation: rows that are not 16-byte aligned."""
    flat = torch.zeros(t.numel() + elems, dtype=t.dtype, device=t.device)[elems:]
    return flat.view(t.shape).copy_(t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_take_unaligned_views(cuda, dtype):
    """Contiguous inputs at a base that is not 16-byte aligned, and a
    strided slice of a wider tensor: the kernels take the scalar load path
    (or the wrapper's contiguous copy) and give the aligned call's bits."""
    g, s, c, f, k = 3, 96, 72, 40, 4
    l, x, w, b = _inputs(g, s, c, f, k, dtype, cuda)
    cot = torch.from_numpy(
        np.random.default_rng(1).standard_normal((g, s, f)).astype(np.float32)
    ).to(cuda).to(dtype)
    out = lg.laguerre_dense_fused(l, x, w, b)
    grads = lg.laguerre_dense_fused_bwd(l, x, w, cot)
    lo, xo, wo, co = _offset_copy(l), _offset_copy(x), _offset_copy(w), _offset_copy(cot)
    assert xo.data_ptr() % 16 != 0 and xo.is_contiguous()
    assert torch.equal(lg.laguerre_dense_fused(lo, xo, wo, b), out)
    for a, r in zip(lg.laguerre_dense_fused_bwd(lo, xo, wo, co), grads):
        assert torch.equal(a, r)
    wide = torch.cat([torch.zeros_like(x[..., :1]), x], dim=-1)
    view = wide[..., 1:]  # not contiguous, rows offset by one element
    assert not view.is_contiguous()
    assert torch.equal(lg.laguerre_dense_fused(l, view, w, b), out)
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
] + _WIDE_SHAPES


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
    # K = 8 at the largest block fits the fused backward (the adjoint walk
    # runs in registers); the terms backward keeps all K cotangent tiles in
    # shared memory and refuses K = 10 there
    l, x, w, _ = _inputs(1, 128, 8, 8, 8, torch.float32, cuda)
    dx, dw, db = lg.laguerre_dense_fused_bwd(l, x, w, torch.zeros(1, 128, 8, device=cuda))
    assert not bool(dx.any()) and not bool(dw.any()) and not bool(db.any())
    with pytest.raises(ValueError, match="shared memory"):
        lg.laguerre_terms_dense_bwd(l, torch.zeros(10, 1, 128, 8, device=cuda), 10)
    with pytest.raises(ValueError, match="dt"):
        lg.laguerre_terms_dense_bwd(l, torch.zeros(3, 1, 128, 8, device=cuda), 2)


# ---------------------------------------------------------------------------
# ELL SpMM (kernel 5).  f32: the kernel and the plain version differ in
# summation order only (W <= 20 terms): 1e-5 of max|ref|.  bf16: one final
# rounding of the same f32 sum; 2e-2 covers a flipped ulp.
# ---------------------------------------------------------------------------

ELL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _ell_inputs(n, feat, deg, dtype, device, seed=0, vals_dtype=None):
    """A random symmetric operator with about ``deg`` entries a row, packed
    as ELL (padding slots: column 0, value 0), and a random x."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, n * deg // 2)
    c = rng.integers(0, n, n * deg // 2)
    v = rng.standard_normal(r.size).astype(np.float32)
    rows, cols, vals = np.r_[r, c], np.r_[c, r], np.r_[v, v]
    ell_cols, ell_vals = coo_to_ell(rows, cols, vals, n)
    assert (ell_vals == 0).any()  # some rows are padded
    shape = (n,) + (feat if isinstance(feat, tuple) else (feat,))
    x = rng.standard_normal(shape).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(ell_cols), t(ell_vals).to(vals_dtype or dtype), t(x).to(dtype)


def _ell_check(out, ref, dtype):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= ELL_TOL[dtype] * ref.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,feat,deg", [
    (1000, 64, 6), (777, 37, 4), (64, 256, 10), (513, 1, 3), (300, 260, 5),
    (200, 1028, 2), (129, (5, 12), 4), (50, 7, 1),
])
def test_ell_kernel_matches_plain(cuda, dtype, n, feat, deg):
    cols, vals, x = _ell_inputs(n, feat, deg, dtype, cuda)
    before = dict(ell_spmm.LAUNCHES)
    out = ell_spmm.spmm_ell(cols, vals, x)
    torch.cuda.synchronize()
    assert ell_spmm.LAUNCHES["spmm_ell"] == before["spmm_ell"] + 1
    assert ell_spmm.LAUNCHES["spmm_ell_bwd"] == before["spmm_ell_bwd"]
    assert out.dtype == dtype and out.shape == x.shape
    _ell_check(out, ell_spmm.spmm_ell_plain(cols, vals, x), dtype)
    # fixed slot order, no atomics: a second launch gives the same bits
    assert torch.equal(out, ell_spmm.spmm_ell(cols, vals, x))


@pytest.mark.parametrize("x_dtype,vals_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_ell_kernel_takes_mixed_value_and_feature_dtypes(cuda, x_dtype, vals_dtype):
    cols, vals, x = _ell_inputs(300, 48, 5, x_dtype, cuda, vals_dtype=vals_dtype)
    out = ell_spmm.spmm_ell(cols, vals, x)
    assert out.dtype == x_dtype
    _ell_check(out, ell_spmm.spmm_ell_plain(cols, vals, x), x_dtype)


def test_ell_kernel_takes_an_unaligned_view(cuda):
    cols, vals, x = _ell_inputs(100, 65, 4, torch.float32, cuda)
    view = x[:, 1:]  # 64 wide, rows not 16-byte aligned, not contiguous
    _ell_check(ell_spmm.spmm_ell(cols, vals, view),
               ell_spmm.spmm_ell_plain(cols, vals, view), torch.float32)
    flat = torch.zeros(100 * 64 + 1, device=cuda)[1:].view(100, 64)  # contiguous, offset 4 B
    flat.copy_(view)
    _ell_check(ell_spmm.spmm_ell(cols, vals, flat),
               ell_spmm.spmm_ell_plain(cols, vals, flat), torch.float32)


def test_ell_padding_slots_multiply_like_any_other(cuda):
    """A padded slot reads x[0] and multiplies it by 0: 0·inf is nan there,
    in the kernel as in the plain version and the TPU kernel."""
    cols, vals, x = _ell_inputs(40, 8, 3, torch.float32, cuda)
    x[0, 0] = float("inf")
    out = ell_spmm.spmm_ell(cols, vals, x)
    ref = ell_spmm.spmm_ell_plain(cols, vals, x)
    assert torch.equal(torch.isnan(out), torch.isnan(ref)) and torch.isnan(out).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("feat", [40, 37, (3, 8)])
def test_ell_autograd_launches_the_kernel_for_dx(cuda, dtype, feat):
    cols, vals, x = _ell_inputs(500, feat, 6, dtype, cuda)
    rng = np.random.default_rng(1)
    cot = torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(np.float32)).to(cuda).to(dtype)
    lap = CooMatrix(rows=None, cols=None, vals=None, shape=(500, 500),
                    ell_cols=cols, ell_vals=vals, symmetric=True)
    xk = x.clone().requires_grad_()
    ell_spmm.reset_launch_counts()
    out = lap_matvec(lap, xk)
    # an expanded (stride-0) cotangent is made contiguous by the wrapper
    out.backward(cot)
    assert ell_spmm.LAUNCHES == {"spmm_ell": 1, "spmm_ell_bwd": 1}
    assert xk.grad.dtype == dtype
    # the operator is symmetric: dx is the plain product on the cotangent
    _ell_check(xk.grad, ell_spmm.spmm_ell_plain(cols, vals, cot), dtype)
    if dtype == torch.float32:  # and what autograd derives from the plain version
        xp = x.clone().requires_grad_()
        ell_spmm.spmm_ell_plain(cols, vals, xp).backward(cot)
        _ell_check(xk.grad, xp.grad, dtype)
    # dvals on request: plain torch, masked where vals == 0, no extra launch
    vk, vp = vals.clone().requires_grad_(), vals.clone().requires_grad_()
    ell_spmm.spmm_ell_symmetric(cols, vk, x).backward(cot)
    ell_spmm.spmm_ell_plain(cols, vp, x).backward(cot)
    assert ell_spmm.LAUNCHES == {"spmm_ell": 2, "spmm_ell_bwd": 1}
    assert bool((vk.grad[vals == 0] == 0).all())
    live = vals != 0
    _ell_check(vk.grad[live], vp.grad[live], dtype)


def test_ell_route_switch_and_rejections(cuda):
    cols, vals, x = _ell_inputs(64, 16, 3, torch.float32, cuda)
    ell_spmm.reset_launch_counts()
    ell_spmm.use_ell_kernel(False)
    try:
        out = ell_spmm.spmm_ell_symmetric(cols, vals, x)
    finally:
        ell_spmm.use_ell_kernel(True)
    assert ell_spmm.use_ell_kernel() and ell_spmm.LAUNCHES["spmm_ell"] == 0
    assert torch.equal(out, ell_spmm.spmm_ell_plain(cols, vals, x))
    with pytest.raises(ValueError, match="square"):
        ell_spmm.spmm_ell(cols[:32], vals[:32], x)
    with pytest.raises(TypeError):
        ell_spmm.spmm_ell(cols, vals, x.half())
    with pytest.raises(TypeError, match="int32"):
        ell_spmm.spmm_ell(cols.long(), vals, x)
    with pytest.raises(ValueError, match="same CUDA device"):
        ell_spmm.spmm_ell(cols.cpu(), vals, x)
