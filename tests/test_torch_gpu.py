"""CUDA kernels vs their plain versions on the card (skips without one).

Imports no jax, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from hl_hgat_tpu_torch.complex.batch import CooMatrix
from hl_hgat_tpu_torch.complex.build import coo_to_ell
from hl_hgat_tpu_torch.nn import conv
from hl_hgat_tpu_torch.ops import ell_spmm
from hl_hgat_tpu_torch.ops import laguerre_dense as lg
from hl_hgat_tpu_torch.ops.dispatch import lap_matvec
from torch_counters import ELL, recorded, recording  # noqa: F401  (a fixture)

pytestmark = pytest.mark.gpu

# f32: full float32 accuracy (the kernels split each operand for three TF32
# passes), only the summation order differs;
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


def _normal(shape, seed, dtype, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device).to(dtype)


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
def test_fused_kernel_matches_plain(cuda, recorded, dtype, g, s, c, f, k):
    l, x, w, b = _inputs(g, s, c, f, k, dtype, cuda)
    out = lg.laguerre_dense_fused(l, x, w, b)
    torch.cuda.synchronize()
    assert recorded["launches.laguerre_dense_fused"] == 1
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
    strided slice of a wider tensor: the fused and the terms kernels take
    the scalar load path (or the wrapper's contiguous copy) and give the
    aligned call's bits."""
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
    terms = lg.laguerre_terms_dense(l, x, k)
    dt = _normal((k, g, s, c), 2, dtype, cuda)
    dx = lg.laguerre_terms_dense_bwd(l, dt, k)
    assert torch.equal(lg.laguerre_terms_dense(lo, xo, k), terms)
    assert torch.equal(lg.laguerre_terms_dense(l, view, k), terms)
    assert torch.equal(lg.laguerre_terms_dense_bwd(lo, _offset_copy(dt), k), dx)
    _check(terms, lg.laguerre_terms_dense_plain(l, x, k), dtype)
    _check(dx, lg.laguerre_terms_dense_bwd_plain(l, dt, k), dtype)


# terms-kernel shapes: a main-path one, ragged C, K = 2 and K = 1 at small
# blocks, then S = 77 with odd C, C = 520 (17 channel slices), K = 8 and
# K = 10 at the largest block, more graph blocks than the card has SMs
_TERMS_SHAPES = [
    (3, 128, 64, 6), (2, 128, 100, 3), (4, 13, 7, 2), (1, 64, 40, 1),
    (3, 77, 45, 4), (2, 128, 520, 6), (2, 128, 64, 8), (2, 128, 64, 10),
    (200, 64, 40, 3),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,s,c,k", _TERMS_SHAPES)
def test_terms_kernel_matches_plain(cuda, recorded, dtype, g, s, c, k):
    l, x, _, _ = _inputs(g, s, c, 1, k, dtype, cuda)
    out = lg.laguerre_terms_dense(l, x, k)
    torch.cuda.synchronize()
    assert recorded["launches.laguerre_terms_dense"] == 1
    assert out.dtype == dtype and out.shape == (k, g, s, c)
    _check(out, lg.laguerre_terms_dense_plain(l, x, k), dtype)
    # no atomics, fixed tiling: a second launch gives the same bits
    assert torch.equal(out, lg.laguerre_terms_dense(l, x, k))


def test_wrappers_reject_what_the_kernel_cannot_take(cuda):
    # a block over 128 rows runs on the band kernels; a half-precision x is
    # refused
    l, x, w, b = _inputs(1, 136, 8, 8, 2, torch.float32, cuda)
    _check(lg.laguerre_dense_fused(l, x, w, b), lg.laguerre_dense_fused_plain(l, x, w, b),
           torch.float32)
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
def test_fused_bwd_kernel_matches_plain(cuda, recorded, dtype, g, s, c, f, k):
    l, x, w, _ = _inputs(g, s, c, f, k, dtype, cuda)
    cot = torch.from_numpy(
        np.random.default_rng(1).standard_normal((g, s, f)).astype(np.float32)
    ).to(cuda).to(dtype)
    dx, dw, db = lg.laguerre_dense_fused_bwd(l, x, w, cot)
    torch.cuda.synchronize()
    assert recorded["launches.laguerre_dense_fused_bwd"] == 1
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
@pytest.mark.parametrize("g,s,c,k", _TERMS_SHAPES)
def test_terms_bwd_kernel_matches_plain(cuda, recorded, dtype, g, s, c, k):
    l, _, _, _ = _inputs(g, s, c, 1, k, dtype, cuda)
    dt = torch.from_numpy(
        np.random.default_rng(2).standard_normal((k, g, s, c)).astype(np.float32)
    ).to(cuda).to(dtype)
    dx = lg.laguerre_terms_dense_bwd(l, dt, k)
    torch.cuda.synchronize()
    assert recorded["launches.laguerre_terms_dense_bwd"] == 1
    assert dx.dtype == dtype and dx.shape == (g, s, c)
    _check(dx, lg.laguerre_terms_dense_bwd_plain(l, dt, k), dtype)
    assert torch.equal(dx, lg.laguerre_terms_dense_bwd(l, dt, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_reaches_the_backward_kernels(cuda, recorded, dtype):
    """loss.backward() through both public functions launches the backward
    kernels, takes an expanded (non-contiguous) cotangent, and agrees with
    the CPU path (plain forward, plain backward)."""
    l, x, w, b = _inputs(3, 128, 40, 24, 4, dtype, cuda)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    cpu = [t.detach().cpu().requires_grad_() for t in leaves]
    lg.laguerre_dense_fused(l, *leaves).float().sum().backward()
    lg.laguerre_dense_fused(l.cpu(), *cpu).float().sum().backward()
    assert recorded["launches.laguerre_dense_fused_bwd"] == 1
    assert l.grad is None
    for a, r in zip(leaves, cpu):
        assert a.grad.dtype == a.dtype
        _check(a.grad.cpu(), r.grad, dtype)
    xt, xc = x.clone().requires_grad_(), x.detach().cpu().requires_grad_()
    lg.laguerre_terms_dense(l, xt, 4).float().sum().backward()
    lg.laguerre_terms_dense(l.cpu(), xc, 4).float().sum().backward()
    assert recorded["launches.laguerre_terms_dense_bwd"] == 1
    _check(xt.grad.cpu(), xc.grad, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,s,c,f,k", [
    (3, 128, 64, 64, 9), (3, 128, 64, 64, 10), (2, 128, 64, 64, 16), (3, 77, 45, 37, 10),
])
def test_fused_bwd_kernel_takes_any_k(cuda, dtype, g, s, c, f, k):
    """Beyond 8 terms the backward takes its products and dW in chunks of
    8 and carries the adjoint walk across them: the same function as the
    plain version, a second launch bit-equal."""
    l, x, w, _ = _inputs(g, s, c, f, k, dtype, cuda)
    cot = _normal((g, s, f), 1, dtype, cuda)
    got = lg.laguerre_dense_fused_bwd(l, x, w, cot)
    torch.cuda.synchronize()
    for a, r in zip(got, lg.laguerre_dense_fused_bwd_plain(l, x, w, cot)):
        _check(a, r, dtype)
    for a, r in zip(got, lg.laguerre_dense_fused_bwd(l, x, w, cot)):
        assert torch.equal(a, r)


def test_backward_wrappers_reject_what_the_kernels_cannot_take(cuda):
    # K = 9 runs (the fused backward takes any K), a block over 128 rows
    # runs on the band kernels; a cotangent of another shape is refused
    l, x, w, _ = _inputs(1, 16, 8, 8, 9, torch.float32, cuda)
    dx, dw, db = lg.laguerre_dense_fused_bwd(l, x, w, torch.zeros(1, 16, 8, device=cuda))
    assert not bool(dx.any()) and not bool(dw.any()) and not bool(db.any())
    with pytest.raises(ValueError, match="need w"):
        lg.laguerre_dense_fused_bwd(l, x, w, torch.zeros(1, 16, 9, device=cuda))
    lb, xb, wb, _ = _inputs(1, 136, 8, 8, 2, torch.float32, cuda)
    cot = _normal((1, 136, 8), 4, torch.float32, cuda)
    for a, r in zip(lg.laguerre_dense_fused_bwd(lb, xb, wb, cot),
                    lg.laguerre_dense_fused_bwd_plain(lb, xb, wb, cot)):
        _check(a, r, torch.float32)
    # K = 8 at the largest block fits the fused backward; the terms backward
    # streams its walk and takes K = 10 there
    l, x, w, _ = _inputs(1, 128, 8, 8, 8, torch.float32, cuda)
    dx, dw, db = lg.laguerre_dense_fused_bwd(l, x, w, torch.zeros(1, 128, 8, device=cuda))
    assert not bool(dx.any()) and not bool(dw.any()) and not bool(db.any())
    dt = _normal((10, 1, 128, 8), 3, torch.float32, cuda)
    _check(lg.laguerre_terms_dense_bwd(l, dt, 10),
           lg.laguerre_terms_dense_bwd_plain(l, dt, 10), torch.float32)
    with pytest.raises(ValueError, match="dt"):
        lg.laguerre_terms_dense_bwd(l, torch.zeros(3, 1, 128, 8, device=cuda), 2)


# blocks over 128 rows (the band kernels): S = 129 (one row past a band,
# rows not 16-byte aligned), 200, 256 and 512, with ragged C and F, K = 1,
# 2 and 10 among them; TSP's widths at K = 2 and the widest output tile
# (F = 256, two column tiles of the output product); then g W_kᵀ on either
# side of the widest F whose rows of g stay in shared memory (576 float32,
# 1472 bfloat16; each shape runs in both dtypes), the last one with ragged
# S and C
_BAND_SHAPES = [
    (3, 129, 45, 37, 4), (2, 200, 64, 72, 6), (2, 256, 64, 64, 6),
    (3, 256, 100, 130, 2), (1, 256, 33, 8, 1), (2, 512, 40, 48, 10),
    (2, 512, 256, 256, 2), (2, 256, 64, 256, 4),
    (2, 256, 64, 576, 4), (1, 256, 64, 608, 3), (1, 256, 64, 640, 3),
    (1, 256, 32, 1472, 2), (1, 256, 32, 1536, 2), (1, 300, 40, 1600, 4),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,s,c,f,k", _BAND_SHAPES)
def test_band_kernels_match_plain(cuda, recorded, dtype, g, s, c, f, k):
    """All four wrappers over 128 rows against their plain versions,
    forward and backward, one launch counted a call; a second call gives
    the same bits (no atomics, fixed slices)."""
    l, x, w, b = _inputs(g, s, c, f, k, dtype, cuda)
    cot = _normal((g, s, f), 5, dtype, cuda)
    dt = _normal((k, g, s, c), 6, dtype, cuda)
    calls = {
        "laguerre_dense_fused": (lambda: lg.laguerre_dense_fused(l, x, w, b),
                                 lambda: lg.laguerre_dense_fused_plain(l, x, w, b)),
        "laguerre_dense_fused_bwd": (lambda: lg.laguerre_dense_fused_bwd(l, x, w, cot),
                                     lambda: lg.laguerre_dense_fused_bwd_plain(l, x, w, cot)),
        "laguerre_terms_dense": (lambda: lg.laguerre_terms_dense(l, x, k),
                                 lambda: lg.laguerre_terms_dense_plain(l, x, k)),
        "laguerre_terms_dense_bwd": (lambda: lg.laguerre_terms_dense_bwd(l, dt, k),
                                     lambda: lg.laguerre_terms_dense_bwd_plain(l, dt, k)),
    }
    for name, (kernel, plain) in calls.items():
        got = kernel()
        torch.cuda.synchronize()
        assert recorded[f"launches.{name}"] == 1, name
        got = got if isinstance(got, tuple) else (got,)
        ref = plain()
        ref = ref if isinstance(ref, tuple) else (ref,)
        for a, r in zip(got, ref):
            assert a.shape == r.shape, name
            _check(a, r, dtype)
        again = kernel()
        again = again if isinstance(again, tuple) else (again,)
        assert all(torch.equal(a, r) for a, r in zip(got, again)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [64, 576, 640, 1472, 1600])
def test_band_bar_plan_fits_a_block_at_any_width(cuda, dtype, f):
    """g W_kᵀ has a launch at every F: its shared memory stays within what
    a block may opt into, and past the resident rows of g it no longer grows
    with F."""
    p = lg.band_product_plan("band_bar_kernel", 4, 256, 64, f, 4, dtype)
    assert 0 < p["smem"] <= 232448, p
    assert p["ctas_per_sm"] >= 1 and p["tile"] == (64, 64), p
    wider = lg.band_product_plan("band_bar_kernel", 4, 256, 64, 4 * f, 4, dtype)
    assert wider["smem"] <= 232448, wider
    if f >= 1600 or (f >= 640 and dtype == torch.float32):
        assert wider["smem"] == p["smem"], (p, wider)


@pytest.mark.parametrize("route", ["fused", "terms"])
@pytest.mark.parametrize("s", [129, 200, 256, 512])
def test_kernel_routes_take_blocks_over_128_rows(cuda, route, s):
    """Either kernel route launches its kernels on blocks over 128 rows and
    matches the plain route, forward and autograd backward (dx, dW, db)."""
    prev = conv.use_fused_dense(), conv.use_terms_kernel()
    try:
        outs = {}
        for name in (route, "plain"):
            conv.use_fused_dense(name == "fused")
            conv.use_terms_kernel(name == "terms")
            l, x, w, b = _inputs(2, s, 24, 16, 4, torch.float32, cuda)
            x, w, b = (t.clone().requires_grad_() for t in (x, w, b))
            with recording() as rec:
                out = conv.laguerre_matvec(x, l, w, b)
                out.backward(_normal(out.shape, 7, torch.float32, cuda))
                torch.cuda.synchronize()
            launched = sum(rec.launches().values())
            assert launched == (2 if name != "plain" else 0), rec.launches()
            outs[name] = (out.detach(), x.grad, w.grad, b.grad)
        for a, r in zip(outs[route], outs["plain"]):
            _check(a, r, torch.float32)
    finally:
        conv.use_fused_dense(prev[0])
        conv.use_terms_kernel(prev[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [200, 1001])
def test_shared_operator_takes_the_folded_terms_kernel(cuda, s, dtype):
    """A [1, S, S] operator shared by G = 5 graphs (the brain layout) on the
    kernel routes: one terms launch on the folded [1, S, G·C] features
    forward, one terms-backward launch, no fused launch; output (and in
    float32 dx, dW, db) against the plain route (the broadcast recurrence).  S = 1001 is odd:
    L's rows are not 16-byte aligned."""
    prev = conv.use_fused_dense(), conv.use_terms_kernel()
    try:
        outs = {}
        for name in ("fused", "terms", "plain"):
            conv.use_fused_dense(name == "fused")
            conv.use_terms_kernel(name == "terms")
            l, _, w, b = _inputs(1, s, 24, 16, 4, dtype, cuda)
            x = _normal((5, s, 24), 3, dtype, cuda)
            x, w, b = (t.clone().requires_grad_() for t in (x, w, b))
            with recording() as rec:
                out = conv.laguerre_matvec(x, l, w, b)
                out.backward(_normal(out.shape, 7, dtype, cuda))
                torch.cuda.synchronize()
            want = {key: 0 for key in rec.launches()}
            if name != "plain":
                want.update(laguerre_terms_dense=1, laguerre_terms_dense_bwd=1)
            assert rec.launches() == want, (name, rec.launches())
            outs[name] = (out.detach(), x.grad, w.grad, b.grad)
        for route in ("fused", "terms"):
            # bfloat16: the output only (autograd through the plain
            # recurrence rounds its cotangents at other points than the
            # kernel's adjoint walk)
            pairs = zip(outs[route], outs["plain"])
            for a, r in (pairs if dtype == torch.float32 else [next(pairs)]):
                assert a.shape == r.shape
                _check(a, r, dtype)
        with pytest.raises(ValueError):
            lg.laguerre_dense_fused(l, x.detach(), w.detach(), b.detach())
    finally:
        conv.use_fused_dense(prev[0])
        conv.use_terms_kernel(prev[1])


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
def test_ell_kernel_matches_plain(cuda, recorded, dtype, n, feat, deg):
    cols, vals, x = _ell_inputs(n, feat, deg, dtype, cuda)
    out = ell_spmm.spmm_ell(cols, vals, x)
    torch.cuda.synchronize()
    assert recorded["launches.spmm_ell"] == 1
    assert recorded["launches.spmm_ell_bwd"] == 0
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
    # bfloat16 offset by one element (2 B): the same bits as the aligned call
    x16 = view.to(torch.bfloat16).contiguous()
    off = torch.zeros(100 * 64 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(100, 64)
    off.copy_(x16)
    vals16 = vals.to(torch.bfloat16)
    assert torch.equal(ell_spmm.spmm_ell(cols, vals16, off), ell_spmm.spmm_ell(cols, vals16, x16))


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
def test_ell_autograd_launches_the_kernel_for_dx(cuda, recorded, dtype, feat):
    cols, vals, x = _ell_inputs(500, feat, 6, dtype, cuda)
    rng = np.random.default_rng(1)
    cot = torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(np.float32)).to(cuda).to(dtype)
    lap = CooMatrix(rows=None, cols=None, vals=None, shape=(500, 500),
                    ell_cols=cols, ell_vals=vals, symmetric=True)
    xk = x.clone().requires_grad_()
    out = lap_matvec(lap, xk)
    # an expanded (stride-0) cotangent is made contiguous by the wrapper
    out.backward(cot)
    assert recorded.launches(ELL) == {"spmm_ell": 1, "spmm_ell_bwd": 1}
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
    assert recorded.launches(ELL) == {"spmm_ell": 2, "spmm_ell_bwd": 1}
    assert bool((vk.grad[vals == 0] == 0).all())
    live = vals != 0
    _ell_check(vk.grad[live], vp.grad[live], dtype)


def test_ell_route_switch_and_rejections(cuda, recorded):
    cols, vals, x = _ell_inputs(64, 16, 3, torch.float32, cuda)
    ell_spmm.use_ell_kernel(False)
    try:
        out = ell_spmm.spmm_ell_symmetric(cols, vals, x)
    finally:
        ell_spmm.use_ell_kernel(True)
    assert ell_spmm.use_ell_kernel() and recorded["launches.spmm_ell"] == 0
    assert torch.equal(out, ell_spmm.spmm_ell_plain(cols, vals, x))
    with pytest.raises(ValueError, match="square"):
        ell_spmm.spmm_ell(cols[:32], vals[:32], x)
    with pytest.raises(TypeError):
        ell_spmm.spmm_ell(cols, vals, x.half())
    with pytest.raises(TypeError, match="int32"):
        ell_spmm.spmm_ell(cols.long(), vals, x)
    with pytest.raises(ValueError, match="same CUDA device"):
        ell_spmm.spmm_ell(cols.cpu(), vals, x)


def _ell_exact(n, f, w, dtype, device, seed=0, vals_dtype=None):
    """cols, vals [n, w] with a random count of live slots a row (every row
    has padding when w > 1: column 0, value 0) and x [n, f]."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n, (n, w)).astype(np.int32)
    vals = rng.standard_normal((n, w)).astype(np.float32)
    live = rng.integers(1, w + 1, n) if w > 1 else np.ones(n, int)
    pad = np.arange(w)[None, :] >= live[:, None]
    cols[pad], vals[pad] = 0, 0.0
    x = rng.standard_normal((n, f)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(cols), t(vals).to(vals_dtype or dtype), t(x).to(dtype)


# F across the chunk layouts (1, 3, 37, 130 and bfloat16 300: rows off
# 16-byte boundaries, each chunk read element by element; 64 and float32
# 300: aligned 16-byte chunks), W = 1, the flat batches' 11 and a wide 64,
# N = 1003 not a multiple of the rows of a block
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 3, 37, 64, 130, 300])
@pytest.mark.parametrize("w", [1, 11, 64])
def test_ell_kernel_widths_and_slots(cuda, dtype, f, w):
    cols, vals, x = _ell_exact(1003, f, w, dtype, cuda, seed=f * 100 + w)
    out = ell_spmm.spmm_ell(cols, vals, x)
    torch.cuda.synchronize()
    _ell_check(out, ell_spmm.spmm_ell_plain(cols, vals, x), dtype)
    assert torch.equal(out, ell_spmm.spmm_ell(cols, vals, x))


@pytest.mark.parametrize("f", [3, 37, 64])
def test_ell_kernel_bf16_values_with_f32_features(cuda, f):
    cols, vals, x = _ell_exact(517, f, 11, torch.float32, cuda, vals_dtype=torch.bfloat16)
    out = ell_spmm.spmm_ell(cols, vals, x)
    assert out.dtype == torch.float32
    _ell_check(out, ell_spmm.spmm_ell_plain(cols, vals, x), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [37, 64])
def test_ell_inf_in_the_padding_row_gives_nan_as_the_plain_version(cuda, dtype, f):
    """Every padding slot points at row 0: with an inf there, 0·inf is NaN in
    each padded row, in the kernel as in the plain version."""
    cols, vals, x = _ell_exact(300, f, 11, dtype, cuda, seed=5)
    x[0, f // 2] = float("inf")
    out = ell_spmm.spmm_ell(cols, vals, x)
    ref = ell_spmm.spmm_ell_plain(cols, vals, x)
    assert torch.isnan(out).any()
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    fin = torch.isfinite(ref)
    _ell_check(out[fin], ref[fin], dtype)
    assert torch.equal(out.view(torch.uint8), ell_spmm.spmm_ell(cols, vals, x).view(torch.uint8))


# ---------------------------------------------------------------------------
# the large-graph layout: band and spill operators, the TSP augmentation
# ---------------------------------------------------------------------------

# The spill's index_add sums with atomics on the card: float32 differs from
# the CPU in summation order only; bfloat16 rounds each spill product and
# its sum into y in another order, and the band GEMMs accumulate in other
# tiles (2e-2 of max|ref|, the kernels' bf16 bound).
_SPILL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def spill_batch():
    """Three k-NN graphs of 150-300 nodes packed at (32, 128) rows: every
    operator has both bands and a spill (NumPy arrays)."""
    from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
    from hl_hgat_tpu_torch.data.synthetic import tsp_like_samples

    samples = tsp_like_samples(3, seed=1, min_nodes=150, max_nodes=300)
    return collate_dense_packed(samples, node_cap=32, edge_cap=128, y_per_edge=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["l0", "l1", "abs_b1_s2t", "abs_b1_t2s", "b1_t2s"])
def test_band_and_spill_ops_match_the_cpu(cuda, spill_batch, dtype, op):
    """``_band_add`` and ``_spill_add`` inside each operator, forward and
    autograd, on the card against the same functions on the CPU."""
    from hl_hgat_tpu_torch.ops import dispatch

    lvl = spill_batch.level0
    assert lvl.l1.spill is not None and lvl.b1_bu is not None and lvl.b1_bd is not None
    g, s, e = lvl.b1.shape
    rows = s if op in ("l0", "abs_b1_t2s", "b1_t2s") else e
    x = _normal((g, rows, 24), 5, torch.float32, "cpu")
    cot_rows = e if op in ("abs_b1_t2s", "b1_t2s") else (s if op == "abs_b1_s2t" else rows)
    cot = _normal((g, cot_rows, 24), 6, torch.float32, "cpu")
    results = []
    for device in ("cpu", cuda):
        batch = dispatch.cast_operators(spill_batch.to(device), dtype)
        level = batch.level0
        xd = x.to(device=device, dtype=dtype).detach().clone().requires_grad_()
        if op in ("l0", "l1"):
            out = dispatch.lap_matvec(getattr(level, op), xd)
        else:
            out = getattr(dispatch, op)(level, xd)
        out.backward(cot.to(device).to(dtype))
        results.append((out.detach().float().cpu(), xd.grad.float().cpu()))
    for got, ref in zip(results[1], results[0]):
        err = (got - ref).abs().max().item()
        assert err <= _SPILL_TOL[dtype] * ref.abs().max().item(), err


def test_tsp_keep_on_the_card_repeats_for_one_seed(cuda, spill_batch):
    from hl_hgat_tpu_torch.complex.augment import apply_tsp_keep, tsp_keep

    batch = spill_batch.to(cuda)
    keeps = [tsp_keep(batch, apply_prob=0.75, generator=torch.Generator(device=cuda).manual_seed(3))
             for _ in range(2)]
    assert keeps[0].device.type == "cuda" and torch.equal(keeps[0], keeps[1])
    keep = keeps[0]
    assert bool((keep[batch.y.reshape(-1) > 0] == 1).all()) and bool((keep == 0).any())
    out = apply_tsp_keep(batch, keep)
    assert torch.equal(out.x_s[..., -1].reshape(-1), keep * batch.level0.edge_mask.reshape(-1))
