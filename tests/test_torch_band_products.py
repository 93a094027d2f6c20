"""The fused band kernels' products on the CPU: the weights the wrapper
prepares for them, and their float32 arithmetic emulated.

Blocks over 128 rows take the band kernels (``csrc/laguerre_band.cu``).
Their products (``band_out_kernel``: Σ_k T_k W_k + b; ``band_bar_kernel``:
g W_kᵀ; ``band_dw_kernel``: T_kᵀ g and Σ g) run on wgmma, and TF32 wgmma
takes its B operand only K-major from shared memory, so the wrapper
prepares W once per weight tensor and version
(``laguerre_dense.band_weights``): the TF32 halves of Wᵀ [K, F, C] for the
output product and of W [K, C, F] for g W_kᵀ (hi = tf32(W) rounded to
nearest, lo = W − hi exact), or W cast to bfloat16, zero-padded to rows of
16 bytes for the TMA loads.  The halves must hold W bit for bit in the
layout the kernels read and the padding must be zero.  The float32
products form A·B as three TF32 products (A split in registers into
rounded halves, B's lo read by the tensor core cut to TF32) summed over a
chunk of 32 of the depth in a fresh accumulator (12 wgmma) that is added to
a float32 running sum: emulated here with each chunk's products summed
exactly, the arithmetic must stay within 1e-6 of max|ref| of the float64
product in all three products, where one TF32 pass is visibly worse.
"""

import gc

import numpy as np
import pytest
import torch

from hl_hgat_tpu_torch.ops import laguerre_dense as lg
from torch_counters import recorded  # noqa: F401  (a fixture)

TOL = 1e-6  # of max|ref|: about 21 bits of each operand survive the split
ONE_PASS_VISIBLE = 1e-4  # one TF32 pass keeps 10 bits: two orders above TOL
CHUNK = 32  # the depth a fresh accumulator sums: one 128-byte row of floats
# (G, S, C, F, K): the ragged case (C and F padded), the pooled path's band shape
SHAPES = [(2, 40, 45, 37, 4), (2, 64, 64, 64, 4)]


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _weights(k, c, f, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(-1, 1, (k, c, f)) * np.sqrt(6.0 / (c + f))
    return torch.from_numpy(w.astype(np.float32))


def _padded(c, f, dtype):
    return lg.band_row_stride(c, dtype), lg.band_row_stride(f, dtype)


@pytest.mark.parametrize("transposed", [True, False])
@pytest.mark.parametrize("c,f", [(45, 37), (64, 64), (100, 130)])
def test_float32_halves_hold_w_bit_for_bit(transposed, c, f):
    """The output product reads Wᵀ's halves [2, K, F', C'] (K-major: a row
    per output column, the channels along it), g W_kᵀ reads W's [2, K, C',
    F'] (a row per channel, the columns along it); hi is W rounded to TF32
    as the kernels round, hi + lo is W, the padding is zero."""
    k = 3
    w = _weights(k, c, f)
    cp, fp = _padded(c, f, torch.float32)
    prep = lg.band_weights(w, cp, fp, torch.float32, transposed=transposed)
    src = w.transpose(1, 2) if transposed else w
    rows, cols = (fp, cp) if transposed else (cp, fp)
    assert prep.shape == (2, k, rows, cols) and prep.dtype == torch.float32
    assert (cols * 4) % 16 == 0 and prep.is_contiguous()
    hi, lo = prep[0, :, :src.shape[1], :src.shape[2]], prep[1, :, :src.shape[1], :src.shape[2]]
    assert torch.equal(_bits(hi), _bits(lg._tf32(src)))
    assert torch.equal(_bits(hi + lo), _bits(src))
    assert int((_bits(hi) & 0x1FFF).abs().max()) == 0  # TF32's 10 mantissa bits
    pad = prep.clone()
    pad[:, :, :src.shape[1], :src.shape[2]] = 0
    assert not pad.any()


@pytest.mark.parametrize("c,f", [(45, 37), (100, 130)])
def test_bfloat16_weights_are_w_cast_and_padded(c, f, recorded):
    """bfloat16 reads W itself [K, C', F'] in both products (the output
    product's B by wgmma's transpose bit): W cast, zero past C and F, one
    preparation for both."""
    w = _weights(2, c, f, seed=1)
    cp, fp = _padded(c, f, torch.bfloat16)
    prep = lg.band_weights(w, cp, fp, torch.bfloat16, transposed=True)
    assert prep.shape == (2, cp, fp) and prep.dtype == torch.bfloat16 and (fp * 2) % 16 == 0
    assert torch.equal(_bits(prep[:, :c, :f]), _bits(w.to(torch.bfloat16)))
    assert not prep[:, c:].any() and not prep[:, :, f:].any()
    assert lg.band_weights(w, cp, fp, torch.bfloat16) is prep
    assert recorded["prepared.band_weights"] == 1


def test_weights_are_prepared_once_per_version(recorded):
    """A second request for the same W returns the same preparation; an
    in-place edit (an optimizer step) prepares anew; a freed W leaves the
    cache."""
    w = _weights(4, 64, 64, seed=2)
    first = lg.band_weights(w, 64, 64, torch.float32, transposed=True)
    assert lg.band_weights(w, 64, 64, torch.float32, transposed=True) is first
    other = lg.band_weights(w, 64, 64, torch.float32)
    assert other is not first and recorded["prepared.band_weights"] == 2
    w.mul_(0.5)
    again = lg.band_weights(w, 64, 64, torch.float32, transposed=True)
    assert again is not first and recorded["prepared.band_weights"] == 3
    assert torch.equal(_bits(again[0] + again[1]), _bits(w.transpose(1, 2)))
    key = (id(w), (torch.float32, True, 64, 64))
    assert key in lg._weights
    del w
    gc.collect()
    assert key not in lg._weights


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [8, 37, 64, 130, 256])
def test_columns_padded_to_sixteen_bytes(dtype, f):
    """g and W take rows of a multiple of 16 bytes (TMA's stride rule), at
    most one 16-byte chunk longer; a ragged cotangent is copied with zero
    columns, an aligned one passes as it is."""
    fp = lg.band_row_stride(f, dtype)
    per = 16 // dtype.itemsize
    assert fp % per == 0 and f <= fp < f + per
    g = torch.randn(2, 10, f).to(dtype)
    gp = lg._aligned(g, fp)
    assert gp.shape == (2, 10, fp) and torch.equal(gp[..., :f], g) and not gp[..., f:].any()
    assert (gp is g) == (fp == f)


def _tc(t):
    """A float32 operand in shared memory as the tensor core reads it: its
    top 10 mantissa bits."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _products(a, b_hi, b_lo, passes="tf32x3"):
    """A [M, D] · B [D, N] as the float32 kernels form it: A split into
    rounded halves (``split_tf32``), B given as its halves in shared memory;
    per chunk of CHUNK the products summed exactly and rounded to float32,
    then added to the float32 running sum.  ``passes="tf32"``: hi·hi alone."""
    f64 = torch.float64
    a_hi = lg._tf32(a)
    a_lo = lg._tf32(a - a_hi)
    acc = torch.zeros(a.shape[0], b_hi.shape[1], dtype=torch.float32)
    for d0 in range(0, a.shape[1], CHUNK):
        d = slice(d0, d0 + CHUNK)
        part = a_hi[:, d].to(f64) @ _tc(b_hi[d]).to(f64)
        if passes == "tf32x3":
            part = (a_lo[:, d].to(f64) @ _tc(b_hi[d]).to(f64)
                    + a_hi[:, d].to(f64) @ _tc(b_lo[d]).to(f64)) + part
        acc = acc + part.to(torch.float32)
    return acc


def _inputs(g, s, c, f, k, seed):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.standard_normal((k, g * s, c)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((g * s, f)).astype(np.float32))
    return t, _weights(k, c, f, seed), cot


def _rel(a, ref):
    return float((a.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("shape", SHAPES)
def test_output_product_keeps_float32_accuracy(shape):
    """Σ_k T_k W_k: the ring runs across the terms, each term's padded
    channels in chunks of 32, B = W_k from Wᵀ's prepared halves."""
    g, s, c, f, k = shape
    t, w, _ = _inputs(*shape, seed=3)
    cp, fp = _padded(c, f, torch.float32)
    halves = lg.band_weights(w, cp, fp, torch.float32, transposed=True)
    tp = torch.zeros(k, g * s, cp)
    tp[..., :c] = t
    a = tp.permute(1, 0, 2).reshape(g * s, k * cp)  # the depth in ring order: term, channel
    b_hi = halves[0].transpose(1, 2).reshape(k * cp, fp)
    b_lo = halves[1].transpose(1, 2).reshape(k * cp, fp)
    ref = torch.einsum("krc,kcf->rf", t.double(), w.double())
    got = _products(a, b_hi, b_lo)[:, :f]
    assert _rel(got, ref) <= TOL
    assert _rel(_products(a, b_hi, b_lo, "tf32")[:, :f], ref) > ONE_PASS_VISIBLE


@pytest.mark.parametrize("shape", SHAPES)
def test_cotangent_product_keeps_float32_accuracy(shape):
    """b̄_k = g W_kᵀ: A = g's padded columns, B = W_k's halves as stored."""
    g, s, c, f, k = shape
    _, w, cot = _inputs(*shape, seed=4)
    cp, fp = _padded(c, f, torch.float32)
    halves = lg.band_weights(w, cp, fp, torch.float32)
    a = lg._aligned(cot, fp)
    for kk in range(k):
        ref = cot.double() @ w[kk].double().t()
        got = _products(a, halves[0, kk].t(), halves[1, kk].t())[:, :c]
        assert _rel(got, ref) <= TOL, kk
        one = _products(a, halves[0, kk].t(), halves[1, kk].t(), "tf32")[:, :c]
        assert _rel(one, ref) > ONE_PASS_VISIBLE, kk


@pytest.mark.parametrize("shape", SHAPES)
def test_weight_gradient_product_keeps_float32_accuracy(shape):
    """dW_k = T_kᵀ g: A = T_kᵀ split from T's tile, B = g's chunk written
    transposed as rounded TF32 halves by the consumers; the depth is the
    rows, chunked within each graph block (zeros past S)."""
    g, s, c, f, k = shape
    t, _, cot = _inputs(*shape, seed=5)
    rows = -(-s // CHUNK) * CHUNK

    def by_block(a):  # [G·S, n] -> [G·rows, n], each block's rows zero-padded
        out = torch.zeros(g, rows, a.shape[-1])
        out[:, :s] = a.reshape(g, s, -1)
        return out.reshape(g * rows, -1)

    gb = by_block(cot)
    g_hi = lg._tf32(gb)
    g_lo = lg._tf32(gb - g_hi)
    for kk in range(k):
        ref = t[kk].double().t() @ cot.double()
        a = by_block(t[kk]).t()
        assert _rel(_products(a, g_hi, g_lo), ref) <= TOL, kk
        assert _rel(_products(a, g_hi, g_lo, "tf32"), ref) > ONE_PASS_VISIBLE, kk
