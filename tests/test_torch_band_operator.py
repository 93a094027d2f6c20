"""The band kernels' operator (``ops.laguerre_dense.band_operator``) and the
symmetry their adjoint walk relies on, on the CPU.

The band kernels (``csrc/laguerre_band.cu``, blocks over 128 rows) read L
as an operator prepared once per tensor and dtype: L cast to bfloat16, or
in float32 its TF32 halves ``hi = tf32(L)`` (nearest) and ``lo = L − hi``
(exact), rows padded to a multiple of 16 bytes for the TMA loads.  The
preparation must hold L's values bit for bit, take a row stride TMA
accepts at the brain's level-0 L1 sizes (S = 8997 and 7047; checked on the
meta device, which allocates nothing), come back from the cache on a second
request, and be made anew after an in-place edit of L.  The float32
kernels' three products on these halves must keep float32 accuracy.

The backward kernels, like the plain adjoint walk and the JAX package's
``_terms_bwd_kernel``, multiply by L where the math has Lᵀ; every operator
the collates hand to the band kernels must equal its transpose bit for bit:
the shared layout's L0 and L1 at every level of the Shen-268 pyramid, and
the packed layout's blocks at ``edge_cap=256`` (these also equal the JAX
package's collate of the same samples).
"""

import gc
import os
import weakref

import numpy as np
import pytest
import torch

from hl_hgat_tpu.complex import dense as jdense
from hl_hgat_tpu_torch.complex.dense import collate_dense_packed, collate_dense_shared
from hl_hgat_tpu_torch.data.brain import brain_pyramid
from hl_hgat_tpu_torch.data.datasets import brain_sample
from hl_hgat_tpu_torch.data.synthetic import pooled_like_samples
from hl_hgat_tpu_torch.ops import dispatch
from hl_hgat_tpu_torch.ops import laguerre_dense as lg
from torch_counters import recorded  # noqa: F401  (a fixture)

FIX = os.path.join(os.path.dirname(__file__), "golden", "reference", "model_hgat_attpool.npz")
DTYPES = [torch.float32, torch.bfloat16]


def _laplacian(g, s, seed=0):
    rng = np.random.default_rng(seed)
    l = rng.standard_normal((g, s, s)).astype(np.float32)
    return torch.from_numpy(((l + l.transpose(0, 2, 1)) / (2 * np.sqrt(s))).astype(np.float32))


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [137, 1001])
def test_prepared_operator_holds_l_bit_for_bit(dtype, s):
    """bfloat16: the operator is L cast to bfloat16; float32: hi is L
    rounded to TF32 as the kernels round (``_tf32``) and hi + lo is L, bit
    for bit; the padding is zero and L itself is untouched."""
    lap = _laplacian(2, s)
    before = lap.clone()
    version = lap._version
    op = lg.band_operator(lap, dtype)
    assert op.ld == lg.band_row_stride(s, dtype) and (op.ld * dtype.itemsize) % 16 == 0
    if dtype == torch.bfloat16:
        assert op.data.shape == (2, s, op.ld) and op.data.dtype == dtype
        assert torch.equal(_bits(op.data[..., :s]), _bits(lap.to(dtype)))
    else:
        assert op.data.shape == (2, 2, s, op.ld) and op.data.dtype == torch.float32
        hi, lo = op.data[0, ..., :s], op.data[1, ..., :s]
        assert torch.equal(_bits(hi), _bits(lg._tf32(lap)))
        assert torch.equal(_bits(hi + lo), _bits(lap))
        assert int((_bits(hi) & 0x1FFF).abs().max()) == 0  # hi has TF32's 10 mantissa bits
    assert not op.data[..., s:].any()
    assert torch.equal(lap, before) and lap._version == version


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [8997, 7047])
def test_row_stride_at_brain_scale(dtype, s):
    """The brain's level-0 L1 sizes (rows of 8997 and 7047 elements, not a
    multiple of 16 bytes in either dtype) get rows padded to 16 bytes, at
    most one 16-byte chunk longer; shapes checked on the meta device."""
    lap = torch.empty((1, s, s), device="meta")
    op = lg.band_operator(lap, dtype)
    per = 16 // dtype.itemsize
    assert s % per != 0
    assert op.ld % per == 0 and s < op.ld < s + per
    lead = () if dtype == torch.bfloat16 else (2,)
    assert op.data.shape == (*lead, 1, s, op.ld) and op.data.stride(-2) == op.ld


@pytest.mark.parametrize("dtype", DTYPES)
def test_second_request_returns_the_same_storage(dtype, recorded):
    """Two convs on one level's L read one preparation: a second request
    for the same tensor returns the same storage and prepares nothing; a
    request for another tensor, or for this one after an in-place edit,
    prepares anew; a freed L leaves the cache."""
    lap = _laplacian(1, 300, seed=1)
    first = lg.band_operator(lap, dtype)
    second = lg.band_operator(lap, dtype)
    assert second.data.untyped_storage().data_ptr() == first.data.untyped_storage().data_ptr()
    assert recorded["prepared.band_operator"] == 1
    other = lg.band_operator(lap.clone(), dtype)
    assert other.data.data_ptr() != first.data.data_ptr()
    assert recorded["prepared.band_operator"] == 2
    lap.mul_(2.0)
    edited = lg.band_operator(lap, dtype)
    assert recorded["prepared.band_operator"] == 3
    assert edited.data.data_ptr() != first.data.data_ptr()
    key = (id(lap), dtype)
    assert key in lg._prepared
    del lap
    gc.collect()
    assert key not in lg._prepared


@pytest.mark.parametrize("dtype", DTYPES)
def test_inference_tensor_is_cached_by_identity(dtype, recorded):
    """An L made under ``torch.inference_mode`` (a served batch) has no
    version counter: it is prepared once and served from the cache by
    identity, inside inference mode and out of it."""
    with torch.inference_mode():
        lap = _laplacian(1, 200, seed=2).clone()
    assert lap.is_inference()
    with torch.inference_mode():
        first = lg.band_operator(lap, dtype)
        again = lg.band_operator(lap, dtype)
    later = lg.band_operator(lap, dtype)
    assert again is first and later is first
    assert recorded["prepared.band_operator"] == 1


@pytest.mark.parametrize("source", ["bfloat16", "float32"])
@pytest.mark.parametrize("s", [256, 300])
def test_operator_holds_no_reference_to_l(source, s, recorded):
    """A bfloat16 operator must not keep L alive.  At S = 256 a contiguous
    bfloat16 L (rows of 512 bytes) is read as it is: the operator is L,
    nothing is prepared and nothing cached; at S = 300 it is a padded copy,
    cached.  Either way, once L is freed no entry is left and L is gone."""
    lap = _laplacian(1, s, seed=6)
    if source == "bfloat16":
        lap = lap.to(torch.bfloat16)
    op = lg.band_operator(lap, torch.bfloat16)
    as_is = source == "bfloat16" and s == 256
    assert (op.data is lap) == as_is
    assert recorded["prepared.band_operator"] == (0 if as_is else 1)
    key = (id(lap), torch.bfloat16)
    assert (key in lg._prepared) == (not as_is)
    ref = weakref.ref(lap)
    del lap, op
    gc.collect()
    assert ref() is None and key not in lg._prepared


def test_bfloat16_casts_of_one_batch_are_prepared_once(recorded):
    """The bfloat16 route casts the batch's float32 operators on every
    forward (``dispatch.cast_operators``): the cast of one float32 L is one
    tensor while L lives unedited, so the band operator is prepared once
    over two forwards; an in-place edit of L or of its cast, or inference
    mode, gives another cast; the cast goes with L."""
    lap = _laplacian(1, 300, seed=7)
    first = dispatch._cast(lap, torch.bfloat16)
    second = dispatch._cast(lap, torch.bfloat16)
    assert second is first and torch.equal(_bits(first), _bits(lap.to(torch.bfloat16)))
    assert lg.band_operator(first, torch.bfloat16) is lg.band_operator(second, torch.bfloat16)
    assert recorded["prepared.band_operator"] == 1
    with torch.inference_mode():
        inferred = dispatch._cast(lap, torch.bfloat16)
    assert inferred is not first and inferred.is_inference()
    first.add_(1.0)
    assert dispatch._cast(lap, torch.bfloat16) is not first
    lap.mul_(2.0)
    again = dispatch._cast(lap, torch.bfloat16)
    assert torch.equal(_bits(again), _bits(lap.to(torch.bfloat16)))
    assert dispatch._cast(lap, torch.float32) is lap
    ref = weakref.ref(again)
    key = (id(lap), (torch.bfloat16, False))
    assert key in dispatch._casts
    del lap, first, second, inferred, again
    gc.collect()
    assert ref() is None and key not in dispatch._casts


def test_channel_padding_keeps_the_channels():
    """A channel count whose rows are not 16 bytes (C = 45 float32, 100
    bfloat16) is padded with zero channels around the band launch; an
    aligned, contiguous x passes as it is."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 40, 45)).astype(np.float32))
    padded = lg._aligned(x, lg.band_row_stride(45, torch.float32))
    assert padded.shape == (2, 40, 48) and padded.data_ptr() % 16 == 0
    assert torch.equal(padded[..., :45], x) and not padded[..., 45:].any()
    xb = x[..., :40].to(torch.bfloat16).contiguous()
    assert xb.data_ptr() % 16 == 0 and lg._aligned(xb, lg.band_row_stride(40, torch.bfloat16)) is xb
    w = torch.ones(3, 100, 7)
    wp = lg.band_weights(w, lg.band_row_stride(100, torch.bfloat16), 8, torch.bfloat16)
    assert wp.shape == (3, 104, 8) and torch.equal(wp[:, :100, :7].float(), w)
    assert not wp[:, 100:].any() and not wp[:, :, 7:].any()


def test_three_products_on_the_halves_keep_float32_accuracy():
    """The float32 band step on the tensor cores: L's prepared halves (the
    tensor core reads lo truncated to TF32), T split in registers into
    rounded halves, lo·hi + hi·lo + hi·hi; within 1e-5 of max|ref| of the
    exact float32 product at S = 600 (a brain-like sparse L), where one
    TF32 pass is not."""
    rng = np.random.default_rng(3)
    s, c = 600, 64
    l = rng.standard_normal((s, s)).astype(np.float32) * (rng.random((s, s)) < 0.03)
    lap = torch.from_numpy(((l + l.T) / 2).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((s, c)).astype(np.float32))
    op = lg.band_operator(lap[None], torch.float32)
    hi, lo = op.data[0, 0, :, :s], op.data[1, 0, :, :s]
    lo_tc = (lo.contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    v_hi = lg._tf32(v)
    v_lo = lg._tf32(v - v_hi)
    f64 = torch.float64
    got = (hi.to(f64) @ v_lo.to(f64) + lo_tc.to(f64) @ v_hi.to(f64)) + hi.to(f64) @ v_hi.to(f64)
    ref = lap.to(f64) @ v.to(f64)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    one_pass = lg._tf32(lap).to(f64) @ v_hi.to(f64)
    assert float((one_pass - ref).abs().max()) > 1e-4 * scale


def _assert_symmetric(ops):
    for name, a in ops:
        a = np.asarray(a)
        assert a.ndim == 3 and a.shape[1] == a.shape[2], name
        assert np.array_equal(a.view(np.int32), a.transpose(0, 2, 1).view(np.int32)), name


def _shared_operators():
    """The shared layout of one subject on the Shen-268 pyramid (268/8997 →
    139/2676 → 75/800): every level's L0 and L1 (the port's collate alone:
    the level-0 L1 is 324 MB)."""
    with np.load(FIX) as z:
        src, dst, val = z["skeleton_src"], z["skeleton_dst"], z["skeleton_val"]
    levels, pools = brain_pyramid(src, dst, val, pool_num=2, seed=10086)
    series = np.random.default_rng(4).standard_normal((levels[0].num_nodes, 40))
    sample = brain_sample(series, src, dst, levels, pools, y=95.0)
    ours = collate_dense_shared([sample])
    out = [(f"level {i} {op}", np.asarray(getattr(lvl, op)))
           for i, lvl in enumerate(ours.levels) for op in ("l0", "l1")]
    assert [a.shape[-1] for _, a in out] == [268, 8997, 139, 2676, 75, 800]
    return out


def _packed_operators():
    """The pooled path's packing (128 synthetic cifar10sp graphs at
    ``edge_cap=256``): every level's L0 and L1 blocks, port and JAX."""
    samples = pooled_like_samples(np.random.default_rng(5), 128)
    ours = collate_dense_packed(samples, edge_cap=256)
    theirs = jdense.collate_dense_packed(samples, edge_cap=256)
    out = []
    for i, (lvl, jlvl) in enumerate(zip(ours.levels, theirs.levels)):
        for op in ("l0", "l1"):
            a = np.asarray(getattr(lvl, op))
            assert np.array_equal(a, np.asarray(getattr(jlvl, op))), f"level {i} {op}"
            out.append((f"level {i} {op}", a))
    assert max(a.shape[-1] for _, a in out) == 256
    return out


@pytest.mark.parametrize("layout", ["shared_shen268", "packed_edge_cap_256"])
def test_band_operators_equal_their_transpose(layout):
    ops = _shared_operators() if layout == "shared_shen268" else _packed_operators()
    assert any(a.shape[-1] > lg.RESIDENT_ROWS for _, a in ops)
    _assert_symmetric(ops)
