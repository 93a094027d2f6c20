"""The float32 arithmetic of the fused Laguerre kernels, emulated on the CPU.

On the card the float32 kernels form every matrix product on the tensor
cores as three TF32 passes over operands split into a high and a low part
(``csrc/laguerre_common.cuh``).  ``laguerre_dense.emulated_products`` makes
the plain versions form their products the same way, so the arithmetic can
be held against the exact float32 plain versions here: the three-pass form
must stay within 1e-5 of max|ref| through a K = 6 and a K = 8 recurrence,
forward and backward, and a single TF32 pass must visibly not (which is
why the kernels take three).  Inputs come from a numpy seed; L is the real
L0 of packed ZINC-like blocks (spectrum in [0, 2]).
"""

import numpy as np
import pytest
import torch

from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
from hl_hgat_tpu_torch.data.synthetic import zinc_like_samples
from hl_hgat_tpu_torch.ops import laguerre_dense as lg

TOL_3X = 1e-5  # of max|ref|: about 21 bits of each operand survive the split
TF32_VISIBLE = 1e-4  # one pass keeps 10 bits: an order of magnitude above TOL_3X


@pytest.fixture(scope="module")
def blocks():
    """L0 [G, 64, 64] of 24 ZINC-like graphs packed into blocks of 64."""
    samples = zinc_like_samples(np.random.default_rng(11), 24)
    l0 = np.asarray(collate_dense_packed(samples, node_cap=64, edge_cap=64).level0.l0)
    eig = np.linalg.eigvalsh(l0.astype(np.float64))
    assert eig.min() > -1e-5 and eig.max() < 2 + 1e-5
    return torch.from_numpy(l0)


def _inputs(blocks, c, f, k, seed):
    rng = np.random.default_rng(seed)
    g, s = blocks.shape[:2]
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    x = t(rng.standard_normal((g, s, c)))
    w = t(rng.uniform(-1, 1, (k, c, f)) * np.sqrt(6.0 / (c + f)))
    b = t(rng.standard_normal(f))
    cot = t(rng.standard_normal((g, s, f)))
    return x, w, b, cot


def _rel(a, ref):
    return float((a - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("k", [6, 8])
@pytest.mark.parametrize("c,f", [(48, 40), (130, 24)])
def test_three_pass_products_keep_float32_accuracy_forward(blocks, k, c, f):
    x, w, b, _ = _inputs(blocks, c, f, k, seed=k)
    ref = lg.laguerre_dense_fused_plain(blocks, x, w, b)
    with lg.emulated_products("tf32x3"):
        split = lg.laguerre_dense_fused_plain(blocks, x, w, b)
        terms = lg.laguerre_terms_dense_plain(blocks, x, k)
    with lg.emulated_products("tf32"):
        single = lg.laguerre_dense_fused_plain(blocks, x, w, b)
    assert _rel(split, ref) <= TOL_3X
    assert _rel(terms, lg.laguerre_terms_dense_plain(blocks, x, k)) <= TOL_3X
    assert _rel(single, ref) > TF32_VISIBLE


@pytest.mark.parametrize("k", [6, 8])
@pytest.mark.parametrize("c,f", [(48, 40), (130, 24)])
def test_three_pass_products_keep_float32_accuracy_backward(blocks, k, c, f):
    x, w, _, cot = _inputs(blocks, c, f, k, seed=10 + k)
    refs = lg.laguerre_dense_fused_bwd_plain(blocks, x, w, cot)
    with lg.emulated_products("tf32x3"):
        split = lg.laguerre_dense_fused_bwd_plain(blocks, x, w, cot)
    with lg.emulated_products("tf32"):
        single = lg.laguerre_dense_fused_bwd_plain(blocks, x, w, cot)
    for name, a, one, ref in zip(("dx", "dw", "db"), split, single, refs):
        assert _rel(a, ref) <= TOL_3X, name
        if name != "db":  # db is a plain sum: no product, no difference
            assert _rel(one, ref) > TF32_VISIBLE, name
    assert torch.equal(split[2], refs[2])


def test_split_is_exact_and_emulation_is_scoped():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32) * 37.0)
    hi = lg._tf32(a)
    # 10 mantissa bits, nearest: the 13 low bits are zero, the error is
    # at most half a TF32 ulp
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert bool(((a - hi).abs() <= a.abs() * 2.0 ** -11).all())
    # hi + (a - hi) is a again: the subtraction is exact
    assert torch.equal(hi + (a - hi), a)
    lo = lg._tf32(a - hi)
    assert bool(((a - hi - lo).abs() <= a.abs() * 2.0 ** -22).all())
    b = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    exact = lg._dot(a, b)
    with lg.emulated_products("tf32"):
        assert not torch.equal(lg._dot(a, b), exact)
    assert torch.equal(lg._dot(a, b), exact)  # off again outside the block
    with pytest.raises(ValueError, match="unknown product"):
        with lg.emulated_products("fp8"):
            pass
    # bfloat16 operands are exact in TF32: emulation changes nothing
    ab, bb = a.bfloat16(), b.bfloat16()
    with lg.emulated_products("tf32x3"):
        assert torch.equal(lg._dot(ab, bb), torch.matmul(ab.float(), bb.float()))
