"""The band route's float32 gradient at the brain model's largest operator, on
the card (skips without one; imports no jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_band_precision.py -m gpu

A K = 4 conv on the Shen-268 skeleton's level-0 L1 (S = 8997 edge rows),
shared by 64 subjects as ``hgat_attpool`` runs it (the terms kernel on the
64·C folded columns, then the stack GEMMs): its output, dW and dx from the
band kernels against float64 must stay within twice what the plain float32
route (PyTorch, TF32 off) reads on the same seeded inputs.
"""

import pathlib

import numpy as np
import pytest
import torch

from hl_hgat_tpu_torch.data.brain import brain_pyramid
from hl_hgat_tpu_torch.nn.conv import laguerre_matvec
from hl_hgat_tpu_torch.ops import laguerre_dense as lg
from torch_counters import recording

pytestmark = pytest.mark.gpu

FIXTURE = pathlib.Path(__file__).resolve().parent / "golden/reference/model_hgat_attpool.npz"
K, SUBJECTS, F = 4, 64, 32


@pytest.fixture(scope="module")
def l1():
    """The level-0 L1 [1, 8997, 8997] on the card, float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with np.load(FIXTURE) as z:
        levels, _ = brain_pyramid(z["skeleton_src"], z["skeleton_dst"], z["skeleton_val"],
                                  pool_num=0)
    lv = levels[0]
    idx = torch.from_numpy(np.stack([lv.l1_rows, lv.l1_cols]).astype(np.int64))
    dense = torch.sparse_coo_tensor(idx, torch.from_numpy(lv.l1_vals.astype(np.float32)),
                                    (lv.num_edges, lv.num_edges)).to_dense()
    return dense[None].cuda()


def _seeded(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    a = (shift + scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(a).cuda()


def _float64(l1, x, w, g):
    """out, dW and dx of Σ_k T_k(L) x W_k in float64."""
    l64 = l1.double()
    x64, w64 = x.double().requires_grad_(True), w.double().requires_grad_(True)
    terms = [x64, x64 - l64 @ x64]
    for j in range(1, K - 1):
        terms.append((-(l64 @ terms[-1]) + (2 * j + 1) * terms[-1] - j * terms[-2]) / (j + 1))
    out = sum(t @ w64[kk] for kk, t in enumerate(terms))
    dx, dw = torch.autograd.grad((out * g.double()).sum(), (x64, w64))
    return out.detach(), dw, dx


def _float32(l1, x, w, g):
    xv, wv = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = laguerre_matvec(xv, l1, wv, torch.zeros(F, device=x.device))
    dx, dw = torch.autograd.grad((out * g).sum(), (xv, wv))
    return out.detach(), dw, dx


def _plain(monkeypatch):
    monkeypatch.setattr(lg, "_terms_fwd_cuda", lg.laguerre_terms_dense_plain)
    monkeypatch.setattr(lg, "laguerre_terms_dense_bwd", lg.laguerre_terms_dense_bwd_plain)


def _rel(a, ref):
    return float((a.double() - ref).norm() / ref.norm())


# C = 1: the edge input (the FC value of each edge), 64 folded columns;
# C = 32: the first block's convs, 2048 folded columns
@pytest.mark.parametrize("c", [1, 32])
def test_band_route_gradient_keeps_float32_accuracy_at_8997_rows(l1, monkeypatch, c):
    s = l1.shape[-1]
    x = _seeded((SUBJECTS, s, c), 1, 0.2, 0.3 if c == 1 else 0.0)
    w = _seeded((K, c, F), 2, (6.0 / (c + F)) ** 0.5)
    g = _seeded((SUBJECTS, s, F), 3)
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = _float64(l1, x, w, g)
    with recording() as rec:
        band = _float32(l1, x, w, g)
    # one terms-backward launch, and every launch took the band kernels
    assert rec["launches.laguerre_terms_dense_bwd"] == 1
    assert rec["band_launches"] == sum(rec.launches().values())
    _plain(monkeypatch)
    plain = _float32(l1, x, w, g)
    for what, b, p, r in zip(("out", "dW", "dx"), band, plain, ref):
        assert _rel(b, r) <= 2 * _rel(p, r), (what, _rel(b, r), _rel(p, r))
