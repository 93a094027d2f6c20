"""Laguerre spectral conv over Hodge Laplacians (``hl_hgat_tpu/nn/conv.py``).

    T0 = x,  T1 = x − Lx,  T_{k+1} = (−L·T_k + (2k+1)·T_k − k·T_{k−1}) / (k+1)
    out = Σ_k T_k @ W_k + b           (reference lib/Hodge_Cheb_Conv.py:494,507)

Routes for dense [G, S, S] operators, as in the JAX package:

* ``use_fused_dense()`` (default on): the fused kernel
  (``ops/laguerre_dense.laguerre_dense_fused``), K = 1 included;
* else ``use_terms_kernel()`` and K > 1: the terms kernel produces the
  terms, the per-term GEMMs run in torch (`_combine_terms`);
* else the plain recurrence and GEMMs in torch.

Both kernel routes take any block size on the card: blocks of up to 128
rows go to kernels that hold L in shared memory, larger ones (a batch
packed with ``edge_cap=256``) to kernels that stream L in row bands
(``ops.laguerre_dense``).

A `CooMatrix` operator (the flat layout) always takes the plain
recurrence; each of its mat-vecs goes through ``ops.dispatch.lap_matvec``,
which launches the ELL row-gather kernel when the matrix carries ELL
arrays.  A `BlockDiagMatrix` (a batch with a graph spanning blocks) takes
the plain recurrence too, as in the JAX package (``_apply_poly`` sends only
3-D arrays to its kernels): its mat-vecs are the batched block matmuls,
the two band matmuls and the spill's gather and ``index_add``.

A kernel wrapper runs its plain version when the tensors lie on the CPU,
so every route computes the same function on either device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from hl_hgat_tpu_torch.nn.gemm import stack_gemm
from hl_hgat_tpu_torch.ops.dispatch import lap_matvec
from hl_hgat_tpu_torch.ops.laguerre_dense import (
    laguerre_dense_fused,
    laguerre_terms_dense,
)

_fused_dense_flag = True
_terms_kernel_flag = False


def use_fused_dense(enable: bool | None = None) -> bool:
    """Get/set whether dense-block convs use the fused kernel (default on)."""
    global _fused_dense_flag
    if enable is not None:
        _fused_dense_flag = enable
    return _fused_dense_flag


def use_terms_kernel(enable: bool | None = None) -> bool:
    """Get/set whether dense-block convs with K > 1 take their terms from
    the terms kernel when the fused kernel is off (default off)."""
    global _terms_kernel_flag
    if enable is not None:
        _terms_kernel_flag = enable
    return _terms_kernel_flag


def polynomial_terms(x: torch.Tensor, lap, k: int) -> list[torch.Tensor]:
    """The K Laguerre features [T_0(L)x, ..., T_{K-1}(L)x]."""
    terms = [x]
    if k > 1:
        terms.append(x - lap_matvec(lap, x))
    for j in range(1, k - 1):
        t2 = (-lap_matvec(lap, terms[-1]) + (2 * j + 1) * terms[-1]
              - j * terms[-2]) / (j + 1)
        terms.append(t2)
    return terms


def _combine_terms(terms, weights, bias, out_dtype):
    """Σ_k T_k @ W_k + b, the K products and the bias summed in float32,
    rounded to ``out_dtype`` once."""
    out = stack_gemm(terms[0], weights[0])
    for kk in range(1, len(terms)):
        out = out + stack_gemm(terms[kk], weights[kk])
    return (out + bias.float()).to(out_dtype)


def laguerre_matvec(
    x: torch.Tensor, lap, weights: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Functional Laguerre filter: weights [K, C, F], bias [F]; x [G, S, C]
    with dense blocks, or flat [N, C] / [N, T, C] with a `CooMatrix`."""
    k = weights.shape[0]
    dense = isinstance(lap, torch.Tensor) and lap.dim() == 3 and x.dim() == 3
    if dense and use_fused_dense():
        return laguerre_dense_fused(lap, x, weights, bias)
    if dense and use_terms_kernel() and k > 1:
        terms = list(laguerre_terms_dense(lap, x, k).unbind(0))
        return _combine_terms(terms, weights, bias, x.dtype)
    return _combine_terms(polynomial_terms(x, lap, k), weights, bias, x.dtype)


class LaguerreConv(nn.Module):
    """K-term Laguerre spectral conv with a [K, C, F] weight and Glorot
    init per term (the PyG ``Linear(weight_initializer='glorot')`` stack,
    reference lib/Hodge_Cheb_Conv.py:462-465)."""

    def __init__(
        self, in_features: int, features: int, k: int, *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        limit = math.sqrt(6.0 / (in_features + features))
        self.weight = nn.Parameter(
            torch.empty(k, in_features, features).uniform_(-limit, limit, generator=generator)
        )
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, lap) -> torch.Tensor:
        return laguerre_matvec(x, lap, self.weight, self.bias)
