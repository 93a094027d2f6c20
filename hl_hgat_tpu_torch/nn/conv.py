"""Laguerre and Chebyshev spectral convs over Hodge Laplacians
(``hl_hgat_tpu/nn/conv.py``).

    T0 = x,  T1 = x − Lx,  T_{k+1} = (−L·T_k + (2k+1)·T_k − k·T_{k−1}) / (k+1)
    out = Σ_k T_k @ W_k + b           (reference lib/Hodge_Cheb_Conv.py:494,507)

Routes for dense [G, S, S] operators, as in the JAX package:

* ``use_fused_dense()`` (default on): the fused kernel
  (``ops/laguerre_dense.laguerre_dense_fused``), K = 1 included;
* else ``use_terms_kernel()`` and K > 1: the terms kernel produces the
  terms, the per-term GEMMs run in torch (`_combine_terms`);
* else the plain recurrence and GEMMs in torch.

A shared operator (``collate_dense_shared``: lap [1, S, S] for every graph
of x [G, S, C], G > 1) takes, on either kernel route, the terms kernel on
the folded features: the graph axis goes into the columns, x [G, S, C] →
[1, S, G·C], so one launch a conv streams L once for all G graphs (the
JAX package's broadcast einsum, ``ops/dispatch.py:27-37``); the K terms
are unfolded and combined per term by the stack GEMMs.  The fused kernel
takes one [K, C, F] weight per graph block and so no folded block: its
wrappers keep refusing a broadcast L.  A one-term conv on a shared
operator needs no product with L and is its GEMM alone.

Two recurrences always take the plain route, on any device, as in the JAX
package (``_apply_poly`` sends only ``kind == "laguerre"`` to a kernel):
``demo_compat`` (the DEMO fast-conv recurrence, HL-HGAT-DEMO/lib/
Hodge_Cheb_Conv.py:561, which applies L to the input at every step:
``T_{k+1} = (−L·x + (2k+1)·T_k − k·T_{k−1}) / (k+1)``), needed to run the
shipped brain checkpoint, and ``ChebConv`` (``T1 = Lx, T_{k+1} = 2·L·T_k
− T_{k−1}``, reference lib/Hodge_Cheb_Conv.py:412,432), which no reference
model uses.

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


def polynomial_terms(
    x: torch.Tensor, lap, k: int, *, kind: str = "laguerre"
) -> list[torch.Tensor]:
    """The K polynomial features [T_0(L)x, ..., T_{K-1}(L)x] of ``kind``
    ``"laguerre"``, ``"laguerre_demo"`` or ``"chebyshev"``."""
    if kind not in ("laguerre", "laguerre_demo", "chebyshev"):
        raise ValueError(f"unknown polynomial {kind!r}")
    terms = [x]
    if k > 1:
        lx = lap_matvec(lap, x)
        terms.append(lx if kind == "chebyshev" else x - lx)
    for j in range(1, k - 1):
        if kind == "chebyshev":
            terms.append(2.0 * lap_matvec(lap, terms[-1]) - terms[-2])
            continue
        lt = lx if kind == "laguerre_demo" else lap_matvec(lap, terms[-1])
        terms.append((-lt + (2 * j + 1) * terms[-1] - j * terms[-2]) / (j + 1))
    return terms


def is_shared(lap, x: torch.Tensor) -> bool:
    """A dense operator [1, S, S] shared by the G > 1 graphs of x [G, S, C]."""
    return (isinstance(lap, torch.Tensor) and lap.dim() == 3 and x.dim() == 3
            and lap.shape[0] == 1 and x.shape[0] > 1)


def folded_terms(lap: torch.Tensor, x: torch.Tensor, k: int) -> torch.Tensor:
    """The K Laguerre terms of x [G, S, C] on a shared lap [1, S, S] from one
    terms-kernel call on the folded x [1, S, G·C]; returned [K, G, S, C]
    (a view of the kernel's output).  Differentiable in x."""
    g, s, c = x.shape
    folded = x.movedim(0, 1).reshape(1, s, g * c)
    return laguerre_terms_dense(lap, folded, k).reshape(k, s, g, c).movedim(2, 1)


def _combine_terms(terms, weights, bias, out_dtype):
    """Σ_k T_k @ W_k + b, the K products and the bias summed in float32,
    rounded to ``out_dtype`` once."""
    out = stack_gemm(terms[0], weights[0])
    for kk in range(1, len(terms)):
        out = out + stack_gemm(terms[kk], weights[kk])
    return (out + bias.float()).to(out_dtype)


def laguerre_matvec(
    x: torch.Tensor, lap, weights: torch.Tensor, bias: torch.Tensor, *,
    demo_compat: bool = False,
) -> torch.Tensor:
    """Functional Laguerre filter: weights [K, C, F], bias [F]; x [G, S, C]
    with dense blocks (or one shared block), or flat [N, C] / [N, T, C]
    with a `CooMatrix`.  ``demo_compat``: the DEMO recurrence, plain."""
    k = weights.shape[0]
    if demo_compat:
        return _combine_terms(polynomial_terms(x, lap, k, kind="laguerre_demo"), weights, bias,
                              x.dtype)
    if (use_fused_dense() or use_terms_kernel()) and is_shared(lap, x):
        terms = list(folded_terms(lap, x, k).unbind(0)) if k > 1 else [x]
        return _combine_terms(terms, weights, bias, x.dtype)
    dense = isinstance(lap, torch.Tensor) and lap.dim() == 3 and x.dim() == 3
    if dense and use_fused_dense():
        return laguerre_dense_fused(lap, x, weights, bias)
    if dense and use_terms_kernel() and k > 1:
        terms = list(laguerre_terms_dense(lap, x, k).unbind(0))
        return _combine_terms(terms, weights, bias, x.dtype)
    return _combine_terms(polynomial_terms(x, lap, k), weights, bias, x.dtype)


def chebyshev_matvec(
    x: torch.Tensor, lap, weights: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Functional Chebyshev filter, the plain recurrence on any layout."""
    return _combine_terms(polynomial_terms(x, lap, weights.shape[0], kind="chebyshev"),
                          weights, bias, x.dtype)


def _glorot_per_term(k: int, in_features: int, features: int, generator) -> nn.Parameter:
    limit = math.sqrt(6.0 / (in_features + features))
    return nn.Parameter(
        torch.empty(k, in_features, features).uniform_(-limit, limit, generator=generator))


class LaguerreConv(nn.Module):
    """K-term Laguerre spectral conv with a [K, C, F] weight and Glorot
    init per term (the PyG ``Linear(weight_initializer='glorot')`` stack,
    reference lib/Hodge_Cheb_Conv.py:462-465).  ``demo_compat`` selects
    the DEMO recurrence (plain route)."""

    def __init__(
        self, in_features: int, features: int, k: int, *,
        generator: torch.Generator | None = None, demo_compat: bool = False,
    ):
        super().__init__()
        self.weight = _glorot_per_term(k, in_features, features, generator)
        self.bias = nn.Parameter(torch.zeros(features))
        self.demo_compat = demo_compat

    def forward(self, x: torch.Tensor, lap) -> torch.Tensor:
        return laguerre_matvec(x, lap, self.weight, self.bias, demo_compat=self.demo_compat)


class ChebConv(nn.Module):
    """K-term Chebyshev spectral conv (reference HodgeChebConv), [K, C, F]
    weight with the Laguerre conv's init; no reference model uses it."""

    def __init__(self, in_features: int, features: int, k: int, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = _glorot_per_term(k, in_features, features, generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, lap) -> torch.Tensor:
        return chebyshev_matvec(x, lap, self.weight, self.bias)
