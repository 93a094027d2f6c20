"""The stack GEMM y = x @ W (``hl_hgat_tpu/nn/gemm.py``)."""

from __future__ import annotations

import torch


class _StackGemm(torch.autograd.Function):
    """Forward: W cast to x's dtype, operands widened to f32 (a bf16
    product is exact in f32, so this is the bf16 GEMM with f32
    accumulation), f32 result.  Backward: both contractions in f32 —
    ``dW = xᵀ @ g`` returned in W's dtype without a detour through x's,
    ``dx = g @ Wᵀ`` rounded once to x's dtype.  Saves x and W as given, not
    their f32 copies."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(x.float(), w.to(x.dtype).float())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float()
        x2 = x.reshape(-1, x.shape[-1]).float()
        dw = torch.matmul(x2.t(), g2).to(w.dtype)
        dx = torch.matmul(g2, w.to(x.dtype).float().t()).reshape(x.shape).to(x.dtype)
        return dx, dw


def stack_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ W`` with W cast to x's dtype and a float32 result (the f32
    accumulator; the caller sums pieces or terms in f32 and casts once).

    The backward is the JAX package's ``use_swap_dw(True)`` formulation for
    every dtype: in float32 it equals plain autodiff of the product; in
    bfloat16 the f32 cotangent is contracted in f32, dW stays f32 and dx is
    rounded to bf16 once per GEMM.  (Autograd through the casts would round
    dW to bf16 on its way back to the f32 parameter.)  There is no switch:
    bf16 gradients compare against JAX with ``use_swap_dw(True)``, f32
    gradients against either setting.
    """
    return _StackGemm.apply(x, w)
