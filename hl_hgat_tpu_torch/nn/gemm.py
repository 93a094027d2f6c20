"""The stack GEMM y = x @ W (forward of ``hl_hgat_tpu/nn/gemm.py``)."""

from __future__ import annotations

import torch


def stack_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ W`` with W cast to x's dtype and a float32 result (the f32
    accumulator; the caller sums pieces or terms in f32 and casts once).

    Operands are widened to f32 before the product: a bf16 product is exact
    in f32, so this is the bf16 GEMM with f32 accumulation, never rounded
    to bf16 in between.
    """
    return torch.matmul(x.float(), w.to(x.dtype).float())
