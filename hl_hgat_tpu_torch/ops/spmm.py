"""COO SpMM / SDDMM in plain torch (``hl_hgat_tpu/ops/spmm.py``).

``spmm_coo`` is gather → scale → float32 ``index_add_``; its backward is
the pair the JAX package writes by hand, ``dX = Aᵀ G`` (the same pipeline
on the transposed pattern) and ``dvals = ⟨G[row], X[col]⟩`` (an SDDMM on
the pattern).  Padded entries carry ``vals == 0``
and indices in range.  ``spmm_ell_sym`` is the same contraction on the ELL
form of a symmetric operator: the plain version of the hand-written kernel
in ``ops/ell_spmm.py``.
"""

from __future__ import annotations

import torch

from hl_hgat_tpu_torch.ops.ell_spmm import spmm_ell_plain
from hl_hgat_tpu_torch.ops.segment import segment_sum


def _spmm_impl(rows, cols, vals, x, num_rows: int) -> torch.Tensor:
    gathered = x[cols.long()] * vals.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
    return segment_sum(gathered.float(), rows, num_rows).to(x.dtype)


class _SpmmCoo(torch.autograd.Function):
    """The JAX package's custom VJP: ``dX = Aᵀ G`` is the same pipeline
    with rows and cols swapped (float32 sum, one rounding, also in bf16),
    ``dvals`` an SDDMM on the pattern."""

    @staticmethod
    def forward(ctx, rows, cols, vals, x, num_rows):
        ctx.save_for_backward(rows, cols, vals, x)
        return _spmm_impl(rows, cols, vals, x, num_rows)

    @staticmethod
    def backward(ctx, g):
        rows, cols, vals, x = ctx.saved_tensors
        dvals = dx = None
        if ctx.needs_input_grad[2]:
            dvals = sddmm_coo(rows, cols, g, x).to(vals.dtype)
        if ctx.needs_input_grad[3]:
            dx = _spmm_impl(cols, rows, vals, g, x.shape[0])
        return None, None, dvals, dx, None


def spmm_coo(
    rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
    num_rows: int,
) -> torch.Tensor:
    """``out[r] = Σ_i vals[i] · x[cols[i]]`` over entries with ``rows[i] ==
    r``: rows/cols [nnz] int, vals [nnz], x [num_cols, F] → [num_rows, F]
    in x's dtype (products in x's dtype, the sum in float32)."""
    return _SpmmCoo.apply(rows, cols, vals, x, num_rows)


def spmm_ell_sym(ell_cols: torch.Tensor, ell_vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[r] = Σ_w ell_vals[r, w] · x[ell_cols[r, w]]`` by row gathers,
    differentiable by autograd (x [N, ...] with any trailing axes)."""
    return spmm_ell_plain(ell_cols, ell_vals, x)


def sddmm_coo(rows: torch.Tensor, cols: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense product ``out[i] = ⟨a[rows[i]], b[cols[i]]⟩``:
    a [N, F], b [M, F] → [nnz] in a's dtype (float32 accumulation)."""
    return (a[rows.long()].float() * b[cols.long()].float()).sum(dim=-1).to(a.dtype)


def coo_transpose(rows, cols, vals):
    """Transpose a COO pattern (no resorting: SpMM is order-free)."""
    return cols, rows, vals


def spmm_dense_oracle(rows, cols, vals, x: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Dense reference for tests: materialize A, matmul in float32."""
    dense = torch.zeros((num_rows, x.shape[0]), dtype=torch.float32, device=x.device)
    dense.index_put_((rows.long(), cols.long()), vals.float(), accumulate=True)
    return torch.matmul(dense, x.float()).to(x.dtype)
