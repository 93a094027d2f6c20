"""ELL SpMM for symmetric square operators: a hand-written Hopper kernel
and its plain version.

Port of ``hl_hgat_tpu/ops/pallas_spmm.py``: ``spmm_ell`` replaces
``spmm_ell_pallas`` (kernel body ``_spmm_ell_kernel``, :38-58) and
``spmm_ell_symmetric`` its custom VJP (:107-132):

    out[r] = Σ_j vals[r, j] · x[cols[r, j]]        cols, vals [N, W]; x [N, F]

accumulated in float32 and rounded once to x's dtype.  Padding slots carry
``vals == 0`` and a column in range.  On an H100 the kernel is bound by
bytes (cols and vals read once, x read once, out written once).

The kernel is CUDA C++ in ``csrc/ell_spmm.cu`` (its header has the design).
``spmm_ell`` launches it for CUDA tensors and raises on anything it does not
take; it runs the plain version, ``spmm_ell_plain``, only for tensors on the
CPU.  ``spmm_ell_symmetric`` is the differentiable form: because the
operator equals its transpose, ``dx`` is the same kernel on the cotangent;
``dvals`` (an SDDMM on the ELL pattern, masked where ``vals == 0``) is plain
torch, as it is plain XLA in the JAX package, and is computed only when
asked for — operators are data, and no model asks.

``LAUNCHES`` counts kernel launches: ``spmm_ell`` in the forward,
``spmm_ell_bwd`` for ``dx`` in the backward.  ``use_ell_kernel(False)``
sends CUDA tensors through the plain gather instead, for comparing the two
routes on the card.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"spmm_ell": 0, "spmm_ell_bwd": 0}

_lib: ctypes.CDLL | None = None
_ell_kernel_flag = True


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def use_ell_kernel(enable: bool | None = None) -> bool:
    """Get/set whether ``spmm_ell_symmetric`` launches the kernel for CUDA
    tensors (default on).  Off selects the plain gather route on the card;
    CPU tensors take the plain version either way."""
    global _ell_kernel_flag
    if enable is not None:
        _ell_kernel_flag = enable
    return _ell_kernel_flag


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from hl_hgat_tpu_torch import cuda_build

        lib = cuda_build.load("ell_spmm")
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hlhgat_ell_spmm.argtypes = [p, p, p, p, q, i, q, i, i, p]
        lib.hlhgat_ell_spmm.restype = i
        lib.hlhgat_cuda_error_string.argtypes = [i]
        lib.hlhgat_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_shapes(ell_cols: torch.Tensor, ell_vals: torch.Tensor, x: torch.Tensor) -> None:
    if ell_cols.dim() != 2 or ell_vals.shape != ell_cols.shape:
        raise ValueError(
            f"need cols and vals [N, W], got {tuple(ell_cols.shape)}, {tuple(ell_vals.shape)}")
    if x.dim() < 2:
        raise ValueError(f"need x [N, F] or [N, ..., F], got {tuple(x.shape)}")
    if ell_cols.shape[0] != x.shape[0]:
        raise ValueError(
            f"the ELL product takes a square operator (R={ell_cols.shape[0]} != "
            f"N={x.shape[0]})")
    if ell_cols.shape[1] < 1:
        raise ValueError("ELL width must be at least 1")


def spmm_ell_plain(ell_cols: torch.Tensor, ell_vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain version: gather the W rows of every row, multiply in
    float32, sum over the slot axis, round once to x's dtype.  x may carry
    trailing axes ([N, T, C])."""
    _check_shapes(ell_cols, ell_vals, x)
    gathered = x[ell_cols.long()]  # [N, W, F...]
    vals = ell_vals.reshape(ell_vals.shape + (1,) * (x.dim() - 1))
    return (gathered.float() * vals.float()).sum(dim=1).to(x.dtype)


def spmm_ell_dvals_plain(
    ell_cols: torch.Tensor, ell_vals: torch.Tensor, x: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """``dvals[r, j] = ⟨g[r], x[cols[r, j]]⟩`` (float32 sum), zero where
    ``vals == 0`` so padding slots get no gradient; in vals' dtype."""
    n, w = ell_cols.shape
    gathered = x.reshape(n, -1)[ell_cols.long()].float()  # [N, W, F]
    dvals = (gathered * g.reshape(n, 1, -1).float()).sum(dim=-1)
    return torch.where(ell_vals != 0, dvals, torch.zeros_like(dvals)).to(ell_vals.dtype)


def _launch(ell_cols, ell_vals, x, counter: str) -> torch.Tensor:
    _check_shapes(ell_cols, ell_vals, x)
    if x.device.type != "cuda" or ell_cols.device != x.device or ell_vals.device != x.device:
        raise ValueError("cols, vals and x must lie on the same CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if ell_vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"vals must be float32 or bfloat16, got {ell_vals.dtype}")
    if ell_cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {ell_cols.dtype}")
    n, w = ell_cols.shape
    flat = x.reshape(n, -1).contiguous()
    if flat.data_ptr() % 16:  # a view into a larger buffer: the kernel loads 16 bytes
        flat = flat.clone()
    out = torch.empty_like(flat)
    if out.numel() == 0:
        return out.reshape(x.shape)
    cols = ell_cols.contiguous()
    vals = ell_vals.contiguous()
    lib = _library()
    with torch.cuda.device(x.device):
        code = lib.hlhgat_ell_spmm(
            cols.data_ptr(), vals.data_ptr(), flat.data_ptr(), out.data_ptr(),
            n, w, flat.shape[1], int(x.dtype == torch.bfloat16),
            int(vals.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if code != 0:
        msg = lib.hlhgat_cuda_error_string(code).decode()
        raise RuntimeError(f"{counter} launch failed: {msg} (cudaError {code})")
    LAUNCHES[counter] += 1
    return out.reshape(x.shape)


def spmm_ell(ell_cols: torch.Tensor, ell_vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """ELL SpMM, not differentiable: cols [N, W] int32, vals [N, W], x
    [N, F] (or [N, ..., F], flattened for the product) → x's shape and
    dtype.  Launches the kernel for CUDA tensors, runs the plain version
    for CPU tensors."""
    if x.device.type == "cpu":
        return spmm_ell_plain(ell_cols, ell_vals, x)
    return _launch(ell_cols, ell_vals, x, "spmm_ell")


class _EllSymmetric(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ell_cols, ell_vals, x):
        ctx.save_for_backward(ell_cols, ell_vals, x)
        return spmm_ell(ell_cols, ell_vals, x)

    @staticmethod
    def backward(ctx, g):
        ell_cols, ell_vals, x = ctx.saved_tensors
        dvals = dx = None
        if ctx.needs_input_grad[1]:
            dvals = spmm_ell_dvals_plain(ell_cols, ell_vals, x, g)
        if ctx.needs_input_grad[2]:
            g = g.to(x.dtype)
            if g.device.type == "cpu":
                dx = spmm_ell_plain(ell_cols, ell_vals, g)
            else:
                dx = _launch(ell_cols, ell_vals, g, "spmm_ell_bwd")  # Aᵀ = A
        return None, dvals, dx


def spmm_ell_symmetric(
    ell_cols: torch.Tensor, ell_vals: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Differentiable ELL SpMM for a symmetric operator (L0, L1): gradients
    for x (the same product on the cotangent) and, when asked, for vals."""
    if x.device.type == "cuda" and not use_ell_kernel():
        return spmm_ell_plain(ell_cols, ell_vals, x)
    return _EllSymmetric.apply(ell_cols, ell_vals, x)
