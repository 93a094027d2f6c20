"""Dense-block Laguerre filter: hand-written Hopper kernels + plain versions.

Port of ``hl_hgat_tpu/ops/pallas_hodge.py`` (forward kernels only):

* ``laguerre_dense_fused`` replaces ``_fwd_kernel`` (pallas_hodge.py:93-120,
  reached through ``_fused_fwd_impl`` :191-215): the whole recurrence
  ``T0 = x, T1 = x − Lx, T_{k+1} = (−L·T_k + (2k+1)·T_k − k·T_{k−1})/(k+1)``
  plus ``Σ_k T_k @ W_k + b`` per graph block, the terms never leaving the
  chip.  On an H100 it is bound by operations: 0.166 ms (f32) at
  zinc_pyr's widest layer, G=78, S=128, C=F=256, K=6.
* ``laguerre_terms_dense`` replaces ``_terms_fwd_kernel`` (:285-290, via
  ``_terms_fwd_impl`` :310-333): all K terms in one pass with L resident;
  at that layer bound by operations in f32 (0.049 ms) and by the bytes
  of the K terms it writes in bf16 (0.011 ms).

Both kernels are CUDA C++ in ``csrc/laguerre_dense.cu`` (its header has
the design).  A wrapper launches its kernel for a CUDA tensor and raises on
anything the kernel does not take; it runs the plain PyTorch version, in
this module, only for a tensor on the CPU.  ``LAUNCHES`` counts kernel
launches per wrapper.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"laguerre_dense_fused": 0, "laguerre_terms_dense": 0}
MAX_BLOCK = 128  # L tile held in shared memory: S <= 128
_SMEM_LIMIT = 232448  # bytes a block may opt into on sm_90

_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from hl_hgat_tpu_torch import cuda_build

        lib = cuda_build.load("laguerre_dense")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hlhgat_laguerre_fused_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.hlhgat_laguerre_fused_fwd.restype = i
        lib.hlhgat_laguerre_terms_fwd.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.hlhgat_laguerre_terms_fwd.restype = i
        lib.hlhgat_laguerre_fused_smem.argtypes = [i, i]
        lib.hlhgat_laguerre_fused_smem.restype = ctypes.c_size_t
        lib.hlhgat_cuda_error_string.argtypes = [i]
        lib.hlhgat_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_launch(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.hlhgat_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {code})")


def _check_inputs(l: torch.Tensor, x: torch.Tensor) -> None:
    if x.device.type != "cuda" or l.device != x.device:
        raise ValueError("l and x must lie on the same CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or l.dim() != 3 or l.shape != (x.shape[0], x.shape[1], x.shape[1]):
        raise ValueError(f"need l [G,S,S] and x [G,S,C], got {tuple(l.shape)}, {tuple(x.shape)}")
    if x.shape[1] > MAX_BLOCK:
        raise ValueError(f"block size {x.shape[1]} > {MAX_BLOCK}")


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


def _no_tf32() -> None:
    # the JAX kernels run f32 at Precision.HIGHEST: TF32 would drop ~3 digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated in float32 (float32 result)."""
    return torch.matmul(a.float(), b.float())


def laguerre_terms_plain(l: torch.Tensor, x: torch.Tensor, k: int) -> list[torch.Tensor]:
    """The K terms with the JAX kernel's rounding points: L cast to x's
    dtype, each L·T accumulated in f32 and rounded to x's dtype, the
    combine computed in x's dtype."""
    _no_tf32()
    l = l.to(x.dtype)
    terms = [x]
    if k > 1:
        terms.append(x - _dot(l, x).to(x.dtype))
    for j in range(1, k - 1):
        lt = _dot(l, terms[-1]).to(x.dtype)
        terms.append((-lt + (2 * j + 1) * terms[-1] - j * terms[-2]) / (j + 1))
    return terms


def laguerre_terms_dense_plain(l: torch.Tensor, x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.stack(laguerre_terms_plain(l, x, k))


def laguerre_dense_fused_plain(
    l: torch.Tensor, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Σ_k T_k @ W_k + b: W cast to x's dtype, the K products summed in
    f32 with the f32 bias, one rounding to x's dtype at the end."""
    terms = laguerre_terms_plain(l, x, w.shape[0])
    acc = _dot(terms[0], w[0].to(x.dtype))
    for kk in range(1, len(terms)):
        acc = acc + _dot(terms[kk], w[kk].to(x.dtype))
    return (acc + b.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def laguerre_dense_fused(
    l: torch.Tensor, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Fused Laguerre filter: l [G,S,S], x [G,S,C], w [K,C,F], b [F] →
    [G,S,F] in x's dtype."""
    if x.device.type == "cpu":
        return laguerre_dense_fused_plain(l, x, w, b)
    _check_inputs(l, x)
    g, s, c = x.shape
    k, c_w, f = w.shape
    if c_w != c or b.shape != (f,) or k < 1:
        raise ValueError(f"need w [K,{c},F] and b [F], got {tuple(w.shape)}, {tuple(b.shape)}")
    out = torch.empty((g, s, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _library()
    if lib.hlhgat_laguerre_fused_smem(s, k) > _SMEM_LIMIT:
        raise ValueError(f"K={k} needs more shared memory than a block has")
    l = l.to(x.dtype).contiguous()
    x = x.contiguous()
    w = w.to(device=x.device, dtype=torch.float32).contiguous()
    b = b.to(device=x.device, dtype=torch.float32).contiguous()
    with torch.cuda.device(x.device):
        code = lib.hlhgat_laguerre_fused_fwd(
            l.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), g, s, c, f, k, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    _check_launch(lib, code, "laguerre_dense_fused")
    LAUNCHES["laguerre_dense_fused"] += 1
    return out


def laguerre_terms_dense(l: torch.Tensor, x: torch.Tensor, k: int) -> torch.Tensor:
    """All K Laguerre terms: l [G,S,S], x [G,S,C] → [K,G,S,C] in x's dtype."""
    if x.device.type == "cpu":
        return laguerre_terms_dense_plain(l, x, k)
    _check_inputs(l, x)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    g, s, c = x.shape
    out = torch.empty((k, g, s, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _library()
    l = l.to(x.dtype).contiguous()
    x = x.contiguous()
    with torch.cuda.device(x.device):
        code = lib.hlhgat_laguerre_terms_fwd(
            l.data_ptr(), x.data_ptr(), out.data_ptr(), g, s, c, k,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    _check_launch(lib, code, "laguerre_terms_dense")
    LAUNCHES["laguerre_terms_dense"] += 1
    return out
