"""Dense-block Laguerre filter: hand-written Hopper kernels + plain versions.

Port of ``hl_hgat_tpu/ops/pallas_hodge.py``, forward and backward:

* ``laguerre_dense_fused`` replaces ``_fwd_kernel`` (pallas_hodge.py:93-120,
  reached through ``_fused_fwd_impl`` :191-215): the whole recurrence
  ``T0 = x, T1 = x − Lx, T_{k+1} = (−L·T_k + (2k+1)·T_k − k·T_{k−1})/(k+1)``
  plus ``Σ_k T_k @ W_k + b`` per graph block, the terms never leaving the
  chip.  On an H100 it is bound by operations: at zinc_pyr's widest layer,
  G=78, S=128, C=F=256, K=6, 0.067 ms in float32 (3xTF32 on the tensor
  cores, 495/3 TFLOP/s) and 0.011 ms in bfloat16 (989 TFLOP/s).
* ``laguerre_terms_dense`` replaces ``_terms_fwd_kernel`` (:285-290, via
  ``_terms_fwd_impl`` :310-333): all K terms in one pass with L resident;
  at that layer bound by operations in f32 (0.020 ms) and by the bytes
  of the K terms it writes in bf16 (0.011 ms).
* ``laguerre_dense_fused_bwd`` replaces ``_bwd_kernel`` (:123-174, via
  ``_fused_bwd`` :222-264): from ``(l, x, w)`` and the cotangent ``g`` it
  recomputes the terms, gives ``dW_k = Σ_g T_kᵀ g`` and ``db = Σ g`` in
  float32 and ``dx`` by the adjoint recurrence over ``b̄_k = g W_kᵀ``.
  Twice the forward's operations: 0.135 ms (f32) at the widest layer.
* ``laguerre_terms_dense_bwd`` replaces ``_terms_bwd_kernel`` (:293-307,
  via ``_terms_vjp_bwd`` :348-375): ``dx`` by the adjoint recurrence over
  the K term cotangents; the forward's operations and bytes.

L is symmetric and is data: neither backward gives a gradient for it.

The forward kernels are CUDA C++ in ``csrc/laguerre_dense.cu``, the
backward kernels in ``csrc/laguerre_dense_bwd.cu`` (the headers have the
designs).  The two fused kernels run every product on the tensor cores
with float32 accumulation — bfloat16 as ``mma.sync.m16n8k16`` fed by
``ldmatrix``, float32 as three TF32 passes over operands split into a high
and a low part, which keeps float32 accuracy — with L, the term tiles, g
and the weight slices in shared memory in x's type and the global loads
as 16-byte ``cp.async``.  Forward and backward run the recurrence once per
(graph block, channel) for F <= 256; the forward takes any K, the
backward K <= ``MAX_BWD_K`` (one register accumulator set per term).
Both take any block size S <= ``MAX_BLOCK``, any C and F; at most 226 KB
of shared memory, checked against ``_SMEM_LIMIT``.  The terms kernels are the first
version on CUDA cores.

The public functions are ``torch.autograd.Function``s: forward and
backward each launch their kernel for CUDA tensors and raise on anything
the kernel does not take; they run the plain PyTorch versions, in this
module, only for tensors on the CPU.  The plain backward versions are the
hand-derived adjoints written step by step, not autograd through the
plain forward.  ``emulated_products`` lets a test run the plain versions
with the float32 kernels' split products.  ``LAUNCHES`` counts kernel
launches per wrapper (a backward that needs several CUDA kernels counts
once).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

LAUNCHES = {
    "laguerre_dense_fused": 0,
    "laguerre_terms_dense": 0,
    "laguerre_dense_fused_bwd": 0,
    "laguerre_terms_dense_bwd": 0,
}
MAX_BLOCK = 128  # L tile held in shared memory: S <= 128
_SMEM_LIMIT = 232448  # bytes a block may opt into on sm_90

MAX_BWD_K = 8  # the backward kernels keep one register accumulator set per term

_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _library(name: str = "laguerre_dense") -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its C signatures set."""
    if name not in _libs:
        from hl_hgat_tpu_torch import cuda_build

        lib = cuda_build.load(name)
        p, i, z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        if name == "laguerre_dense":
            sigs = {
                "hlhgat_laguerre_fused_fwd": ([p] * 6 + [i] * 6 + [p], i),
                "hlhgat_laguerre_terms_fwd": ([p, p, p, i, i, i, i, i, p], i),
                "hlhgat_laguerre_fused_smem": ([i, i, i], z),
            }
        else:
            sigs = {
                "hlhgat_laguerre_fused_bwd": ([p] * 8 + [i] * 7 + [p], i),
                "hlhgat_laguerre_terms_bwd": ([p, p, p, i, i, i, i, i, p], i),
                "hlhgat_laguerre_fused_bwd_smem": ([i, i, i], z),
                "hlhgat_laguerre_terms_bwd_smem": ([i, i], z),
                "hlhgat_laguerre_fused_bwd_splits": ([i, i, i], i),
            }
        sigs["hlhgat_cuda_error_string"] = ([i], ctypes.c_char_p)
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
    return _libs[name]


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


_products: str | None = None  # None: exact float32 products; "tf32x3", "tf32": emulated


@contextlib.contextmanager
def emulated_products(mode: str | None):
    """Within the block the plain versions form every float32 matrix
    product as the card's tensor cores would: ``"tf32x3"`` as the fused
    kernels do (each operand split into ``hi = tf32(a)`` and
    ``lo = tf32(a − hi)``, then ``a_lo·b_hi + a_hi·b_lo + a_hi·b_hi``
    summed in float32), ``"tf32"`` as one TF32 pass would.  bfloat16
    operands are exact in TF32, so only float32 inputs change.  For tests
    of the arithmetic; no entry point uses it."""
    global _products
    if mode not in (None, "tf32x3", "tf32"):
        raise ValueError(f"unknown product emulation {mode!r}")
    before, _products = _products, mode
    try:
        yield
    finally:
        _products = before


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated in float32 (float32 result)."""
    a, b = a.float(), b.float()
    if _products is None:
        return torch.matmul(a, b)
    a_hi, b_hi = _tf32(a), _tf32(b)
    if _products == "tf32":
        return torch.matmul(a_hi, b_hi)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)) + torch.matmul(a_hi, b_hi)


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


def _adjoint_walk(l: torch.Tensor, bars: list[torch.Tensor]) -> torch.Tensor:
    """dx from the K term cotangents ``bars`` (each [G,S,C] in the compute
    dtype) by the adjoint of the recurrence, L symmetric: walk k = K−1 … 2
    folding each cotangent into the two below it, then close with
    ``dx = b̄_0 + b̄_1 − L·b̄_1``.  Each L·b̄ is accumulated in f32 and
    rounded; every elementwise step is computed in the compute dtype."""
    bars = list(bars)
    dtype = bars[0].dtype
    for kk in range(len(bars) - 1, 1, -1):
        jj = kk - 1  # T_{j+1} = (−L·T_j + (2j+1)·T_j − j·T_{j−1}) / (j+1)
        bt = bars[kk]
        lbt = _dot(l, bt).to(dtype)
        bars[kk - 1] = bars[kk - 1] + (-lbt + (2 * jj + 1) * bt) / (jj + 1)
        # the coefficient is rounded to the compute dtype, as a JAX weak
        # scalar is before it meets a bf16 array
        coef = torch.tensor(jj / (jj + 1), dtype=dtype, device=bt.device)
        bars[kk - 2] = bars[kk - 2] - coef * bt
    dx = bars[0]
    if len(bars) > 1:
        dx = dx + bars[1] - _dot(l, bars[1]).to(dtype)
    return dx


def laguerre_terms_dense_bwd_plain(l: torch.Tensor, dt: torch.Tensor, k: int) -> torch.Tensor:
    """VJP of the terms: l [G,S,S], dt [K,G,S,C] → dx [G,S,C] in dt's
    dtype (``_terms_bwd_kernel`` step by step)."""
    if dt.shape[0] != k:
        raise ValueError(f"dt has {dt.shape[0]} terms, expected {k}")
    _no_tf32()
    return _adjoint_walk(l.to(dt.dtype), list(dt.unbind(0)))


def laguerre_dense_fused_bwd_plain(
    l: torch.Tensor, x: torch.Tensor, w: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """VJP of the fused filter (``_bwd_kernel`` step by step): the terms
    recomputed from x; ``dW_k = Σ_g T_kᵀ g`` and ``db = Σ g`` accumulated
    and returned in float32; ``b̄_k = g W_kᵀ`` accumulated in f32 and
    rounded to x's dtype; dx (x's dtype) by the adjoint recurrence."""
    g = g.to(x.dtype)
    terms = laguerre_terms_plain(l, x, w.shape[0])
    g2 = g.reshape(-1, g.shape[-1]).float()
    dw = torch.stack([_dot(t.reshape(-1, t.shape[-1]).t(), g2) for t in terms])
    db = g2.sum(dim=0)
    bars = [_dot(g, w[kk].to(x.dtype).t()).to(x.dtype) for kk in range(w.shape[0])]
    return _adjoint_walk(l.to(x.dtype), bars), dw, db


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> int:
    return int(x.dtype == torch.bfloat16)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _w_scratch(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor | None:
    """The buffer into which the kernel casts W where x is bfloat16 (the
    float32 kernels read w itself)."""
    if x.dtype == torch.float32:
        return None
    return torch.empty(w.shape, dtype=x.dtype, device=x.device)


def _fused_fwd_cuda(l, x, w, b) -> torch.Tensor:
    _check_inputs(l, x)
    g, s, c = x.shape
    k, c_w, f = w.shape
    if c_w != c or b.shape != (f,) or k < 1:
        raise ValueError(f"need w [K,{c},F] and b [F], got {tuple(w.shape)}, {tuple(b.shape)}")
    out = torch.empty((g, s, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _library()
    if lib.hlhgat_laguerre_fused_smem(s, f, _bf16(x)) > _SMEM_LIMIT:
        raise ValueError(f"S={s}, F={f} need more shared memory than a block has")
    l = l.to(x.dtype).contiguous()
    x = x.contiguous()
    w = w.to(device=x.device, dtype=torch.float32).contiguous()
    b = b.to(device=x.device, dtype=torch.float32).contiguous()
    wt = _w_scratch(w, x)
    with torch.cuda.device(x.device):
        code = lib.hlhgat_laguerre_fused_fwd(
            l.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), None if wt is None else wt.data_ptr(),
            g, s, c, f, k, _bf16(x), _stream(),
        )
    _check_launch(lib, code, "laguerre_dense_fused")
    LAUNCHES["laguerre_dense_fused"] += 1
    return out


def _terms_fwd_cuda(l, x, k: int) -> torch.Tensor:
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
            _bf16(x), _stream(),
        )
    _check_launch(lib, code, "laguerre_terms_dense")
    LAUNCHES["laguerre_terms_dense"] += 1
    return out


def laguerre_dense_fused_bwd(
    l: torch.Tensor, x: torch.Tensor, w: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """VJP of ``laguerre_dense_fused`` from its residuals: l [G,S,S],
    x [G,S,C], w [K,C,F] and the cotangent g [G,S,F] → dx [G,S,C] (x's
    dtype), dw [K,C,F] and db [F] (float32).

    On the card: one kernel for dx, one that writes per-slice partial sums
    of dW and db over the graph blocks, one that adds the partials in a
    fixed order — the result does not depend on how the blocks were
    scheduled (and a small one that casts W to bfloat16 where x is).  The
    wrapper counts them as one launch.
    """
    if x.device.type == "cpu":
        return laguerre_dense_fused_bwd_plain(l, x, w, g)
    _check_inputs(l, x)
    n_g, s, c = x.shape
    k, c_w, f = w.shape
    if c_w != c or g.shape != (n_g, s, f) or k < 1:
        raise ValueError(
            f"need w [K,{c},F] and g [{n_g},{s},F], got {tuple(w.shape)}, {tuple(g.shape)}")
    if k > MAX_BWD_K:
        raise ValueError(f"the backward kernel takes K <= {MAX_BWD_K}, got {k}")
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    n_w = k * c * f
    dwdb = torch.zeros(n_w + f, dtype=torch.float32, device=x.device)
    if x.numel() and g.numel():
        lib = _library("laguerre_dense_bwd")
        if lib.hlhgat_laguerre_fused_bwd_smem(s, k, _bf16(x)) > _SMEM_LIMIT:
            raise ValueError(f"K={k} needs more shared memory than a block has")
        n_split = lib.hlhgat_laguerre_fused_bwd_splits(n_g, c, f)
        partial = torch.empty((n_split, n_w + f), dtype=torch.float32, device=x.device)
        l = l.to(x.dtype).contiguous()
        x = x.contiguous()
        g = g.to(x.dtype).contiguous()
        w = w.to(device=x.device, dtype=torch.float32).contiguous()
        wt = _w_scratch(w, x)
        with torch.cuda.device(x.device):
            code = lib.hlhgat_laguerre_fused_bwd(
                l.data_ptr(), x.data_ptr(), w.data_ptr(), g.data_ptr(),
                dx.data_ptr(), dwdb.data_ptr(), partial.data_ptr(),
                None if wt is None else wt.data_ptr(),
                n_g, s, c, f, k, n_split, _bf16(x), _stream(),
            )
        _check_launch(lib, code, "laguerre_dense_fused_bwd")
        LAUNCHES["laguerre_dense_fused_bwd"] += 1
    elif x.numel():
        dx.zero_()
    return dx, dwdb[:n_w].view(k, c, f), dwdb[n_w:]


def laguerre_terms_dense_bwd(l: torch.Tensor, dt: torch.Tensor, k: int) -> torch.Tensor:
    """VJP of ``laguerre_terms_dense``: l [G,S,S], dt [K,G,S,C] → dx
    [G,S,C] in dt's dtype."""
    if dt.device.type == "cpu":
        return laguerre_terms_dense_bwd_plain(l, dt, k)
    if dt.dim() != 4 or dt.shape[0] != k:
        raise ValueError(f"need dt [{k},G,S,C], got {tuple(dt.shape)}")
    _check_inputs(l, dt[0])
    _, n_g, s, c = dt.shape
    dx = torch.empty((n_g, s, c), dtype=dt.dtype, device=dt.device)
    if dx.numel() == 0:
        return dx
    lib = _library("laguerre_dense_bwd")
    if lib.hlhgat_laguerre_terms_bwd_smem(s, k) > _SMEM_LIMIT:
        raise ValueError(f"K={k} needs more shared memory than a block has")
    l = l.to(dt.dtype).contiguous()
    dt = dt.contiguous()
    with torch.cuda.device(dt.device):
        code = lib.hlhgat_laguerre_terms_bwd(
            l.data_ptr(), dt.data_ptr(), dx.data_ptr(), n_g, s, c, k,
            _bf16(dt), _stream(),
        )
    _check_launch(lib, code, "laguerre_terms_dense_bwd")
    LAUNCHES["laguerre_terms_dense_bwd"] += 1
    return dx


# ---------------------------------------------------------------------------
# the differentiable public functions
# ---------------------------------------------------------------------------


class _FusedFunction(torch.autograd.Function):
    """Saves (l, x, w); backward recomputes the terms (no term is kept)."""

    @staticmethod
    def forward(ctx, l, x, w, b):
        ctx.save_for_backward(l, x, w)
        if x.device.type == "cpu":
            return laguerre_dense_fused_plain(l, x, w, b)
        return _fused_fwd_cuda(l, x, w, b)

    @staticmethod
    def backward(ctx, g):
        l, x, w = ctx.saved_tensors
        dx, dw, db = laguerre_dense_fused_bwd(l, x, w, g)
        return None, dx, dw.to(w.dtype), db.to(w.dtype)


class _TermsFunction(torch.autograd.Function):
    """Saves l only: the adjoint recurrence needs no term."""

    @staticmethod
    def forward(ctx, l, x, k):
        ctx.save_for_backward(l)
        ctx.k = k
        if x.device.type == "cpu":
            return laguerre_terms_dense_plain(l, x, k)
        return _terms_fwd_cuda(l, x, k)

    @staticmethod
    def backward(ctx, dt):
        (l,) = ctx.saved_tensors
        return None, laguerre_terms_dense_bwd(l, dt, ctx.k), None


def laguerre_dense_fused(
    l: torch.Tensor, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Fused Laguerre filter: l [G,S,S], x [G,S,C], w [K,C,F], b [F] →
    [G,S,F] in x's dtype.  Differentiable in x, w and b (dx in x's dtype,
    dw and db in the parameters' dtype); l gets no gradient."""
    return _FusedFunction.apply(l, x, w, b)


def laguerre_terms_dense(l: torch.Tensor, x: torch.Tensor, k: int) -> torch.Tensor:
    """All K Laguerre terms: l [G,S,S], x [G,S,C] → [K,G,S,C] in x's
    dtype.  Differentiable in x; l gets no gradient."""
    return _TermsFunction.apply(l, x, k)
