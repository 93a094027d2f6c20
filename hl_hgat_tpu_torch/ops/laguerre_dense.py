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
  at that layer bound by the bytes of the K terms it writes, 0.023 ms in
  float32 and 0.011 ms in bfloat16.
* ``laguerre_dense_fused_bwd`` replaces ``_bwd_kernel`` (:123-174, via
  ``_fused_bwd`` :222-264): from ``(l, x, w)`` and the cotangent ``g`` it
  recomputes the terms, gives ``dW_k = Σ_g T_kᵀ g`` and ``db = Σ g`` in
  float32 and ``dx`` by the adjoint recurrence over ``b̄_k = g W_kᵀ``.
  Twice the forward's operations: 0.135 ms (f32) at the widest layer.
* ``laguerre_terms_dense_bwd`` replaces ``_terms_bwd_kernel`` (:293-307,
  via ``_terms_vjp_bwd`` :348-375): ``dx`` by the adjoint recurrence over
  the K term cotangents; the forward's operations and bytes, bound by the
  bytes of the cotangents it reads.

L is symmetric and is data: neither backward gives a gradient for it.

The forward kernels are CUDA C++ in ``csrc/laguerre_dense.cu``, the
backward kernels in ``csrc/laguerre_dense_bwd.cu`` (the headers have the
designs).  All four run every product on the tensor cores with float32
accumulation — bfloat16 as ``mma.sync.m16n8k16`` fed by
``ldmatrix``, float32 as three TF32 passes over operands split into a high
and a low part, which keeps float32 accuracy — with L, the term tiles, g
and the weight slices in shared memory in x's type and the global loads
as 16-byte ``cp.async``.  The fused forward and backward run the
recurrence once per (graph block, channel) for F <= 256; the fused
backward holds the products and dW of at most 8 terms at a time and
carries its adjoint walk from one chunk of terms to the next, so it takes
any K, as the forward does.  The terms kernels write (or read) the K terms
through 16-byte stores (``cp.async`` loads); the terms backward streams
the cotangents through its adjoint walk, so both take any K.  These hold a
graph block's L in shared memory, so they take blocks of S <=
``RESIDENT_ROWS`` (128) rows; the fused kernels need at most 226 KB of
shared memory, checked against ``_SMEM_LIMIT``, the terms kernels 106 KB
(float32) or 54 KB (bfloat16) at S = 128, whatever K is.

Blocks of more rows go, for the same four functions, to the kernels of
``csrc/laguerre_band.cu``: L streamed from device memory by TMA, one
launch a recurrence step (``band_step_kernel``: wgmma fed by a ring of TMA
stages, the tile chosen from S and C, ``band_step_plan``), the terms (and
in the fused backward the cotangents ``g W_kᵀ``) in a scratch buffer the
wrapper allocates, with the same rounding points.  The fused ones' products
(``BAND_PRODUCTS``: ``Σ_k T_k W_k + b``; ``g W_kᵀ``; dW and db) are wgmma
kernels fed by TMA too (``band_product_plan``), reading W as
``band_weights`` prepares it once per weight tensor and version (bfloat16
W, or float32 TF32 halves, K-major for the tensor cores); a column count F
whose rows are not 16 bytes pads W and the cotangent g with zero columns
and leaves the output through a padded buffer.  Every S, K, C and F runs
on the card; no shape reaches the plain versions there.  ``g W_kᵀ`` keeps
a CTA's 64 rows of g in shared memory where they fit (F <= 576 in
float32, 1472 in bfloat16, after F is padded to 16 bytes) and streams
them beside W's chunks for wider F.

The band kernels read L as a prepared operator (``band_operator``): in
bfloat16 L cast to bfloat16, in float32 its TF32 halves ``hi = tf32(L)``
and ``lo = L − hi`` (exact, so ``hi + lo`` is L bit for bit), rows padded
to a multiple of 16 bytes (TMA's stride rule; S = 8997, the brain's
level-0 L1, is not).  It is made once per operator and dtype and cached
against the tensor's identity and ``_version`` (``ops/tensor_cache.py``),
not made where a batch moves to the card: an operator reaches the
wrappers from every layout (packed blocks, the shared brain operator, the
spill layout's blocks, a user's own tensor), and the cache serves them all
without threading a prepared object through the model; an in-place edit
of L bumps its version and so prepares it anew, and the entry goes when L
does.  A bfloat16 L whose rows are already 16-byte multiples (S = 256) is
read as it is and nothing is cached: an entry holding L would keep it
alive.  On the bfloat16 route the model casts its float32 operators on
every forward; ``dispatch.cast_operators`` keeps each cast while its
float32 source lives, so a batch's bfloat16 L is one tensor and is
prepared once too.  Two convs on one level's L read one preparation, and
neither L nor what the plain route and the CPU see changes.  A channel
count whose rows are not a multiple of 16 bytes (C = 45 in float32) is
padded with zero channels around the launch; the recurrence keeps each
channel to itself, so the real channels are unchanged.

The public functions are ``torch.autograd.Function``s: forward and
backward each launch their kernel for CUDA tensors and raise on anything
the kernel does not take; they run the plain PyTorch versions, in this
module, only for tensors on the CPU.  The plain backward versions are the
hand-derived adjoints written step by step, not autograd through the
plain forward.  ``emulated_products`` lets a test run the plain versions
with the float32 kernels' split products.

While the port's recorder is on (``utils/profiling.py``) each launch counts
one ``launches.<wrapper>`` (``laguerre_dense_fused``, ``laguerre_terms_dense``
and their ``_bwd``; a backward that needs several CUDA kernels counts once)
and, where it took the band kernels, one ``band_launches``; each band
operand prepared and cached counts one ``prepared.band_operator`` or
``prepared.band_weights`` and its bytes in ``band_prep_bytes``.
``BAND_SHAPES`` gathers the (G, S, C, dtype) of every band launch that runs
a recurrence step, so that a caller can print how each launched.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import torch

from hl_hgat_tpu_torch import cuda_build
from hl_hgat_tpu_torch.ops.nan_checks import check_kernel_outputs
from hl_hgat_tpu_torch.ops.tensor_cache import TensorCache
from hl_hgat_tpu_torch.utils import profiling

BAND_SHAPES: set[tuple[int, int, int, torch.dtype]] = set()  # (G, S, C, dtype) of band steps
RESIDENT_ROWS = 128  # blocks the kernels that hold L in shared memory take
_SMEM_LIMIT = 232448  # bytes a block may opt into on sm_90

def _check_inputs(l: torch.Tensor, x: torch.Tensor) -> None:
    if x.device.type != "cuda" or l.device != x.device:
        raise ValueError("l and x must lie on the same CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or l.dim() != 3 or l.shape != (x.shape[0], x.shape[1], x.shape[1]):
        raise ValueError(f"need l [G,S,S] and x [G,S,C], got {tuple(l.shape)}, {tuple(x.shape)}")


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
    product as the card's tensor cores would: ``"tf32x3"`` as the float32
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


def _term_scratch(x: torch.Tensor, n: int) -> torch.Tensor | None:
    """n [G,S,C] buffers in x's type for the band kernels' terms or
    cotangents (none when n = 0)."""
    return torch.empty((n, *x.shape), dtype=x.dtype, device=x.device) if n > 0 else None


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def band_row_stride(s: int, dtype: torch.dtype) -> int:
    """The elements a row of S takes when rows must start on 16 bytes."""
    per = 16 // dtype.itemsize
    return -(-s // per) * per


def _band_operator(l: torch.Tensor, dtype: torch.dtype) -> tuple[torch.Tensor, int]:
    """L in ``dtype`` and its row stride: L itself where it is contiguous in
    ``dtype`` on 16 bytes with rows of a multiple of 16 bytes, else a copy
    with rows padded with zeros to one (the kernels never read the
    padding)."""
    l = l.to(dtype)
    s = l.shape[-1]
    ld = band_row_stride(s, dtype)
    if ld == s and l.is_contiguous() and l.data_ptr() % 16 == 0:
        return l, s
    padded = torch.empty((*l.shape[:-1], ld), dtype=dtype, device=l.device)
    padded[..., :s].copy_(l)
    padded[..., s:].zero_()
    return padded, ld


@dataclasses.dataclass(frozen=True)
class BandOperator:
    """L as the band kernels read it: ``data`` [G, S, ld] in bfloat16, or
    in float32 [2, G, S, ld] holding ``hi = tf32(L)`` (rounded to nearest,
    as ``_tf32``) then ``lo = L − hi`` (exact); ``ld`` the row stride in
    elements (rows start on 16 bytes)."""

    data: torch.Tensor
    ld: int


_prepared = TensorCache()  # (L, dtype) -> BandOperator


def _prepare_band_operator(l: torch.Tensor, dtype: torch.dtype) -> BandOperator:
    if dtype == torch.bfloat16:
        return BandOperator(*_band_operator(l, dtype))
    s = l.shape[-1]
    ld = band_row_stride(s, torch.float32)
    src = l.to(torch.float32)
    data = torch.empty((2, *l.shape[:-1], ld), dtype=torch.float32, device=l.device)
    hi = _tf32(src)
    data[0, ..., :s].copy_(hi)
    torch.sub(src, hi, out=data[1, ..., :s])
    data[..., s:].zero_()
    return BandOperator(data, ld)


def band_operator(l: torch.Tensor, dtype: torch.dtype) -> BandOperator:
    """The band kernels' operator for L in ``dtype``, prepared on the first
    request and then served from the cache while L is the same tensor at the
    same version; the entry goes when L is freed.  A bfloat16 L the kernels
    can read as it is comes back as it is, uncached."""
    op = _prepared.lookup(l, dtype)
    if op is not None:
        return op
    with profiling.span("band.prepare"):
        op = _prepare_band_operator(l, dtype)
    if op.data is l:
        return op
    _prepared.put(l, dtype, op)
    profiling.count("prepared.band_operator")
    profiling.count("band_prep_bytes", op.data.nbytes)
    return op


def band_step_plan(g: int, s: int, c: int, dtype: torch.dtype) -> dict:
    """How ``band_step_kernel`` launches for G blocks of S rows and C
    channels in ``dtype`` (the kernel's channels: C rounded up to 16
    bytes): grid, threads, dynamic shared bytes, registers a thread, CTAs
    an SM holds at once, waves (CTAs over what the SMs hold at once), the
    tile's rows and channels.  Needs the card."""
    lib = cuda_build.load("laguerre_band")
    out = (ctypes.c_int * 10)()
    cp = band_row_stride(c, dtype)
    code = lib.hlhgat_band_step_plan(g, s, cp, int(dtype == torch.bfloat16), out)
    cuda_build.check(lib, code, "band_step_kernel plan")
    gx, gy, gz, threads, smem, regs, per_sm, sms, rows, cols = list(out)
    return dict(grid=(gx, gy, gz), threads=threads, smem=smem, regs=regs, ctas_per_sm=per_sm,
                waves=gx * gy * gz / max(per_sm * sms, 1), tile=(rows, cols), channels=cp)


BAND_PRODUCTS = ("band_out_kernel", "band_bar_kernel", "band_dw_kernel")


def band_product_plan(kernel: str, g: int, s: int, c: int, f: int, k: int,
                      dtype: torch.dtype) -> dict:
    """How a product kernel of the fused band entry points (``BAND_PRODUCTS``)
    launches for G blocks of S rows, C channels (rounded up to 16 bytes, as
    the kernels take them), F columns and K terms, in the form of
    ``band_step_plan``.  Needs the card."""
    lib = cuda_build.load("laguerre_band")
    out = (ctypes.c_int * 10)()
    cp = band_row_stride(c, dtype)
    code = lib.hlhgat_band_product_plan(BAND_PRODUCTS.index(kernel), g, s, cp, f, k,
                                        int(dtype == torch.bfloat16), out)
    cuda_build.check(lib, code, f"{kernel} plan")
    gx, gy, gz, threads, smem, regs, per_sm, sms, rows, cols = list(out)
    return dict(grid=(gx, gy, gz), threads=threads, smem=smem, regs=regs, ctas_per_sm=per_sm,
                waves=gx * gy * gz / max(per_sm * sms, 1), tile=(rows, cols), channels=cp)


def _aligned(t: torch.Tensor, c: int) -> torch.Tensor:
    """t [..., C] contiguous, starting on 16 bytes, with c ≥ C channels (the
    extra ones zero): what the band kernels' TMA loads take."""
    t = t.contiguous()
    if t.shape[-1] == c and t.data_ptr() % 16 == 0:
        return t
    out = torch.zeros((*t.shape[:-1], c), dtype=t.dtype, device=t.device)
    out[..., :t.shape[-1]].copy_(t)
    return out


_weights = TensorCache()  # (W, (dtype, transposed, C', F')) -> W as the band products read it


def _prepare_band_weights(w: torch.Tensor, cp: int, fp: int, dtype: torch.dtype,
                          transposed: bool) -> torch.Tensor:
    k, c, f = w.shape
    src = w.to(torch.float32)
    if dtype == torch.bfloat16:
        out = torch.zeros((k, cp, fp), dtype=dtype, device=w.device)
        out[:, :c, :f].copy_(src)
        return out
    if transposed:
        src, (c, f), (cp, fp) = src.transpose(1, 2), (f, c), (fp, cp)
    out = torch.zeros((2, k, cp, fp), dtype=torch.float32, device=w.device)
    hi = _tf32(src)
    out[0, :, :c, :f].copy_(hi)
    torch.sub(src, hi, out=out[1, :, :c, :f])
    return out


def band_weights(w: torch.Tensor, cp: int, fp: int, dtype: torch.dtype,
                 transposed: bool = False) -> torch.Tensor:
    """W [K, C, F] as the fused band products read it, zero past C up to
    ``cp`` channels and past F up to ``fp`` columns (rows of 16 bytes for
    TMA): bfloat16 W [K, cp, fp] cast; float32 its TF32 halves [2, K, cp,
    fp], hi = tf32(W) (rounded to nearest, as ``_tf32``) then lo = W − hi
    (exact, so hi + lo is W), or with ``transposed`` those of Wᵀ [2, K, fp,
    cp] (the output product's B, which TF32 wgmma takes only K-major).
    Prepared on the first request and then served from the cache while W is
    the same tensor at the same version (an optimizer step edits W in place
    and so prepares it anew); the entry goes when W does."""
    tag = (dtype, transposed and dtype == torch.float32, cp, fp)
    hit = _weights.lookup(w, tag)
    if hit is not None:
        return hit
    with profiling.span("band.prepare"):
        out = _prepare_band_weights(w, cp, fp, dtype, tag[1])
    _weights.put(w, tag, out)
    profiling.count("prepared.band_weights")
    profiling.count("band_prep_bytes", out.nbytes)
    return out


# The band entry points on the prepared operator, C padded to 16 bytes
# (``_aligned``) where it is not; each returns the launch's cudaError_t.
# With K = 1 no recurrence step runs and L is not read; the terms kernels
# then keep C as it is, the fused ones' products still read x by TMA.

def _band_layout(l, x, k: int) -> tuple[int, int, int]:
    """(operator pointer, its row stride, the kernels' channel count)."""
    g, s, c = x.shape
    if k == 1:
        return 0, s, c
    BAND_SHAPES.add((g, s, c, x.dtype))
    op = band_operator(l, x.dtype)
    return op.data.data_ptr(), op.ld, band_row_stride(c, x.dtype)


def _band_fused_fwd(lib, l, x, w, b, out) -> int:
    g, s, c = x.shape
    k, _, f = w.shape
    lp, ld, _ = _band_layout(l, x, k)
    cp, fp = band_row_stride(c, x.dtype), band_row_stride(f, x.dtype)
    xp = _aligned(x, cp)
    wp = band_weights(w, cp, fp, x.dtype, transposed=True)
    ts = _term_scratch(xp, k - 1)
    outp = out if fp == f else torch.empty((g, s, fp), dtype=x.dtype, device=x.device)
    code = lib.hlhgat_band_fused_fwd(
        lp, xp.data_ptr(), wp.data_ptr(), b.data_ptr(), outp.data_ptr(), _ptr(ts),
        g, s, ld, cp, f, fp, k, _bf16(x), _stream(),
    )
    if fp != f and code == 0:
        out.copy_(outp[..., :f])
    return code


def _band_terms_fwd(lib, l, x, k, out) -> int:
    g, s, c = x.shape
    lp, ld, cp = _band_layout(l, x, k)
    xp = _aligned(x, cp)
    tp = out if cp == c else torch.empty((k, g, s, cp), dtype=x.dtype, device=x.device)
    code = lib.hlhgat_band_terms_fwd(lp, xp.data_ptr(), tp.data_ptr(), g, s, ld, cp, k,
                                     _bf16(x), _stream())
    if cp != c and code == 0:
        out.copy_(tp[..., :c])
    return code


def _band_fused_bwd(lib, l, x, w, g, dx, dwdb) -> int:
    n_g, s, c = x.shape
    k, _, f = w.shape
    lp, ld, _ = _band_layout(l, x, k)
    cp, fp = band_row_stride(c, x.dtype), band_row_stride(f, x.dtype)
    xp, gp = _aligned(x, cp), _aligned(g, fp)
    wp = band_weights(w, cp, fp, x.dtype)
    n_w = k * cp * f
    n_split = lib.hlhgat_band_fused_bwd_splits(n_g, s, cp, f, k, _bf16(x))
    partial = torch.empty((n_split, n_w + f), dtype=torch.float32, device=x.device)
    dwdb_p = dwdb if cp == c else torch.zeros(n_w + f, dtype=torch.float32, device=x.device)
    dxp = dx if cp == c else torch.empty((n_g, s, cp), dtype=x.dtype, device=x.device)
    ts, bars = _term_scratch(xp, k - 1), _term_scratch(xp, k if k > 1 else 0)
    code = lib.hlhgat_band_fused_bwd(
        lp, xp.data_ptr(), wp.data_ptr(), gp.data_ptr(), dxp.data_ptr(),
        dwdb_p.data_ptr(), partial.data_ptr(), _ptr(ts), _ptr(bars),
        n_g, s, ld, cp, f, fp, k, n_split, _bf16(x), _stream(),
    )
    if cp != c and code == 0:
        dx.copy_(dxp[..., :c])
        dwdb[:k * c * f].view(k, c, f).copy_(dwdb_p[:n_w].view(k, cp, f)[:, :c])
        dwdb[k * c * f:].copy_(dwdb_p[n_w:])
    return code


def _band_terms_bwd(lib, l, dt, k, dx) -> int:
    _, g, s, c = dt.shape
    lp, ld, cp = _band_layout(l, dt[0], k)
    dtp = _aligned(dt, cp)
    dxp = dx if cp == c else torch.empty((g, s, cp), dtype=dt.dtype, device=dt.device)
    bars = _term_scratch(dxp, k - 1)
    code = lib.hlhgat_band_terms_bwd(lp, dtp.data_ptr(), dxp.data_ptr(), _ptr(bars), g, s, ld,
                                     cp, k, _bf16(dt), _stream())
    if cp != c and code == 0:
        dx.copy_(dxp[..., :c])
    return code


def _route(s: int, resident: str) -> tuple[bool, ctypes.CDLL]:
    """Whether blocks of S rows take the band kernels (more than
    ``RESIDENT_ROWS`` rows), and the library of the kernels they take: the
    band library, or ``resident``, the library of the kernels that hold L in
    shared memory."""
    band = s > RESIDENT_ROWS
    return band, cuda_build.load("laguerre_band" if band else resident)


def _launched(lib, code: int, name: str, band: bool, *outputs: torch.Tensor) -> None:
    """The end of every wrapper's launch: a failed launch raises, the launch
    counts once (and once more in ``band_launches`` where it took the band
    kernels), and the outputs are checked for NaNs where that is on."""
    cuda_build.check(lib, code, name)
    profiling.count(f"launches.{name}")
    if band:
        profiling.count("band_launches")
    check_kernel_outputs(name, *outputs)


def _fused_fwd_cuda(l, x, w, b) -> torch.Tensor:
    _check_inputs(l, x)
    g, s, c = x.shape
    k, c_w, f = w.shape
    if c_w != c or b.shape != (f,) or k < 1:
        raise ValueError(f"need w [K,{c},F] and b [F], got {tuple(w.shape)}, {tuple(b.shape)}")
    out = torch.empty((g, s, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    band, lib = _route(s, "laguerre_dense")
    if not band and lib.hlhgat_laguerre_fused_smem(s, f, _bf16(x)) > _SMEM_LIMIT:
        raise ValueError(f"S={s}, F={f} need more shared memory than a block has")
    w = w.to(device=x.device, dtype=torch.float32).contiguous()
    b = b.to(device=x.device, dtype=torch.float32).contiguous()
    with torch.cuda.device(x.device):
        if band:
            code = _band_fused_fwd(lib, l, x, w, b, out)
        else:
            l, x = l.to(x.dtype).contiguous(), x.contiguous()
            wt = _w_scratch(w, x)
            code = lib.hlhgat_laguerre_fused_fwd(
                l.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
                out.data_ptr(), _ptr(wt), g, s, c, f, k, _bf16(x), _stream(),
            )
    _launched(lib, code, "laguerre_dense_fused", band, out)
    return out


def _terms_fwd_cuda(l, x, k: int) -> torch.Tensor:
    _check_inputs(l, x)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    g, s, c = x.shape
    out = torch.empty((k, g, s, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    band, lib = _route(s, "laguerre_dense")
    with torch.cuda.device(x.device):
        if band:
            code = _band_terms_fwd(lib, l, x, k, out)
        else:
            l, x = l.to(x.dtype).contiguous(), x.contiguous()
            code = lib.hlhgat_laguerre_terms_fwd(l.data_ptr(), x.data_ptr(), out.data_ptr(), g,
                                                 s, c, k, _bf16(x), _stream())
    _launched(lib, code, "laguerre_terms_dense", band, out)
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
    scheduled (and a small one that casts W to bfloat16 where x is).  Over
    ``RESIDENT_ROWS`` rows the band kernels recompute the terms, form
    ``g W_kᵀ`` and walk the adjoint one launch a step.  The wrapper counts
    one launch either way.
    """
    if x.device.type == "cpu":
        return laguerre_dense_fused_bwd_plain(l, x, w, g)
    _check_inputs(l, x)
    n_g, s, c = x.shape
    k, c_w, f = w.shape
    if c_w != c or g.shape != (n_g, s, f) or k < 1:
        raise ValueError(
            f"need w [K,{c},F] and g [{n_g},{s},F], got {tuple(w.shape)}, {tuple(g.shape)}")
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    n_w = k * c * f
    dwdb = torch.zeros(n_w + f, dtype=torch.float32, device=x.device)
    if x.numel() and g.numel():
        band, lib = _route(s, "laguerre_dense_bwd")
        g = g.to(x.dtype).contiguous()
        w = w.to(device=x.device, dtype=torch.float32).contiguous()
        with torch.cuda.device(x.device):
            if band:
                code = _band_fused_bwd(lib, l, x, w, g, dx, dwdb)
            else:
                if lib.hlhgat_laguerre_fused_bwd_smem(s, k, _bf16(x)) > _SMEM_LIMIT:
                    raise ValueError(f"S={s} needs more shared memory than a block has")
                n_split = lib.hlhgat_laguerre_fused_bwd_splits(n_g, c, f)
                partial = torch.empty((n_split, n_w + f), dtype=torch.float32, device=x.device)
                l, x = l.to(x.dtype).contiguous(), x.contiguous()
                wt = _w_scratch(w, x)
                code = lib.hlhgat_laguerre_fused_bwd(
                    l.data_ptr(), x.data_ptr(), w.data_ptr(), g.data_ptr(),
                    dx.data_ptr(), dwdb.data_ptr(), partial.data_ptr(), _ptr(wt),
                    n_g, s, c, f, k, n_split, _bf16(x), _stream(),
                )
        _launched(lib, code, "laguerre_dense_fused_bwd", band, dx, dwdb)
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
    band, lib = _route(s, "laguerre_dense_bwd")
    with torch.cuda.device(dt.device):
        if band:
            code = _band_terms_bwd(lib, l, dt, k, dx)
        else:
            l, dt = l.to(dt.dtype).contiguous(), dt.contiguous()
            code = lib.hlhgat_laguerre_terms_bwd(
                l.data_ptr(), dt.data_ptr(), dx.data_ptr(), n_g, s, c, k,
                _bf16(dt), _stream(),
            )
    _launched(lib, code, "laguerre_terms_dense_bwd", band, dx)
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
