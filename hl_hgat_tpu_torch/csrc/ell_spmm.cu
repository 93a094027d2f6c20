// ELL sparse-times-dense product for square operators, hand-written for
// sm_90a:
//
//   out[r, f] = sum_{j < W} float(vals[r, j]) * float(x[cols[r, j], f])
//
// accumulated in float32 and rounded once to x's dtype.  It replaces the
// Pallas kernel hl_hgat_tpu/ops/pallas_spmm.py::_spmm_ell_kernel (reached
// through spmm_ell_pallas and, for dx, through the VJP of
// spmm_ell_symmetric, which calls the same kernel on the cotangent).
//
// What bounds it on an H100: bytes.  cols and vals are read once, x once,
// out written once; 2·N·W·F operations is far under the card's rate.  The
// TPU kernel holds all of x in VMEM and broadcasts each column index across
// the feature axis to fit its gather primitive; none of that carries over.
// Here the gathered rows come from device memory through the 50 MB L2 (x of
// the batches this package trains on is a few MB, so only the first touch
// of a row goes to HBM).  The flat batches are narrow (W = 11 to 26 slots a
// row, 29-35 % of them non-zero), so what a launch waits on is the chain of
// gathers each thread issues, and how many threads an SM holds to hide it.
//
// Design:
// * A thread owns one 16-byte chunk of a row: 4 float32 or 8 bfloat16
//   features, so a bfloat16 thread issues 16-byte loads as a float32 one
//   does.  A block of 256 threads covers whole rows of cpr = ceil(F / vec)
//   chunks (a row wider than 256 chunks is cut into slices over blockIdx.y);
//   the threads of a row cover its F features exactly, with no power-of-two
//   rounding (F = 37 float32 takes 10 threads a row).  launch() plans this
//   from F alone.  A thread finds its row and chunk with a multiply by a
//   magic number, not an integer division (bfloat16 lost 4 % a flat step
//   to the division on an H100: PERF.md, kernel 5).
// * Ragged rows keep the layout: when F's row stride or the base of x or out
//   is not 16-byte aligned, a chunk is read and written element by element
//   (the elements of the row's last chunk that lie in the row).  Nothing is
//   padded or copied.
// * Gathers in flight together: the slot loop runs in unrolled chunks of
//   kUnroll = 4, issuing four independent row gathers (each after its
//   column index) before the fixed-order adds, the last chunk predicated.
// * Each thread loads its row's column indices and values itself: the
//   threads of a row read the same words, which the L1 serves once a warp.
//   Staging them once a row in shared memory (per block or per warp), or
//   keeping 8 gathers in flight, or staging the gathers with cp.async, all
//   measured slower on an H100: each costs registers or shared memory, and
//   fewer threads fit an SM (PERF.md, kernel 5).  This kernel takes about 48
//   registers a thread.
// * Each thread keeps vec float32 accumulators and walks the W slots of its
//   row in the fixed order j = 0 .. W-1 with a separate multiply and add (no
//   contraction: the arithmetic of acc = acc + x * v), then writes out once.
//   No atomics and no reduction across threads: a second launch gives the
//   same bits, and the same bits as a one-slot-at-a-time loop.  Padded slots
//   (vals == 0, column in range) are multiplied like any other, as the TPU
//   kernel does, so 0·inf stays NaN.  Row offsets are 64-bit: N·F passes
//   2^31 on the largest complexes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // gathers a thread issues before it adds

__device__ inline float to_float(float v) { return v; }
__device__ inline float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ inline unsigned word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

__device__ inline unsigned bits_of(float v) { return __float_as_uint(v); }
__device__ inline unsigned bits_of(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// The chunk of n <= 16 / sizeof(T) elements at p as 16 bytes, zero past n.
// kAligned: p is 16-byte aligned and n is the whole chunk, one load; else
// one load an element.
template <typename T, bool kAligned>
__device__ inline uint4 load16(const T* p, int n) {
  if constexpr (kAligned) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    constexpr int kPer = 4 / sizeof(T);  // elements a word
    unsigned o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16 / (int)sizeof(T); ++i)
      if (i < n) o[i / kPer] |= bits_of(__ldg(p + i)) << (32 / kPer) * (i % kPer);
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// A chunk's 16 bytes as floats (exact).
template <typename T>
__device__ inline void widen(const uint4& r, float (&v)[16 / sizeof(T)]) {
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) {
    if constexpr (sizeof(T) == 4) {
      v[i] = __uint_as_float(word(r, i));
    } else {  // bfloat16: the upper half of a float
      const unsigned w = word(r, i / 2);
      v[i] = __uint_as_float((i & 1 ? w >> 16 : w & 0xffffu) << 16);
    }
  }
}

__device__ inline void store1(float* p, float v) { *p = v; }
__device__ inline void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// T: dtype of x and out; V: dtype of vals.  A block covers rows_b rows of
// cpb chunks (blockIdx.y: the slice of a wider row); magic = floor(2^32 /
// cpb) + 1 divides a thread index (< 256) by cpb (<= 256) exactly.
// kAligned: F's row stride and the bases of x and out are 16-byte aligned.
template <typename T, typename V, bool kAligned>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const int* __restrict__ cols, const V* __restrict__ vals,
                const T* __restrict__ x, T* __restrict__ out, long long N,
                int W, int F, int cpb, int rows_b, unsigned long long magic) {
  constexpr int VEC = 16 / sizeof(T);
  const int rl = (int)(((unsigned long long)threadIdx.x * magic) >> 32);
  const long long r = (long long)blockIdx.x * rows_b + rl;
  const int f = (blockIdx.y * cpb + (int)(threadIdx.x - rl * cpb)) * VEC;
  if (rl >= rows_b || r >= N || f >= F) return;
  const int need = F - f < VEC ? F - f : VEC;  // features of this chunk in the row
  const int* crow = cols + r * W;
  const V* vrow = vals + r * W;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < W; j0 += kUnroll) {
    uint4 raw[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u < W) {
        v[u] = to_float(vrow[j0 + u]);
        raw[u] = load16<T, kAligned>(x + (long long)crow[j0 + u] * F + f, need);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u < W) {
        float xv[VEC];
        widen<T>(raw[u], xv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(xv[i], v[u]));
      }
    }
  }
  T* o = out + r * F + f;
  if constexpr (kAligned) {
    uint4 q;
    if constexpr (sizeof(T) == 4) {
      q = make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                     __float_as_uint(acc[2]), __float_as_uint(acc[3]));
    } else {
      unsigned w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = __bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i])) |
               (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i + 1])) << 16;
      q = make_uint4(w[0], w[1], w[2], w[3]);
    }
    *reinterpret_cast<uint4*>(o) = q;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (i < need) store1(o + i, acc[i]);
  }
}

template <typename T, typename V>
int launch(const void* cols, const void* vals, const void* x, void* out,
           long long N, int W, long long F, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (F > 2147483647LL) return (int)cudaErrorInvalidValue;
  const long long cpr = (F + VEC - 1) / VEC;
  const int cpb = cpr < kThreads ? (int)cpr : kThreads;
  const int rows_b = kThreads / cpb;
  const bool aligned = (F * sizeof(T)) % 16 == 0 && reinterpret_cast<size_t>(x) % 16 == 0 &&
                       reinterpret_cast<size_t>(out) % 16 == 0;
  const long long gx = (N + rows_b - 1) / rows_b, gy = (cpr + cpb - 1) / cpb;
  if (gx > 2147483647LL || gy > 65535LL) return (int)cudaErrorInvalidConfiguration;
  const unsigned long long magic = (1ULL << 32) / (unsigned)cpb + 1;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  auto k = aligned ? ell_spmm_kernel<T, V, true> : ell_spmm_kernel<T, V, false>;
  k<<<grid, kThreads, 0, stream>>>(static_cast<const int*>(cols), static_cast<const V*>(vals),
                                   static_cast<const T*>(x), static_cast<T*>(out), N, W,
                                   (int)F, cpb, rows_b, magic);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cols [N, W] int32 (every entry in [0, N)), vals [N, W], x [N, F] ->
// out [N, F], all row-major and dense; x_bf16 / vals_bf16 != 0: bfloat16,
// else float32.  Returns a cudaError_t.
int hlhgat_ell_spmm(const void* cols, const void* vals, const void* x,
                    void* out, long long N, int W, long long F, int x_bf16,
                    int vals_bf16, void* stream) {
  if (N <= 0 || F <= 0) return 0;
  if (W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return vals_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(cols, vals, x, out, N, W, F, s)
                     : launch<__nv_bfloat16, float>(cols, vals, x, out, N, W, F, s);
  return vals_bf16 ? launch<float, __nv_bfloat16>(cols, vals, x, out, N, W, F, s)
                   : launch<float, float>(cols, vals, x, out, N, W, F, s);
}

const char* hlhgat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
