// Dense-block Laguerre filter kernels for Hopper (sm_90a), plain C interface.
//
// Replace the two forward Pallas kernels of hl_hgat_tpu/ops/pallas_hodge.py:
//   hlhgat_laguerre_fused_fwd  <- _fwd_kernel (:93-120) via laguerre_dense_fused
//   hlhgat_laguerre_terms_fwd  <- _terms_fwd_kernel (:285-290) via laguerre_terms_dense
//
// Recurrence (per graph block g, channel-independent):
//   T0 = x,  T1 = x - L x,
//   T_{k+1} = (-L T_k + (2k+1) T_k - k T_{k-1}) / (k+1)
//   fused:  out = sum_k T_k @ W_k + b          [G,S,F]
//   terms:  t[k] = T_k                         [K,G,S,C]
//
// Bound on an H100 (3.35 TB/s; bf16 tensor cores 989 TFLOP/s; float32 as
// 3xTF32 495/3 = 165 TFLOP/s) at the widest zinc_pyr layer, G=78 blocks,
// S=128, C=F=256, K=6:
//   fused: 2·G·S·(S·C·(K-1) + K·C·F) = 11.1 GFLOP -> 0.067 ms f32 and
//          0.011 ms bf16, bound by operations (25 MB of traffic);
//   terms: 2·G·S·S·C·(K-1) = 3.3 GFLOP -> 0.020 ms f32, bound by
//          operations; in bf16 its 38 MB of traffic (it writes K·G·S·C
//          terms) bound it: 0.011 ms.
//
// The fused kernel (fused_fwd_mma_kernel), against what the TPU kernel
// relied on and what this card offers:
// * The TPU forward carries an f32 accumulator across a sequential grid of
//   C-tiles.  GPU blocks run in no order, so one block of 16 warps owns a
//   graph block and loops over ALL C-slices itself (64 channels in bf16, 32
//   in f32: 128 bytes a row).  The [S, F] f32 accumulator stays in registers
//   for the whole loop (F <= 256: 64 registers a thread), so the recurrence
//   runs once per (graph block, channel) and nothing is reduced across
//   blocks.  Only F > 256 splits F over blockIdx.y and reruns the recurrence
//   per 256 features.  Any C works (dense-concat stacks reach 1300+).
// * All four products run on tensor cores with f32 accumulation
//   (laguerre_common.cuh, part 2): bf16 mma.sync.m16n8k16 fed by ldmatrix;
//   float32 as 3xTF32 on mma.sync.m16n8k8, which keeps float32 accuracy
//   (the JAX kernel's float32 is a multi-pass bf16 product on the MXU).
// * Operands sit in shared memory in x's type: L [S, S] resident, three
//   [S, Ct] term tiles, two [Ct, F] weight tiles.  At S=128, F=256: 154 KB
//   in bf16, 192 KB in f32, one block an SM.  A step is one term k of one
//   C-slice: acc += T_k W_k, then T_{k+1} from L T_k, written over T_{k-1}
//   at the accumulator's own coordinates (nobody else reads T_{k-1} any
//   more), so two tiles rotate and the third receives the next slice's x.
//   While a step computes, cp.async brings the next step's W_k slice and,
//   at a slice's first step, the next slice's x: one __syncthreads a step.
// * Block sizes S <= 128 of any value are padded with zeros to a multiple
//   of 32 rows in shared memory; any K (shared memory does not depend on
//   it).  G=78 blocks fill 59 % of the 132 SMs.
// * Rounding follows the JAX kernel: L and W are cast to x's dtype, each
//   L·T product is accumulated in f32 and rounded to x's dtype, every
//   elementwise step of the combine is rounded to x's dtype, the output
//   GEMMs accumulate in f32 and the sum plus the f32 bias is rounded once.
//   The tensor cores sum in another order than a sequential loop, so a bf16
//   result may differ from the plain version by an ulp; two launches on the
//   same inputs give the same bits.
// * Padding rows of a packed block (zero L rows) still receive the bias,
//   exactly as in the JAX kernel; the caller's BN masks them.
//
// The terms kernel (terms_fwd_kernel) is the first version on CUDA cores:
// one block of 256 threads per (graph block, 32-wide C-tile), L as f32 in
// shared memory, three rotating term buffers.

#include "laguerre_common.cuh"

namespace {

// NT: n8-tiles a warp owns in the output GEMM; the block covers 32·NT
// features.  Warp (wm, wn) of the 4 x 4 layout owns rows 32 wm .. + 31.
template <typename T, int NT>
__global__ void __launch_bounds__(kMmaThreads, 1)
    fused_fwd_mma_kernel(const T* __restrict__ l, const T* __restrict__ x,
                         const T* __restrict__ w, const float* __restrict__ b,
                         T* __restrict__ out, int S, int C, int F, int K) {
  using M = Mma<T>;
  constexpr int CT = M::kCT, FT = 32 * NT;
  constexpr int NTL = CT / 32;  // n8-tiles a warp owns in L·T
  constexpr int ldt = CT + M::kPadN, ldw = FT + M::kPadNP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = pad32(S), ldl = sp + M::kPadK;
  T* ls = reinterpret_cast<T*>(smem_raw);
  T* tb = ls + sp * ldl;      // 3 tiles [sp][ldt]
  T* ws = tb + 3 * sp * ldt;  // 2 tiles [CT][ldw]
  const int tile = sp * ldt;
  const int g = blockIdx.x, f0 = blockIdx.y * FT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = (warp >> 2) * 32, wn = warp & 3;
  const bool active = m0 < sp;
  const int n_slices = (C + CT - 1) / CT, steps = n_slices * K;
  const T* xg = x + (size_t)g * S * C;

  auto load_w = [&](int cs, int k, T* dst) {
    load_tile_async<T>(dst, ldw, w + ((size_t)k * C + cs * CT) * F + f0, F, CT,
                       FT, C - cs * CT, F - f0);
  };
  auto load_xs = [&](int cs, T* dst) {
    load_tile_async<T>(dst, ldt, xg + cs * CT, C, sp, CT, S, C - cs * CT);
  };

  load_tile_async<T>(ls, ldl, l + (size_t)g * S * S, S, sp, sp, S, S);
  load_xs(0, tb);
  load_w(0, 0, ws);

  float acc[2][NT][4] = {};
  for (int cs = 0; cs < n_slices; ++cs) {
    T* xbuf = tb + (cs & 1) * tile;
    T* tmp = tb + 2 * tile;
    for (int k = 0; k < K; ++k) {
      const int n = cs * K + k;
      cp_async_wait_all();
      __syncthreads();  // this step's W and T_k are whole; the last step's reads are done
      if (n + 1 < steps) {
        const bool wrap = k + 1 == K;
        load_w(wrap ? cs + 1 : cs, wrap ? 0 : k + 1, ws + ((n + 1) & 1) * CT * ldw);
      }
      if (k == 0 && cs + 1 < n_slices) load_xs(cs + 1, tb + ((cs + 1) & 1) * tile);
      if (!active) continue;
      const T* cur = (k & 1) ? tmp : xbuf;
      T* other = (k & 1) ? xbuf : tmp;  // holds T_{k-1}, receives T_{k+1}
      warp_gemm<T, 2, NT, true, false, true>(acc, cur + m0 * ldt, ldt,
                                             ws + (n & 1) * CT * ldw + wn * (FT / 4),
                                             ldw, CT);
      if (k + 1 < K) {
        float lt[2][NTL][4] = {};
        const int c_w = wn * (CT / 4);
        warp_gemm<T, 2, NTL, true, false>(lt, ls + m0 * ldl, ldl, cur + c_w,
                                          ldt, sp);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < NTL; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int at = (m0 + 16 * mi + gid + 8 * h) * ldt + c_w + 8 * ni +
                             2 * tig;
              const float2 tc = ld_pair(cur + at);
              float2 tp = make_float2(0.f, 0.f);
              if (k > 0) tp = ld_pair(other + at);
              const float2 tn = laguerre_step2<T>(
                  make_float2(lt[mi][ni][2 * h], lt[mi][ni][2 * h + 1]), tc, tp, k);
              st_pair(other + at, tn.x, tn.y);
            }
      }
    }
  }
  if (!active) return;
  const bool pair_ok =
      F % 2 == 0 && reinterpret_cast<size_t>(out) % (2 * sizeof(T)) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + 16 * mi + gid + 8 * h;
      if (r >= S) continue;
      T* orow = out + ((size_t)g * S + r) * F;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int f = f0 + wn * (FT / 4) + 8 * ni + 2 * tig;
        if (f + 1 < F && pair_ok) {
          st_pair(orow + f, acc[mi][ni][2 * h] + b[f],
                  acc[mi][ni][2 * h + 1] + b[f + 1]);
        } else {
          if (f < F) Io<T>::store(orow, f, acc[mi][ni][2 * h] + b[f]);
          if (f + 1 < F) Io<T>::store(orow, f + 1, acc[mi][ni][2 * h + 1] + b[f + 1]);
        }
      }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    terms_fwd_kernel(const T* __restrict__ l, const T* __restrict__ x,
                     T* __restrict__ t, int G, int S, int C, int K) {
  extern __shared__ float smem[];
  const int sp = pad4(S);
  float* ls = smem;
  float* tb = ls + sp * (sp + 1);
  const int g = blockIdx.x;
  const int c0 = blockIdx.y * kCT;
  const size_t term_stride = (size_t)G * S * C;

  load_l(ls, l, g, S);
  load_x(tb, x, g, S, C, c0);
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    const float* cur = tb + (k % 3) * sp * kLdt;
    // T_k (already rounded to T) out, coalesced along C
    T* tk = t + k * term_stride + (size_t)g * S * C;
    for (int idx = threadIdx.x; idx < S * kCT; idx += kThreads) {
      const int r = idx / kCT, c = idx % kCT;
      if (c0 + c < C) Io<T>::store(tk, (size_t)r * C + c0 + c, cur[r * kLdt + c]);
    }
    if (k + 1 < K) {
      next_term<T>(ls, sp, cur, tb + ((k + 2) % 3) * sp * kLdt,
                   tb + ((k + 1) % 3) * sp * kLdt, k);
      __syncthreads();
    }
  }
}

// Features one block of the fused kernel covers: 64, 128 or 256.
int fused_ft(int F) { return F <= 64 ? 64 : F <= 128 ? 128 : 256; }

template <typename T>
size_t fused_smem_bytes(int S, int F) {
  using M = Mma<T>;
  const int sp = pad32(S);
  return sizeof(T) * ((size_t)sp * (sp + M::kPadK) +
                      3 * (size_t)sp * (M::kCT + M::kPadN) +
                      2 * (size_t)M::kCT * (fused_ft(F) + M::kPadNP));
}

size_t terms_smem_bytes(int S) {
  const int sp = pad4(S);
  return sizeof(float) * ((size_t)sp * (sp + 1) + 3 * (size_t)sp * kLdt);
}

template <typename T, int NT>
int launch_fused_nt(const T* l, const T* x, const T* w, const float* b, T* out,
                    int G, int S, int C, int F, int K, cudaStream_t stream) {
  const size_t smem = fused_smem_bytes<T>(S, F);
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_mma_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(G, (F + 32 * NT - 1) / (32 * NT));
  fused_fwd_mma_kernel<T, NT><<<grid, kMmaThreads, smem, stream>>>(
      l, x, w, b, out, S, C, F, K);
  return (int)cudaGetLastError();
}

// wt: scratch of K·C·F elements of T that receives W in x's type (unused,
// may be null, when T is float: w is taken as it is).
template <typename T>
int launch_fused(const void* l_, const void* x_, const void* w_, const void* b_,
                 void* out_, void* wt_, int G, int S, int C, int F, int K,
                 cudaStream_t stream) {
  const T* l = static_cast<const T*>(l_);
  const T* x = static_cast<const T*>(x_);
  const float* b = static_cast<const float*>(b_);
  T* out = static_cast<T*>(out_);
  const T* w = static_cast<const T*>(w_);
  if (sizeof(T) != sizeof(float)) {
    const size_t n = (size_t)K * C * F;
    cast_w_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(w_), static_cast<T*>(wt_), n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    w = static_cast<const T*>(wt_);
  }
  switch (fused_ft(F)) {
    case 64: return launch_fused_nt<T, 2>(l, x, w, b, out, G, S, C, F, K, stream);
    case 128: return launch_fused_nt<T, 4>(l, x, w, b, out, G, S, C, F, K, stream);
    default: return launch_fused_nt<T, 8>(l, x, w, b, out, G, S, C, F, K, stream);
  }
}

template <typename T>
int launch_terms(const void* l, const void* x, void* t, int G, int S, int C,
                 int K, cudaStream_t stream) {
  const size_t smem = terms_smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      terms_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(G, (C + kCT - 1) / kCT);
  terms_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(l), static_cast<const T*>(x), static_cast<T*>(t),
      G, S, C, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the fused kernel needs for block size S and F features
// (bf16 != 0: bfloat16, else float32).
size_t hlhgat_laguerre_fused_smem(int S, int F, int bf16) {
  return bf16 ? fused_smem_bytes<__nv_bfloat16>(S, F) : fused_smem_bytes<float>(S, F);
}

// l [G,S,S], x [G,S,C], out [G,S,F] in x's dtype (bf16 != 0: bfloat16,
// else float32); w [K,C,F] and b [F] float32; wt: scratch of K·C·F bfloat16
// when bf16 != 0 (W in x's type), else unused.  Returns a cudaError_t.
int hlhgat_laguerre_fused_fwd(const void* l, const void* x, const void* w,
                              const void* b, void* out, void* wt, int G, int S,
                              int C, int F, int K, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fused<__nv_bfloat16>(l, x, w, b, out, wt, G, S, C, F, K, s)
              : launch_fused<float>(l, x, w, b, out, wt, G, S, C, F, K, s);
}

// l [G,S,S], x [G,S,C] -> t [K,G,S,C], all in x's dtype.
int hlhgat_laguerre_terms_fwd(const void* l, const void* x, void* t, int G,
                              int S, int C, int K, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_terms<__nv_bfloat16>(l, x, t, G, S, C, K, s)
              : launch_terms<float>(l, x, t, G, S, C, K, s);
}

const char* hlhgat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
