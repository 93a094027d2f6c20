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
// Bound on an H100 (3.35 TB/s; 67 TFLOP/s f32 without TF32, 989 bf16) at
// the widest zinc_pyr layer, G=78 blocks, S=128, C=F=256, K=6:
//   fused: 2·G·S·(S·C·(K-1) + K·C·F) = 11.1 GFLOP -> 0.166 ms f32 and
//          0.011 ms bf16, bound by operations (25 MB of traffic);
//   terms: 2·G·S·S·C·(K-1) = 3.3 GFLOP -> 0.049 ms f32, bound by
//          operations; in bf16 its 38 MB of traffic (it writes K·G·S·C
//          terms) bound it: 0.011 ms.
// This first version computes with plain f32 FMAs: right before fast;
// tensor cores, wgmma and TMA come later.
//
// Design, against what the TPU kernel relied on:
// * The TPU forward carries an f32 accumulator across a sequential grid of
//   C-tiles.  GPU blocks run in no order, so each block loops over ALL
//   C-tiles itself: one block per (graph block, 64-wide F-tile) keeps the
//   [S, 64] accumulator in registers, reruns the channel-independent
//   recurrence per 32-wide C-tile and masks the ragged C and F edges.  Any
//   C works (dense-concat stacks reach 1300+ channels in other presets).
// * L ([S,S], S <= 128) lives in dynamic shared memory as f32 (66 KB at
//   S=128, over the 48 KB static limit, hence cudaFuncSetAttribute); three
//   rotating [S, 32] term buffers and the [K, 32, 64] weight tile sit
//   beside it (166 KB at K=6).
// * Rounding follows the JAX kernel: L and W are cast to x's dtype, each
//   L·T product is accumulated in f32 and rounded to x's dtype, every
//   elementwise step of the combine is rounded to x's dtype, the output
//   GEMMs accumulate in f32 and the sum plus the f32 bias is rounded once.
//   In f32 the rounding is the identity and no TF32 is used anywhere.
// * Padding rows of a packed block (zero L rows) still receive the bias,
//   exactly as in the JAX kernel; the caller's BN masks them.

#include "laguerre_common.cuh"

namespace {

constexpr int kFT = 64;  // output-feature tile of the fused kernel

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_fwd_kernel(const T* __restrict__ l, const T* __restrict__ x,
                     const float* __restrict__ w, const float* __restrict__ b,
                     T* __restrict__ out, int S, int C, int F, int K) {
  extern __shared__ float smem[];
  const int sp = pad4(S);
  float* ls = smem;
  float* tb = ls + sp * (sp + 1);  // 3 rotating [sp][kLdt] term buffers
  float* ws = tb + 3 * sp * kLdt;  // [K][kCT][kFT] weight tile
  const int g = blockIdx.x;
  const int f0 = blockIdx.y * kFT;
  const int r0 = (threadIdx.x / 8) * 4, lane = threadIdx.x % 8;
  const bool owns_rows = r0 < sp;

  load_l(ls, l, g, S);
  float acc[4][8] = {};
  for (int c0 = 0; c0 < C; c0 += kCT) {
    __syncthreads();  // previous tile's last reads are done
    load_x(tb, x, g, S, C, c0);
    for (int idx = threadIdx.x; idx < K * kCT * kFT; idx += kThreads) {
      const int k = idx / (kCT * kFT), rem = idx % (kCT * kFT);
      const int c = rem / kFT, f = rem % kFT;
      ws[idx] = (c0 + c < C && f0 + f < F)
                    ? Io<T>::round(w[((size_t)k * C + c0 + c) * F + f0 + f])
                    : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < K; ++k) {
      const float* cur = tb + (k % 3) * sp * kLdt;
      if (owns_rows) {
        // acc += T_k[rows, tile] @ W_k[tile, lane + 8j]
        const float* wk = ws + k * kCT * kFT;
        for (int c = 0; c < kCT; ++c) {
          float a[4], bw[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = cur[(r0 + i) * kLdt + c];
#pragma unroll
          for (int j = 0; j < 8; ++j) bw[j] = wk[c * kFT + lane + 8 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
        }
      }
      if (k + 1 < K) {
        next_term<T>(ls, sp, cur, tb + ((k + 2) % 3) * sp * kLdt,
                     tb + ((k + 1) % 3) * sp * kLdt, k);
        __syncthreads();
      }
    }
  }
  if (!owns_rows) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = f0 + lane + 8 * j;
      if (f < F)
        Io<T>::store(out, ((size_t)g * S + r) * F + f, acc[i][j] + b[f]);
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

size_t fused_smem_bytes(int S, int K) {
  const int sp = pad4(S);
  return sizeof(float) *
         ((size_t)sp * (sp + 1) + 3 * (size_t)sp * kLdt + (size_t)K * kCT * kFT);
}

size_t terms_smem_bytes(int S) {
  const int sp = pad4(S);
  return sizeof(float) * ((size_t)sp * (sp + 1) + 3 * (size_t)sp * kLdt);
}

template <typename T>
int launch_fused(const void* l, const void* x, const void* w, const void* b,
                 void* out, int G, int S, int C, int F, int K,
                 cudaStream_t stream) {
  const size_t smem = fused_smem_bytes(S, K);
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(G, (F + kFT - 1) / kFT);
  fused_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(l), static_cast<const T*>(x),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<T*>(out), S, C, F, K);
  return (int)cudaGetLastError();
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

// Shared memory the fused kernel needs for block size S and K terms.
size_t hlhgat_laguerre_fused_smem(int S, int K) { return fused_smem_bytes(S, K); }

// l [G,S,S], x [G,S,C], out [G,S,F] in x's dtype (bf16 != 0: bfloat16,
// else float32); w [K,C,F] and b [F] float32.  Returns a cudaError_t.
int hlhgat_laguerre_fused_fwd(const void* l, const void* x, const void* w,
                              const void* b, void* out, int G, int S, int C,
                              int F, int K, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fused<__nv_bfloat16>(l, x, w, b, out, G, S, C, F, K, s)
              : launch_fused<float>(l, x, w, b, out, G, S, C, F, K, s);
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
