// Backward kernels of the dense-block Laguerre filter for Hopper (sm_90a),
// plain C interface.
//
// Replace the two backward Pallas kernels of hl_hgat_tpu/ops/pallas_hodge.py:
//   hlhgat_laguerre_fused_bwd  <- _bwd_kernel (:123-174) via _fused_bwd
//   hlhgat_laguerre_terms_bwd  <- _terms_bwd_kernel (:293-307) via _terms_vjp_bwd
//
// With T_k the forward's terms (recomputed here from x, never stored), g the
// output cotangent and L symmetric (it is data: no dL):
//   dW_k = sum over graph blocks and rows of T_k^T g     [K,C,F]  f32
//   db   = sum over graph blocks and rows of g           [F]      f32
//   bar_k = g W_k^T                                       [S,C] per block
//   adjoint walk, kk = K-1 .. 2 with j = kk-1:
//     bar_{kk-1} += (-L bar_kk + (2j+1) bar_kk) / (j+1)
//     bar_{kk-2} -= j/(j+1) * bar_kk
//   dx = bar_0 + bar_1 - L bar_1                          [G,S,C]
// The terms backward is the same walk over K given cotangents.
//
// Bound on an H100 (3.35 TB/s; 67 TFLOP/s f32 without TF32, 989 bf16) at the
// widest zinc_pyr layer, G=78 blocks, S=128, C=F=256, K=6:
//   fused bwd: 4·G·S·(S·C·(K-1) + K·C·F) = 22.2 GFLOP -> 0.33 ms f32, bound
//              by operations (46 MB of traffic);
//   terms bwd: 2·G·S·S·C·(K-1) = 3.3 GFLOP -> 0.049 ms f32, bound by
//              operations; in bf16 by the bytes of the K cotangents it reads.
// This first version computes with plain f32 FMAs: right before fast.
//
// Design, against what the TPU kernel relied on:
// * The TPU kernel keeps the [K,Ct,F] dW block resident while its sequential
//   grid sweeps the graph blocks.  GPU blocks run in no order, so the fused
//   backward is three kernels behind one entry point:
//   - dx: one block per (graph block, 32-wide C-tile).  It streams g and W
//     in 32-wide F-tiles to build the K bar_k tiles in shared memory
//     (accumulated in f32, rounded once), then runs the adjoint walk with
//     L resident.  All K [S,32] tiles live at once (101 KB at K=6) beside
//     the 66 KB L tile and the streamed g and W tiles: 210 KB at K=6.
//   - dW/db partials: one block per (C-tile, 64-wide F-tile, slice of the
//     graph blocks).  It walks its slice in a fixed order, recomputes the
//     recurrence per graph block with three rotating term buffers, and
//     keeps one register accumulator set per term (hence K <= 8).  Blocks
//     of the first C-tile also sum g over rows for db.  Each writes its
//     partial [K,32,64] tile; no atomics.
//   - reduce: adds the slices' partials in slice order into dW and db.
//   The sum order depends on the shapes only, so the gradient is the same
//   from run to run.
// * Rounding follows the JAX kernel: g and W are taken in x's dtype; bar_k
//   and each L·bar product are accumulated in f32 and rounded to x's dtype;
//   every elementwise step of the walk is rounded to x's dtype (the j/(j+1)
//   coefficient too); T_k^T g and the sums over graph blocks stay in f32.
//   In f32 the rounding is the identity and no TF32 is used anywhere.
// * Ragged C and F are masked at the edges; any C works (tiles are looped
//   or gridded, nothing is padded in memory).

#include "laguerre_common.cuh"

namespace {

constexpr int kFT = 64;        // dW tile width along F
constexpr int kLdg = kFT + 1;  // padded row stride of the g tile (dW kernel)
constexpr int kMaxK = 8;       // register accumulator sets in the dW kernel
constexpr int kTargetBlocks = 264;  // two waves of an H100's 132 SMs

// Adjoint of the recurrence over the K cotangent tiles bb[k] ([sp][kLdt]
// each, values already in T's precision).  Leaves dx in bb[0].  All threads
// call; ends with the block synchronised.
template <typename T>
__device__ void adjoint_walk(const float* ls, int sp, float* bb, int K) {
  const int r0 = (threadIdx.x / 8) * 4, lane = threadIdx.x % 8;
  const bool owns_rows = r0 < sp;
  const int tile = sp * kLdt;
  float lt[4][4];
  for (int kk = K - 1; kk > 1; --kk) {
    if (owns_rows) {
      const float jf = (float)(kk - 1);
      const float coef = Io<T>::round(jf / (jf + 1.f));
      const float* bt = bb + kk * tile;
      float* b1 = bb + (kk - 1) * tile;
      float* b2 = bb + (kk - 2) * tile;
      l_times(ls, sp, bt, lt);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int idx = (r0 + i) * kLdt + lane + 8 * q;
          const float v = bt[idx];
          float s = Io<T>::round(-Io<T>::round(lt[i][q]) +
                                 Io<T>::round((2.f * jf + 1.f) * v));
          s = Io<T>::round(s / (jf + 1.f));
          b1[idx] = Io<T>::round(b1[idx] + s);
          b2[idx] = Io<T>::round(b2[idx] - Io<T>::round(coef * v));
        }
      }
    }
    __syncthreads();  // bar_{kk-1} is whole before the next product reads it
  }
  if (K > 1) {
    if (owns_rows) {
      const float* b1 = bb + tile;
      l_times(ls, sp, b1, lt);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int idx = (r0 + i) * kLdt + lane + 8 * q;
          bb[idx] = Io<T>::round(Io<T>::round(bb[idx] + b1[idx]) -
                                 Io<T>::round(lt[i][q]));
        }
      }
    }
    __syncthreads();
  }
}

// bb[0][:, :] (rows < S, columns c0.. < C) out to dx[g], coalesced along C.
template <typename T>
__device__ void store_dx(const float* bb, T* dx, int g, int S, int C, int c0) {
  T* dg = dx + (size_t)g * S * C;
  for (int idx = threadIdx.x; idx < S * kCT; idx += kThreads) {
    const int r = idx / kCT, c = idx % kCT;
    if (c0 + c < C) Io<T>::store(dg, (size_t)r * C + c0 + c, bb[r * kLdt + c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    terms_bwd_kernel(const T* __restrict__ l, const T* __restrict__ dt,
                     T* __restrict__ dx, int G, int S, int C, int K) {
  extern __shared__ float smem[];
  const int sp = pad4(S);
  float* ls = smem;
  float* bb = ls + sp * (sp + 1);  // K cotangent tiles [sp][kLdt]
  const int g = blockIdx.x;
  const int c0 = blockIdx.y * kCT;
  const size_t term_stride = (size_t)G * S * C;

  load_l(ls, l, g, S);
  for (int k = 0; k < K; ++k)
    load_x(bb + k * sp * kLdt, dt + k * term_stride, g, S, C, c0);
  __syncthreads();
  adjoint_walk<T>(ls, sp, bb, K);
  store_dx(bb, dx, g, S, C, c0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_bwd_dx_kernel(const T* __restrict__ l, const float* __restrict__ w,
                        const T* __restrict__ gout, T* __restrict__ dx, int S,
                        int C, int F, int K) {
  extern __shared__ float smem[];
  const int sp = pad4(S);
  const int tile = sp * kLdt;
  float* ls = smem;
  float* bb = ls + sp * (sp + 1);  // K tiles bar_k [sp][kLdt]
  float* gs = bb + K * tile;       // g[:, f0:f0+32] as [sp][kLdt]
  float* ws = gs + tile;           // W_k[c0:c0+32, f0:f0+32] as [K][kCT][kLdt]
  const int g = blockIdx.x;
  const int c0 = blockIdx.y * kCT;
  const int r0 = (threadIdx.x / 8) * 4, lane = threadIdx.x % 8;
  const bool owns_rows = r0 < sp;

  load_l(ls, l, g, S);
  for (int idx = threadIdx.x; idx < K * tile; idx += kThreads) bb[idx] = 0.f;
  for (int f0 = 0; f0 < F; f0 += kCT) {
    __syncthreads();  // the previous tile's reads are done; bb is zeroed
    load_x(gs, gout, g, S, F, f0);
    for (int idx = threadIdx.x; idx < K * kCT * kCT; idx += kThreads) {
      const int k = idx / (kCT * kCT), rem = idx % (kCT * kCT);
      const int c = rem / kCT, f = rem % kCT;
      ws[(k * kCT + c) * kLdt + f] =
          (c0 + c < C && f0 + f < F)
              ? Io<T>::round(w[((size_t)k * C + c0 + c) * F + f0 + f])
              : 0.f;
    }
    __syncthreads();
    if (!owns_rows) continue;
    for (int k = 0; k < K; ++k) {
      // bar_k[own rows, own columns] += g[rows, tile] @ W_k[columns, tile]^T
      const float* wk = ws + k * kCT * kLdt;
      float acc[4][4] = {};
      for (int f = 0; f < kCT; ++f) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = gs[(r0 + i) * kLdt + f];
#pragma unroll
        for (int q = 0; q < 4; ++q) b[q] = wk[(lane + 8 * q) * kLdt + f];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], b[q], acc[i][q]);
      }
      float* bk = bb + k * tile;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          bk[(r0 + i) * kLdt + lane + 8 * q] += acc[i][q];
    }
  }
  if (owns_rows) {
    for (int k = 0; k < K; ++k) {
      float* bk = bb + k * tile;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int idx = (r0 + i) * kLdt + lane + 8 * q;
          bk[idx] = Io<T>::round(bk[idx]);
        }
    }
  }
  __syncthreads();
  adjoint_walk<T>(ls, sp, bb, K);
  store_dx(bb, dx, g, S, C, c0);
}

// partial[split][K*C*F + F]: this slice's share of dW (then db).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_bwd_dw_kernel(const T* __restrict__ l, const T* __restrict__ x,
                        const T* __restrict__ gout, float* __restrict__ partial,
                        int G, int S, int C, int F, int K) {
  extern __shared__ float smem[];
  const int sp = pad4(S);
  float* ls = smem;
  float* tb = ls + sp * (sp + 1);  // 3 rotating [sp][kLdt] term buffers
  float* gs = tb + 3 * sp * kLdt;  // g[:, f0:f0+64] as [sp][kLdg]
  const int c0 = blockIdx.x * kCT;
  const int f0 = blockIdx.y * kFT;
  const int split = blockIdx.z, n_split = gridDim.z;
  // accumulate layout: warp w owns channels 4w..4w+3, lane owns f = lane + 32j
  const int cw = (threadIdx.x / 32) * 4, lane = threadIdx.x % 32;
  const bool sums_db = blockIdx.x == 0 && threadIdx.x < kFT;

  float acc[kMaxK][4][2] = {};
  float db = 0.f;
  for (int g = split; g < G; g += n_split) {
    __syncthreads();  // the previous graph block's reads are done
    load_l(ls, l, g, S);
    load_x(tb, x, g, S, C, c0);
    const T* gg = gout + (size_t)g * S * F;
    for (int idx = threadIdx.x; idx < sp * kFT; idx += kThreads) {
      const int r = idx / kFT, f = idx % kFT;
      gs[r * kLdg + f] = (r < S && f0 + f < F)
                             ? Io<T>::load(gg, (size_t)r * F + f0 + f)
                             : 0.f;
    }
    __syncthreads();
    if (sums_db)
      for (int r = 0; r < sp; ++r) db += gs[r * kLdg + threadIdx.x];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < K) {
        const float* cur = tb + (k % 3) * sp * kLdt;
        // acc[k] += T_k[:, own channels]^T @ g[:, own features]
        for (int r = 0; r < sp; ++r) {
          float a[4], b[2];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = cur[r * kLdt + cw + i];
#pragma unroll
          for (int j = 0; j < 2; ++j) b[j] = gs[r * kLdg + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              acc[k][i][j] = fmaf(a[i], b[j], acc[k][i][j]);
        }
        if (k + 1 < K) {
          next_term<T>(ls, sp, cur, tb + ((k + 2) % 3) * sp * kLdt,
                       tb + ((k + 1) % 3) * sp * kLdt, k);
          __syncthreads();
        }
      }
    }
  }
  const size_t n_w = (size_t)K * C * F;
  float* mine = partial + (size_t)split * (n_w + F);
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < K) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = c0 + cw + i, f = f0 + lane + 32 * j;
          if (c < C && f < F) mine[((size_t)k * C + c) * F + f] = acc[k][i][j];
        }
      }
    }
  }
  if (sums_db && f0 + (int)threadIdx.x < F) mine[n_w + f0 + threadIdx.x] = db;
}

// out[i] = partial[0][i] + partial[1][i] + ... in slice order.
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, size_t n,
                                       int n_split) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < n_split; ++p) s += partial[(size_t)p * n + i];
  out[i] = s;
}

size_t dx_smem_bytes(int S, int K) {
  const int sp = pad4(S);
  return sizeof(float) * ((size_t)sp * (sp + 1) + (size_t)(K + 1) * sp * kLdt +
                          (size_t)K * kCT * kLdt);
}

size_t dw_smem_bytes(int S) {
  const int sp = pad4(S);
  return sizeof(float) *
         ((size_t)sp * (sp + 1) + 3 * (size_t)sp * kLdt + (size_t)sp * kLdg);
}

size_t terms_bwd_smem_bytes(int S, int K) {
  const int sp = pad4(S);
  return sizeof(float) * ((size_t)sp * (sp + 1) + (size_t)K * sp * kLdt);
}

int dw_splits(int G, int C, int F) {
  const int tiles = ((C + kCT - 1) / kCT) * ((F + kFT - 1) / kFT);
  int n = (kTargetBlocks + tiles - 1) / tiles;
  if (n > G) n = G;
  return n < 1 ? 1 : n;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_fused_bwd(const void* l_, const void* x_, const void* w_,
                     const void* g_, void* dx_, void* dwdb_, void* partial_,
                     int G, int S, int C, int F, int K, int n_split,
                     cudaStream_t stream) {
  const T* l = static_cast<const T*>(l_);
  const T* x = static_cast<const T*>(x_);
  const T* g = static_cast<const T*>(g_);
  const float* w = static_cast<const float*>(w_);
  float* partial = static_cast<float*>(partial_);
  if (K < 1 || K > kMaxK || n_split < 1 || n_split > G)
    return (int)cudaErrorInvalidValue;
  const int n_ct = (C + kCT - 1) / kCT, n_ft = (F + kFT - 1) / kFT;

  size_t smem = dx_smem_bytes(S, K);
  cudaError_t err = allow_smem(fused_bwd_dx_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  fused_bwd_dx_kernel<T><<<dim3(G, n_ct), kThreads, smem, stream>>>(
      l, w, g, static_cast<T*>(dx_), S, C, F, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  smem = dw_smem_bytes(S);
  err = allow_smem(fused_bwd_dw_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  fused_bwd_dw_kernel<T><<<dim3(n_ct, n_ft, n_split), kThreads, smem, stream>>>(
      l, x, g, partial, G, S, C, F, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t n = (size_t)K * C * F + F;
  reduce_partials_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                           0, stream>>>(partial, static_cast<float*>(dwdb_), n,
                                        n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_terms_bwd(const void* l, const void* dt, void* dx, int G, int S,
                     int C, int K, cudaStream_t stream) {
  const size_t smem = terms_bwd_smem_bytes(S, K);
  cudaError_t err = allow_smem(terms_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(G, (C + kCT - 1) / kCT);
  terms_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(l), static_cast<const T*>(dt), static_cast<T*>(dx),
      G, S, C, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Most shared memory a kernel of the fused backward needs (block size S, K
// terms), and what the terms backward needs.
size_t hlhgat_laguerre_fused_bwd_smem(int S, int K) {
  const size_t a = dx_smem_bytes(S, K), b = dw_smem_bytes(S);
  return a > b ? a : b;
}

size_t hlhgat_laguerre_terms_bwd_smem(int S, int K) {
  return terms_bwd_smem_bytes(S, K);
}

// Number of graph-block slices of the dW/db partial sums: the caller
// allocates partial [n_split, K*C*F + F] float32.
int hlhgat_laguerre_fused_bwd_splits(int G, int C, int F) {
  return dw_splits(G, C, F);
}

// l [G,S,S], x [G,S,C], g [G,S,F], dx [G,S,C] in x's dtype (bf16 != 0:
// bfloat16, else float32); w [K,C,F] float32; dwdb [K*C*F + F] float32
// receives dW then db.  Returns a cudaError_t.
int hlhgat_laguerre_fused_bwd(const void* l, const void* x, const void* w,
                              const void* g, void* dx, void* dwdb,
                              void* partial, int G, int S, int C, int F, int K,
                              int n_split, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fused_bwd<__nv_bfloat16>(l, x, w, g, dx, dwdb, partial,
                                                G, S, C, F, K, n_split, s)
              : launch_fused_bwd<float>(l, x, w, g, dx, dwdb, partial, G, S, C,
                                        F, K, n_split, s);
}

// l [G,S,S], dt [K,G,S,C] -> dx [G,S,C], all in dt's dtype.
int hlhgat_laguerre_terms_bwd(const void* l, const void* dt, void* dx, int G,
                              int S, int C, int K, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_terms_bwd<__nv_bfloat16>(l, dt, dx, G, S, C, K, s)
              : launch_terms_bwd<float>(l, dt, dx, G, S, C, K, s);
}

const char* hlhgat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
