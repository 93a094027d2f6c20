// Shared pieces of the dense-block Laguerre kernels (forward and backward):
// the dtype helpers with the JAX kernels' rounding points, the tile loaders
// and the recurrence step.  Included by laguerre_dense.cu and
// laguerre_dense_bwd.cu; every function is inlined into its kernel.
//
// Thread layout shared by the row-owning steps: 256 threads as 32 row groups
// x 8 column lanes; thread (rg, lane) owns rows 4rg..4rg+3 and columns
// lane + 8q, q < 4, of a [S, 32] channel tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;  // 32 row groups x 8 column lanes
constexpr int kCT = 32;        // channel tile
constexpr int kLdt = kCT + 1;  // padded term-buffer row stride (bank spread)

template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static float load(const float* p, size_t i) { return p[i]; }
  __device__ static void store(float* p, size_t i, float v) { p[i] = v; }
  __device__ static float round(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p, size_t i) {
    return __bfloat162float(p[i]);
  }
  __device__ static void store(__nv_bfloat16* p, size_t i, float v) {
    p[i] = __float2bfloat16(v);
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

__host__ __device__ inline int pad4(int s) { return (s + 3) & ~3; }

// L of block g into shared memory, zero beyond S (row stride sp + 1).
template <typename T>
__device__ void load_l(float* ls, const T* l, int g, int S) {
  const int sp = pad4(S), ldl = sp + 1;
  const T* lg = l + (size_t)g * S * S;
  for (int idx = threadIdx.x; idx < sp * sp; idx += kThreads) {
    const int r = idx / sp, c = idx % sp;
    ls[r * ldl + c] =
        (r < S && c < S) ? Io<T>::load(lg, (size_t)r * S + c) : 0.f;
  }
}

// x[g][:, c0:c0+kCT] into a term buffer, zero beyond S and C.
template <typename T>
__device__ void load_x(float* tb, const T* x, int g, int S, int C, int c0) {
  const int sp = pad4(S);
  const T* xg = x + (size_t)g * S * C;
  for (int idx = threadIdx.x; idx < sp * kCT; idx += kThreads) {
    const int r = idx / kCT, c = idx % kCT;
    tb[r * kLdt + c] = (r < S && c0 + c < C)
                           ? Io<T>::load(xg, (size_t)r * C + c0 + c)
                           : 0.f;
  }
}

// lt = L[own rows, :] @ src[:, own columns], accumulated in f32.  The caller
// owns rows (4·(threadIdx.x / 8) < sp).
__device__ inline void l_times(const float* ls, int sp, const float* src,
                               float (&lt)[4][4]) {
  const int r0 = (threadIdx.x / 8) * 4, lane = threadIdx.x % 8;
  const int ldl = sp + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) lt[i][q] = 0.f;
  for (int j = 0; j < sp; ++j) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ls[(r0 + i) * ldl + j];
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = src[j * kLdt + lane + 8 * q];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) lt[i][q] = fmaf(a[i], b[q], lt[i][q]);
  }
}

// next = T_{k+1} from cur = T_k and prev = T_{k-1} (prev unused at k = 0).
// Thread (rg, lane) owns rows 4rg..4rg+3 and columns lane + 8j, j < 4.
template <typename T>
__device__ void next_term(const float* ls, int sp, const float* cur,
                          const float* prev, float* next, int k) {
  const int r0 = (threadIdx.x / 8) * 4, lane = threadIdx.x % 8;
  if (r0 >= sp) return;
  float lt[4][4];
  l_times(ls, sp, cur, lt);
  const float kf = (float)k;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = (r0 + i) * kLdt + lane + 8 * q;
      const float v = Io<T>::round(lt[i][q]);
      float t;
      if (k == 0) {
        t = Io<T>::round(cur[idx] - v);
      } else {
        // (-lt + (2k+1)·T_k - k·T_{k-1}) / (k+1), rounded per operation
        float s = Io<T>::round(-v + Io<T>::round((2.f * kf + 1.f) * cur[idx]));
        s = Io<T>::round(s - Io<T>::round(kf * prev[idx]));
        t = Io<T>::round(s / (kf + 1.f));
      }
      next[idx] = t;
    }
  }
}

}  // namespace
