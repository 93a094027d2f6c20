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
// of a row goes to HBM).
//
// Design: threads run along the feature axis, so every gathered row of x is
// read as consecutive addresses (VEC = 4 elements a thread when F is a
// multiple of 4, else 1).  A block of 256 threads is `lanes` threads wide
// and 256 / lanes rows high; `lanes` is the power of two that covers F / VEC
// (8 to 256), so narrow feature widths still fill the block with rows.
// Each thread keeps VEC float32 accumulators, walks the W slots of its row
// in the fixed order j = 0 .. W-1 with a separate multiply and add (no
// contraction: the arithmetic of acc = acc + x * v), and writes out once.
// No atomics and no reduction across threads: a second launch gives the
// same bits.  Padded slots (vals == 0, column in range) are multiplied like
// any other, as the TPU kernel does.  Offsets are 64-bit: N·F passes 2^31
// on the largest complexes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

__device__ inline float to_float(float v) { return v; }
__device__ inline float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int VEC>
struct Row;

template <>
struct Row<float, 1> {
  __device__ static void load(const float* p, float (&v)[1]) { v[0] = *p; }
  __device__ static void store(float* p, const float (&v)[1]) { *p = v[0]; }
};

template <>
struct Row<float, 4> {
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Row<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[1]) {
    *p = __float2bfloat16(v[0]);
  }
};

template <>
struct Row<__nv_bfloat16, 4> {
  __device__ static void load(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(a), v[1] = __high2float(a);
    v[2] = __low2float(b), v[3] = __high2float(b);
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned int*>(&a);
    q.y = *reinterpret_cast<const unsigned int*>(&b);
    *reinterpret_cast<uint2*>(p) = q;
  }
};

// T: dtype of x and out; V: dtype of vals; VEC: features a thread owns.
template <typename T, typename V, int VEC>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const int* __restrict__ cols, const V* __restrict__ vals,
                const T* __restrict__ x, T* __restrict__ out, long long N,
                int W, long long F, int lanes) {
  const int tx = threadIdx.x % lanes, ty = threadIdx.x / lanes;
  const long long r = (long long)blockIdx.x * (kThreads / lanes) + ty;
  const long long f = ((long long)blockIdx.y * lanes + tx) * VEC;
  if (r >= N || f >= F) return;
  const int* crow = cols + r * W;
  const V* vrow = vals + r * W;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int j = 0; j < W; ++j) {
    const long long c = crow[j];
    const float v = to_float(vrow[j]);
    float xv[VEC];
    Row<T, VEC>::load(x + c * F + f, xv);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      acc[i] = __fadd_rn(acc[i], __fmul_rn(xv[i], v));
  }
  Row<T, VEC>::store(out + r * F + f, acc);
}

template <typename T, typename V, int VEC>
int launch(const void* cols, const void* vals, const void* x, void* out,
           long long N, int W, long long F, cudaStream_t stream) {
  const long long per_row = F / VEC;  // VEC divides F
  int lanes = 8;
  while (lanes < kThreads && lanes < per_row) lanes *= 2;
  const long long rows_per_block = kThreads / lanes;
  const long long gx = (N + rows_per_block - 1) / rows_per_block;
  const long long gy = (per_row + lanes - 1) / lanes;
  if (gx > 2147483647LL || gy > 65535LL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  ell_spmm_kernel<T, V, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const int*>(cols), static_cast<const V*>(vals),
      static_cast<const T*>(x), static_cast<T*>(out), N, W, F, lanes);
  return (int)cudaGetLastError();
}

template <typename T, typename V>
int launch_vec(const void* cols, const void* vals, const void* x, void* out,
               long long N, int W, long long F, cudaStream_t stream) {
  return F % 4 == 0 ? launch<T, V, 4>(cols, vals, x, out, N, W, F, stream)
                    : launch<T, V, 1>(cols, vals, x, out, N, W, F, stream);
}

}  // namespace

extern "C" {

// cols [N, W] int32 (every entry in [0, N)), vals [N, W], x [N, F] ->
// out [N, F], all row-major and dense; x_bf16 / vals_bf16 != 0: bfloat16,
// else float32.  x and out must be 16-byte aligned when F is a multiple of
// 4.  Returns a cudaError_t.
int hlhgat_ell_spmm(const void* cols, const void* vals, const void* x,
                    void* out, long long N, int W, long long F, int x_bf16,
                    int vals_bf16, void* stream) {
  if (N <= 0 || F <= 0) return 0;
  if (W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return vals_bf16
               ? launch_vec<__nv_bfloat16, __nv_bfloat16>(cols, vals, x, out, N, W, F, s)
               : launch_vec<__nv_bfloat16, float>(cols, vals, x, out, N, W, F, s);
  return vals_bf16 ? launch_vec<float, __nv_bfloat16>(cols, vals, x, out, N, W, F, s)
                   : launch_vec<float, float>(cols, vals, x, out, N, W, F, s);
}

const char* hlhgat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
