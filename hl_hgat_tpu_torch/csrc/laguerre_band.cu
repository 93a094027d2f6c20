// Dense-block Laguerre kernels for blocks over 128 rows (Hopper, sm_90a),
// plain C interface.
//
// The kernels of laguerre_dense.cu and laguerre_dense_bwd.cu hold one graph
// block's L [S, S] in shared memory and cover its rows with 16 warps, so
// they take S <= 128.  A block of S > 128 rows does not fit: at S = 256, L
// alone is 256 KB in float32 (a block may have 227 KB), the fused forward's
// [S, F] float32 accumulator would fill the register file and the dx
// kernel's g tile the shared memory.  These kernels take any S for the same
// four entry points, with the same rounding points:
//   hlhgat_band_fused_fwd   <- pallas_hodge.py _fwd_kernel (:93-120)
//   hlhgat_band_terms_fwd   <- _terms_fwd_kernel (:285-290)
//   hlhgat_band_fused_bwd   <- _bwd_kernel (:123-174)
//   hlhgat_band_terms_bwd   <- _terms_bwd_kernel (:293-307)
//
// Design: L streamed in row bands, one launch a recurrence step.  Every
// product is a tiled matrix product on the tensor cores (block_gemm: a
// 128 x 64 output tile a block of 8 warps, 32 x 32 a warp, A and B streamed
// through shared memory in depth chunks of 32 by a two-stage cp.async ring,
// the fragments and the 3xTF32 / bf16 mma.sync of laguerre_common.cuh).
// Each step needs the whole of T_k (every row band of L·T_k reads all of
// it), so T_k lives in device memory and the kernel boundary is the step's
// barrier:
// * band_step_kernel: one row band (128 rows) x 64 channels of one graph
//   block: L[band, :] · V with V = T_k (forward) or b̄_kk (adjoint walk),
//   then the step's elementwise combine at the accumulator's coordinates
//   (laguerre_step_pair for T_{k+1}; the walk's two updates of b̄_{kk-1}
//   and b̄_{kk-2}, in place; dx = b̄_0 + b̄_1 − L b̄_1 at the end).
// * band_out_kernel (fused forward): out = Σ_k T_k W_k + b, one product of
//   depth K·C over the terms, summed in f32 and rounded once with the bias.
// * band_bar_kernel (fused backward): b̄_k = g W_kᵀ for every k, rounded to
//   x's type; the adjoint walk then runs as in the terms backward.
// * band_dw_kernel / band_db_kernel (fused backward): per-slice partial sums
//   of dW_k = T_kᵀ g and db = Σ g over contiguous runs of graph blocks, in
//   f32; reduce_partials_kernel adds the slices in slice order.  No atomics:
//   a second launch gives the same bits.
// The terms of a fused call go to a scratch buffer [K−1, G, S, C] in x's
// type that the caller allocates (b̄ likewise, [K, G, S, C]).  L's rows lie
// ldl >= S elements apart (graph blocks S·ldl apart): L tiles load in
// 16-byte cp.async chunks only where rows start on 16-byte boundaries and
// element by element elsewhere, so the caller pads an odd row (S = 8997, the
// brain's level-0 L1) to a multiple of 16 bytes.
//
// Bound on an H100 (3.35 TB/s; bf16 tensor cores 989 TFLOP/s; float32 as
// 3xTF32, 165 TFLOP/s): the operations are those of the S <= 128 kernels,
// 2·G·S·(S·C·(K−1) + K·C·F) forward and twice that backward, bound by
// operations at S = 256 and C = F = 256 (a graph block's L·T is S·S·C MACs,
// its T W is S·C·F).  What this design adds is traffic: each step writes
// T_{k+1} and every row band and 64-channel slice reads L's band and all of
// T_k again, from L2 where they fit (50 MB).  A thread-block cluster that
// shares the bands through distributed shared memory would keep the terms
// on the chip (a later optimisation).
//
// Rounding follows the S <= 128 kernels: L and W in x's type; each L·V and
// each g W_kᵀ accumulated in f32 and rounded to x's type; the combine in
// x's arithmetic (Pair<T>); the output sums in f32 plus the f32 bias
// rounded once; dW and db in f32.  Products sum their depth chunks in
// order, each k-step of the float32 product in a fresh accumulator.

#include "laguerre_common.cuh"

namespace {

constexpr int kBM = 128, kBN = 64, kBD = 32;  // block tile: rows, columns, depth chunk
constexpr int kBandThreads = 256;  // 8 warps: 4 along the rows x 2 along the columns
constexpr int kBandTargetBlocks = 132;  // dW slices: about one block an SM

// The two stages of A and B tiles in shared memory.  kAK: A is stored along
// the depth ([M][D]), else [D][M]; kBK: B is stored [N][D], else [D][N].
// Paddings as laguerre_common.cuh gives them for a tile read along its rows
// (kPadK) or down its columns (kPadN).
template <typename T, bool kAK, bool kBK>
struct BandTiles {
  using M = Mma<T>;
  static constexpr int ldA = kAK ? kBD + M::kPadK : kBM + M::kPadN;
  static constexpr int szA = kAK ? kBM * ldA : kBD * ldA;
  static constexpr int ldB = kBK ? kBD + M::kPadK : kBN + M::kPadN;
  static constexpr int szB = kBK ? kBN * ldB : kBD * ldB;
  static constexpr size_t kBytes = 2 * (size_t)(szA + szB) * sizeof(T);
};

// acc += A B over `depth` for the block's kBM x kBN tile.  a points at A's
// element (the tile's first row, depth 0), b at B's (depth 0, the tile's
// first column); lda and ldb are the row strides of the arrays as stored;
// m_valid and n_valid the rows and columns of the tile inside them.  Warp w
// owns rows 32 (w / 2) .. and columns 32 (w % 2) .. of the tile.  Ends with a
// barrier, so the caller may start another product on the same memory.
template <typename T, bool kAK, bool kBK>
__device__ inline void block_gemm(float (&acc)[2][4][4], const T* a, size_t lda,
                                  int m_valid, const T* b, size_t ldb, int n_valid,
                                  int depth, T* smem) {
  using Tl = BandTiles<T, kAK, kBK>;
  T* as = smem;
  T* bs = smem + 2 * Tl::szA;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  auto load = [&](int i, int buf) {
    const int d0 = i * kBD, dv = depth - d0;
    if (kAK)
      load_tile_async<T>(as + buf * Tl::szA, Tl::ldA, a + d0, lda, kBM, kBD, m_valid, dv);
    else
      load_tile_async<T>(as + buf * Tl::szA, Tl::ldA, a + (size_t)d0 * lda, lda, kBD, kBM,
                         dv, m_valid);
    if (kBK)
      load_tile_async<T>(bs + buf * Tl::szB, Tl::ldB, b + d0, ldb, kBN, kBD, n_valid, dv);
    else
      load_tile_async<T>(bs + buf * Tl::szB, Tl::ldB, b + (size_t)d0 * ldb, ldb, kBD, kBN,
                         dv, n_valid);
  };
  const int chunks = (depth + kBD - 1) / kBD;
  if (chunks > 0) load(0, 0);
  for (int i = 0; i < chunks; ++i) {
    cp_async_wait_all();
    __syncthreads();  // chunk i is whole; the reads of chunk i - 1 are done
    if (i + 1 < chunks) load(i + 1, (i + 1) & 1);
    const T* at = as + (i & 1) * Tl::szA + (kAK ? wm * 32 * Tl::ldA : wm * 32);
    const T* bt = bs + (i & 1) * Tl::szB + (kBK ? wn * 32 * Tl::ldB : wn * 32);
    warp_gemm<T, 2, 4, kAK, kBK>(acc, at, Tl::ldA, bt, Tl::ldB, kBD);
  }
  __syncthreads();
}

// Calls f(row, col, v0, v1) for each column pair (col, col + 1) of the
// warp's accumulators, rows and columns relative to the block tile.
template <typename F>
__device__ inline void for_each_pair(const float (&acc)[2][4][4], F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = (warp >> 1) * 32, c0 = (warp & 1) * 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(r0 + 16 * mi + gid + 8 * h, c0 + 8 * ni + 2 * tig, acc[mi][ni][2 * h],
          acc[mi][ni][2 * h + 1]);
}

// The element pair (i, i + 1) of a row, the second 0 past the row's end,
// as Pair<T> (exact: the values are T's already), and back.
template <typename T>
__device__ inline typename Pair<T>::V ld_pair(const T* p, size_t i, bool two) {
  return Pair<T>::of(Io<T>::load(p, i), two ? Io<T>::load(p, i + 1) : 0.f);
}
__device__ inline float2 floats_of(float2 v) { return v; }
__device__ inline float2 floats_of(__nv_bfloat162 v) { return __bfloat1622float2(v); }
template <typename T>
__device__ inline void st_pair(T* p, size_t i, bool two, typename Pair<T>::V v) {
  const float2 f = floats_of(v);
  Io<T>::store(p, i, f.x);
  if (two) Io<T>::store(p, i + 1, f.y);
}

enum StepMode { kForward = 0, kWalk = 1, kLast = 2 };

// One row band x 64 channels of graph block blockIdx.z: lt = L[band, :] · V
// (V [G,S,C]), then
//   kForward (step k):  out = T_{k+1} from lt, T_k = V and T_{k-1} = x1;
//   kWalk (step kk):    x1 = b̄_{kk-1} += (−lt + (2j+1) b̄_kk)/(j+1) and
//                       x2 = b̄_{kk-2} −= j/(j+1) b̄_kk, j = kk − 1, V = b̄_kk;
//   kLast:              out = dx = x1 (b̄_0) + V (b̄_1) − lt.
template <typename T, int kMode>
__global__ void __launch_bounds__(kBandThreads)
    band_step_kernel(const T* __restrict__ l, const T* __restrict__ v, T* x1, T* x2,
                     T* out, int S, int ldl, int C, int k) {
  using P = Pair<T>;
  using V = typename P::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const size_t blk = (size_t)blockIdx.z * S * C;
  float acc[2][4][4] = {};
  block_gemm<T, true, false>(acc, l + (size_t)blockIdx.z * S * ldl + (size_t)m0 * ldl, ldl,
                             S - m0, v + blk + n0, C, C - n0, S,
                             reinterpret_cast<T*>(smem_raw));
  const float jf = (float)(k - 1), a = 2.f * jf + 1.f, d = jf + 1.f;
  const float coef = Io<T>::round(jf / d);
  for_each_pair(acc, [&](int r, int c, float lt0, float lt1) {
    const int row = m0 + r, col = n0 + c;
    if (row >= S || col >= C) return;
    const bool two = col + 1 < C;
    const size_t i = blk + (size_t)row * C + col;
    const V cur = ld_pair<T>(v, i, two);
    if (kMode == kForward) {
      const V prev = k > 0 ? ld_pair<T>(x1, i, two) : P::of(0.f, 0.f);
      st_pair<T>(out, i, two, laguerre_step_pair<T>(lt0, lt1, cur, prev, k));
    } else if (kMode == kWalk) {
      const V lv = P::of(lt0, lt1);
      st_pair<T>(x1, i, two, P::add(ld_pair<T>(x1, i, two), P::div(P::sub(P::mul(a, cur), lv), d)));
      st_pair<T>(x2, i, two, P::sub(ld_pair<T>(x2, i, two), P::mul(coef, cur)));
    } else {
      st_pair<T>(out, i, two, P::sub(P::add(ld_pair<T>(x1, i, two), cur), P::of(lt0, lt1)));
    }
  });
}

// T_k of a fused call: x for k = 0, else the scratch ts [K-1, G, S, C].
template <typename T>
__device__ __host__ inline const T* term_of(const T* x, const T* ts, size_t gsc, int k) {
  return k == 0 ? x : ts + (size_t)(k - 1) * gsc;
}

// out [R, F] = Σ_k T_k [R, C] · W_k [C, F] + b over the R = G·S rows.
template <typename T>
__global__ void __launch_bounds__(kBandThreads)
    band_out_kernel(const T* __restrict__ x, const T* __restrict__ ts,
                    const T* __restrict__ w, const float* __restrict__ b,
                    T* __restrict__ out, int R, int C, int F, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const size_t gsc = (size_t)R * C;
  float acc[2][4][4] = {};
  for (int k = 0; k < K; ++k)
    block_gemm<T, true, false>(acc, term_of(x, ts, gsc, k) + (size_t)m0 * C, C, R - m0,
                               w + (size_t)k * C * F + n0, F, F - n0, C,
                               reinterpret_cast<T*>(smem_raw));
  for_each_pair(acc, [&](int r, int c, float v0, float v1) {
    const int row = m0 + r, col = n0 + c;
    if (row >= R || col >= F) return;
    T* orow = out + (size_t)row * F;
    Io<T>::store(orow, col, v0 + b[col]);
    if (col + 1 < F) Io<T>::store(orow, col + 1, v1 + b[col + 1]);
  });
}

// bars[k] [R, C] = g [R, F] · W_kᵀ, rounded to T; k = blockIdx.z.
template <typename T>
__global__ void __launch_bounds__(kBandThreads)
    band_bar_kernel(const T* __restrict__ g, const T* __restrict__ w,
                    T* __restrict__ bars, int R, int C, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN, k = blockIdx.z;
  float acc[2][4][4] = {};
  block_gemm<T, true, true>(acc, g + (size_t)m0 * F, F, R - m0,
                            w + (size_t)k * C * F + (size_t)n0 * F, F, C - n0, F,
                            reinterpret_cast<T*>(smem_raw));
  T* dst = bars + (size_t)k * R * C;
  for_each_pair(acc, [&](int r, int c, float v0, float v1) {
    const int row = m0 + r, col = n0 + c;
    if (row >= R || col >= C) return;
    Io<T>::store(dst, (size_t)row * C + col, v0);
    if (col + 1 < C) Io<T>::store(dst, (size_t)row * C + col + 1, v1);
  });
}

// The rows of slice `split` of n_split: whole graph blocks, contiguous.
__device__ inline void slice_rows(int G, int S, int split, int n_split, int& r0, int& r1) {
  r0 = (int)((long long)G * split / n_split) * S;
  r1 = (int)((long long)G * (split + 1) / n_split) * S;
}

// partial[split][k·C·F + c·F + f] = Σ over the slice's rows of T_k[r, c] g[r, f];
// blockIdx.z = split · K + k.
template <typename T>
__global__ void __launch_bounds__(kBandThreads)
    band_dw_kernel(const T* __restrict__ x, const T* __restrict__ ts,
                   const T* __restrict__ g, float* __restrict__ partial, int G, int S,
                   int C, int F, int K, int n_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int k = blockIdx.z % K, split = blockIdx.z / K;
  int r0, r1;
  slice_rows(G, S, split, n_split, r0, r1);
  const size_t gsc = (size_t)G * S * C;
  float acc[2][4][4] = {};
  block_gemm<T, false, false>(acc, term_of(x, ts, gsc, k) + (size_t)r0 * C + m0, C,
                              C - m0, g + (size_t)r0 * F + n0, F, F - n0, r1 - r0,
                              reinterpret_cast<T*>(smem_raw));
  float* dst = partial + (size_t)split * ((size_t)K * C * F + F) + (size_t)k * C * F;
  for_each_pair(acc, [&](int r, int c, float v0, float v1) {
    const int ch = m0 + r, f = n0 + c;
    if (ch >= C || f >= F) return;
    dst[(size_t)ch * F + f] = v0;
    if (f + 1 < F) dst[(size_t)ch * F + f + 1] = v1;
  });
}

// partial[split][K·C·F + f] = Σ over the slice's rows of g[r, f], in row order.
template <typename T>
__global__ void band_db_kernel(const T* __restrict__ g, float* __restrict__ partial,
                               int G, int S, int F, size_t n_w, int n_split) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x, split = blockIdx.y;
  if (f >= F) return;
  int r0, r1;
  slice_rows(G, S, split, n_split, r0, r1);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += Io<T>::load(g, (size_t)r * F + f);
  partial[(size_t)split * (n_w + F) + n_w + f] = s;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

#define BAND_TRY(expr)                          \
  do {                                          \
    const cudaError_t e_ = (expr);              \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

template <typename T, int kMode>
cudaError_t launch_step(const T* l, const T* v, T* x1, T* x2, T* out, int G, int S, int ldl,
                        int C, int k, cudaStream_t stream) {
  constexpr size_t smem = BandTiles<T, true, false>::kBytes;
  const cudaError_t err = allow_smem(band_step_kernel<T, kMode>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBM - 1) / kBM, (C + kBN - 1) / kBN, G);
  band_step_kernel<T, kMode><<<grid, kBandThreads, smem, stream>>>(l, v, x1, x2, out, S, ldl, C,
                                                                    k);
  return cudaGetLastError();
}

// T_1 .. T_{K-1} from T_0 = x: term k + 1 into term_out(k + 1).
template <typename T, typename TermFn>
cudaError_t run_recurrence(const T* l, TermFn term, int G, int S, int ldl, int C, int K,
                           cudaStream_t stream) {
  for (int k = 0; k + 1 < K; ++k) {
    const cudaError_t err = launch_step<T, kForward>(
        l, term(k), const_cast<T*>(k > 0 ? term(k - 1) : nullptr), nullptr,
        const_cast<T*>(term(k + 1)), G, S, ldl, C, k, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The adjoint walk over bar(0) .. bar(K-1), in place, then dx.
template <typename T, typename BarFn>
cudaError_t run_walk(const T* l, BarFn bar, T* dx, int G, int S, int ldl, int C, int K,
                     cudaStream_t stream) {
  for (int kk = K - 1; kk > 1; --kk) {
    const cudaError_t err = launch_step<T, kWalk>(l, bar(kk), bar(kk - 1), bar(kk - 2),
                                                  nullptr, G, S, ldl, C, kk, stream);
    if (err != cudaSuccess) return err;
  }
  if (K > 1)
    return launch_step<T, kLast>(l, bar(1), bar(0), nullptr, dx, G, S, ldl, C, 1, stream);
  return cudaMemcpyAsync(dx, bar(0), (size_t)G * S * C * sizeof(T), cudaMemcpyDeviceToDevice,
                         stream);
}

template <typename T>
const T* weights_in(const void* w_, void* wt_, size_t n, cudaStream_t stream, cudaError_t& err) {
  err = cudaSuccess;
  if (sizeof(T) == sizeof(float)) return static_cast<const T*>(w_);
  cast_w_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(w_), static_cast<T*>(wt_), n);
  err = cudaGetLastError();
  return static_cast<const T*>(wt_);
}

template <typename T>
int band_fused_fwd(const void* l_, const void* x_, const void* w_, const void* b_,
                   void* out_, void* wt_, void* ts_, int G, int S, int ldl, int C, int F,
                   int K, cudaStream_t stream) {
  const T* l = static_cast<const T*>(l_);
  const T* x = static_cast<const T*>(x_);
  T* ts = static_cast<T*>(ts_);
  const size_t gsc = (size_t)G * S * C;
  cudaError_t err;
  const T* w = weights_in<T>(w_, wt_, (size_t)K * C * F, stream, err);
  BAND_TRY(err);
  BAND_TRY(run_recurrence<T>(l, [&](int k) { return term_of<T>(x, ts, gsc, k); }, G, S, ldl, C, K,
                             stream));
  constexpr size_t smem = BandTiles<T, true, false>::kBytes;
  BAND_TRY(allow_smem(band_out_kernel<T>, smem));
  const int R = G * S;
  band_out_kernel<T><<<dim3((R + kBM - 1) / kBM, (F + kBN - 1) / kBN), kBandThreads, smem,
                       stream>>>(x, ts, w, static_cast<const float*>(b_),
                                 static_cast<T*>(out_), R, C, F, K);
  return (int)cudaGetLastError();
}

template <typename T>
int band_terms_fwd(const void* l_, const void* x_, void* t_, int G, int S, int ldl, int C,
                   int K, cudaStream_t stream) {
  const T* l = static_cast<const T*>(l_);
  T* t = static_cast<T*>(t_);
  const size_t gsc = (size_t)G * S * C;
  BAND_TRY(cudaMemcpyAsync(t, x_, gsc * sizeof(T), cudaMemcpyDeviceToDevice, stream));
  return (int)run_recurrence<T>(l, [&](int k) { return t + (size_t)k * gsc; }, G, S, ldl, C, K,
                                stream);
}

int band_splits(int G, int C, int F, int K) {
  const int tiles = K * ((C + kBM - 1) / kBM) * ((F + kBN - 1) / kBN);
  int n = kBandTargetBlocks / tiles;  // rounded down: one wave
  if (n > G) n = G;
  return n < 1 ? 1 : n;
}

template <typename T>
int band_fused_bwd(const void* l_, const void* x_, const void* w_, const void* g_, void* dx_,
                   void* dwdb_, void* partial_, void* wt_, void* ts_, void* bars_, int G, int S,
                   int ldl, int C, int F, int K, int n_split, cudaStream_t stream) {
  const T* l = static_cast<const T*>(l_);
  const T* x = static_cast<const T*>(x_);
  const T* g = static_cast<const T*>(g_);
  T* ts = static_cast<T*>(ts_);
  T* dx = static_cast<T*>(dx_);
  float* partial = static_cast<float*>(partial_);
  if (K < 1 || n_split < 1 || n_split > G) return (int)cudaErrorInvalidValue;
  const size_t gsc = (size_t)G * S * C, n_w = (size_t)K * C * F;
  const int R = G * S;
  cudaError_t err;
  const T* w = weights_in<T>(w_, wt_, n_w, stream, err);
  BAND_TRY(err);
  // the terms, recomputed from x
  BAND_TRY(run_recurrence<T>(l, [&](int k) { return term_of<T>(x, ts, gsc, k); }, G, S, ldl, C, K,
                             stream));
  // b̄_k = g W_kᵀ (with one term, b̄_0 is dx)
  T* bars = K > 1 ? static_cast<T*>(bars_) : dx;
  constexpr size_t smem_bar = BandTiles<T, true, true>::kBytes;
  BAND_TRY(allow_smem(band_bar_kernel<T>, smem_bar));
  band_bar_kernel<T><<<dim3((R + kBM - 1) / kBM, (C + kBN - 1) / kBN, K), kBandThreads,
                       smem_bar, stream>>>(g, w, bars, R, C, F);
  BAND_TRY(cudaGetLastError());
  if (K > 1)
    BAND_TRY(run_walk<T>(l, [&](int k) { return bars + (size_t)k * gsc; }, dx, G, S, ldl, C, K,
                         stream));
  // dW and db: per-slice partials, then the fixed-order sum
  constexpr size_t smem_dw = BandTiles<T, false, false>::kBytes;
  BAND_TRY(allow_smem(band_dw_kernel<T>, smem_dw));
  band_dw_kernel<T><<<dim3((C + kBM - 1) / kBM, (F + kBN - 1) / kBN, K * n_split),
                      kBandThreads, smem_dw, stream>>>(x, ts, g, partial, G, S, C, F, K,
                                                       n_split);
  BAND_TRY(cudaGetLastError());
  band_db_kernel<T><<<dim3((F + kThreads - 1) / kThreads, n_split), kThreads, 0, stream>>>(
      g, partial, G, S, F, n_w, n_split);
  BAND_TRY(cudaGetLastError());
  const size_t n = n_w + F;
  reduce_partials_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      partial, static_cast<float*>(dwdb_), n, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int band_terms_bwd(const void* l_, const void* dt_, void* dx_, void* bars_, int G, int S,
                   int ldl, int C, int K, cudaStream_t stream) {
  const T* l = static_cast<const T*>(l_);
  const T* dt = static_cast<const T*>(dt_);
  T* bars = static_cast<T*>(bars_);
  const size_t gsc = (size_t)G * S * C;
  if (K < 1) return (int)cudaErrorInvalidValue;
  // the walk folds b̄_kk into b̄_{kk-1} and b̄_{kk-2}: the cotangents below the
  // top one are copied, the top one is only read
  if (K > 1)
    BAND_TRY(cudaMemcpyAsync(bars, dt, (K - 1) * gsc * sizeof(T), cudaMemcpyDeviceToDevice,
                             stream));
  auto bar = [&](int k) {
    return k == K - 1 ? const_cast<T*>(dt) + (size_t)k * gsc : bars + (size_t)k * gsc;
  };
  return (int)run_walk<T>(l, bar, static_cast<T*>(dx_), G, S, ldl, C, K, stream);
}

}  // namespace

extern "C" {

// l [G,S,S] (row stride ldl), x [G,S,C], out [G,S,F] in x's dtype (bf16 !=
// 0: bfloat16, else float32); w [K,C,F] and b [F] float32; wt: scratch of K·C·F elements of
// x's type when bf16 != 0, else unused; ts: scratch [K-1,G,S,C] in x's type
// (unused when K = 1).  Returns a cudaError_t.
int hlhgat_band_fused_fwd(const void* l, const void* x, const void* w, const void* b,
                          void* out, void* wt, void* ts, int G, int S, int ldl, int C, int F,
                          int K, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? band_fused_fwd<__nv_bfloat16>(l, x, w, b, out, wt, ts, G, S, ldl, C, F, K, s)
              : band_fused_fwd<float>(l, x, w, b, out, wt, ts, G, S, ldl, C, F, K, s);
}

// l [G,S,S] (row stride ldl), x [G,S,C] -> t [K,G,S,C], all in x's dtype.
int hlhgat_band_terms_fwd(const void* l, const void* x, void* t, int G, int S, int ldl, int C,
                          int K, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? band_terms_fwd<__nv_bfloat16>(l, x, t, G, S, ldl, C, K, s)
              : band_terms_fwd<float>(l, x, t, G, S, ldl, C, K, s);
}

// Number of graph-block slices of the dW/db partial sums: the caller
// allocates partial [n_split, K*C*F + F] float32.
int hlhgat_band_fused_bwd_splits(int G, int C, int F, int K) { return band_splits(G, C, F, K); }

// l [G,S,S] (row stride ldl), x [G,S,C], g [G,S,F], dx [G,S,C] in x's
// dtype; w [K,C,F] float32; dwdb [K*C*F + F] float32 receives dW then db;
// wt as in the forward; ts: scratch [K-1,G,S,C] and bars: scratch [K,G,S,C]
// in x's type (both unused when K = 1).
int hlhgat_band_fused_bwd(const void* l, const void* x, const void* w, const void* g,
                          void* dx, void* dwdb, void* partial, void* wt, void* ts, void* bars,
                          int G, int S, int ldl, int C, int F, int K, int n_split, int bf16,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? band_fused_bwd<__nv_bfloat16>(l, x, w, g, dx, dwdb, partial, wt, ts, bars, G,
                                              S, ldl, C, F, K, n_split, s)
              : band_fused_bwd<float>(l, x, w, g, dx, dwdb, partial, wt, ts, bars, G, S, ldl,
                                      C, F, K, n_split, s);
}

// l [G,S,S] (row stride ldl), dt [K,G,S,C] -> dx [G,S,C], all in dt's
// dtype; bars: scratch [K-1,G,S,C] (unused when K = 1).
int hlhgat_band_terms_bwd(const void* l, const void* dt, void* dx, void* bars, int G, int S,
                          int ldl, int C, int K, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? band_terms_bwd<__nv_bfloat16>(l, dt, dx, bars, G, S, ldl, C, K, s)
              : band_terms_bwd<float>(l, dt, dx, bars, G, S, ldl, C, K, s);
}

const char* hlhgat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
