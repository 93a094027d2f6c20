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
// Bound on an H100 (3.35 TB/s; bf16 tensor cores 989 TFLOP/s; float32 as
// 3xTF32 495/3 = 165 TFLOP/s) at the widest zinc_pyr layer, G=78 blocks,
// S=128, C=F=256, K=6:
//   fused bwd: 4·G·S·(S·C·(K-1) + K·C·F) = 22.2 GFLOP -> 0.135 ms f32 and
//              0.022 ms bf16, bound by operations (46 MB of traffic);
//   terms bwd: 2·G·S·S·C·(K-1) = 3.3 GFLOP (0.020 ms f32, 0.003 ms bf16),
//              but it reads K cotangents: 76.7 MB of traffic in f32 and
//              38.3 MB in bf16 bound it by bytes, 0.023 and 0.011 ms.
//
// The fused backward, against what the TPU kernel relied on and what this
// card offers.  The TPU kernel keeps the [K,Ct,F] dW block resident while its
// sequential grid sweeps the graph blocks.  GPU blocks run in no order, so
// the fused backward is three kernels behind one entry point, the first two
// on tensor cores (laguerre_common.cuh: bf16 mma.sync.m16n8k16 fed
// by ldmatrix, float32 as 3xTF32 on mma.sync.m16n8k8; f32 accumulators;
// operands in shared memory in x's type; 16 warps a block; 16-byte cp.async
// loads with a scalar path for ragged edges and unaligned bases):
// - dx (fused_bwd_dx_mma_kernel): one block per (graph block, 32-wide
//   C-slice).  It takes the terms in chunks of at most 8 (kTermChunk), from
//   the top of the walk down.  For each chunk it streams g and the chunk's
//   weight slices in F-chunks (64 features in bf16, 32 in f32;
//   double-buffered with cp.async, so a chunk arrives while the last one is
//   multiplied) and keeps the chunk's products bar_k = g W_k^T as f32
//   accumulators in registers (8 a term and thread), one g fragment serving
//   the chunk's terms.  The adjoint walk then runs through the chunk in
//   registers: two cotangents are carried from step to step (and from chunk
//   to chunk) as element pairs in x's arithmetic (Pair<T>), only the tile
//   that L multiplies next goes through shared memory (two tiles,
//   alternating), and L·bar comes back at the accumulator's own coordinates.
//   So shared memory holds L, two [S,32] tiles and the streamed chunks of g
//   and of at most 8 weight slices: 162 KB in bf16, 226 KB in f32 at S=128,
//   whatever K is; g is read once a chunk of terms.
// - dW/db partials (fused_bwd_dw_mma_kernel): one block per (16-channel
//   C-slice, 256-wide F-tile, slice of the graph blocks), about one block an
//   SM.  It walks its graph blocks in a fixed order with L, the x slice and
//   g loaded once per graph block, recomputes the terms once per (graph
//   block, channel) for F <= 256 with two rotating tiles (T_{k+1} is written
//   over T_{k-1}) and adds T_k^T g into one register accumulator set per
//   term of a chunk of at most 8 (8 a term and thread).  With K <= 8 the
//   sets run over all of the block's graph blocks and are written once; with
//   more, each chunk's sets are added into the block's own share of the
//   partials after each graph block and cleared, while the recurrence runs
//   on.  Blocks of the first C-slice also sum g over rows for db.  No
//   atomics.  Shared memory at S=128: L, two [S,16] tiles and g [S,256]:
//   112 KB in bf16, 222 KB in f32.
// - reduce (reduce_partials_kernel): adds the slices' partials in slice order
//   into dW and db.
// The sum order depends on the shapes only, so the gradient is the same from
// run to run.
// * Block sizes S <= 128 of any value are padded with zeros to a multiple
//   of 32 rows in shared memory; any C, F and K.  Larger blocks go to
//   laguerre_band.cu, behind the same wrappers.
// * Rounding follows the JAX kernel: g and W are taken in x's dtype; bar_k
//   and each L·bar product are accumulated in f32 and rounded to x's dtype;
//   every elementwise step of the walk is rounded to x's dtype (the j/(j+1)
//   coefficient too); T_k^T g and the sums over graph blocks stay in f32.
//
// The terms backward (terms_bwd_mma_kernel), bound by the cotangents it
// reads:
// * One block per (graph block, 32-channel slice): 4 warps along the rows x
//   1 (bf16) or 2 (f32) along the slice (TermsTile, laguerre_common.cuh).
//   L·b̄ runs on the tensor cores (warp_gemm, as above).
// * The walk is streamed.  Three cotangents live in registers at the
//   accumulator's coordinates, b̄_kk, b̄_{kk-1} and b̄_{kk-2}, as element
//   pairs in dt's arithmetic (Pair<T>: packed bf16x2 in bf16).  Two shared
//   tiles alternate: dt_{kk-3} arrives in one by cp.async while L·b̄_kk runs
//   on the other, and the next step reads it at each thread's own
//   coordinates and writes b̄_{kk-1} over it there, the operand of its
//   product (two barriers a step).  So shared memory holds L and two
//   [S, 32] tiles in dt's type whatever K is (54 KB in bf16, four blocks an
//   SM; 106 KB in f32, two, at S=128): any K >= 1.
// * dx leaves through a tile with 16-byte stores.
// * Rounding as in the fused dx kernel; no atomics: a second launch gives
//   the same bits.

#include "laguerre_common.cuh"

namespace {

constexpr int kDxCT = 32;           // channel slice of the dx kernel
constexpr int kTermChunk = 8;       // terms whose products or dW a block holds at once
constexpr int kDwCT = 16;           // dW tile: channels ...
constexpr int kDwFT = 256;          // ... x features
constexpr int kTargetBlocks = 132;  // one block an SM on an H100

// A warp's share of a tile at its accumulator coordinates, v[2][NT][2]
// (rows 16 mi + gid + 8 h, columns 8 ni + 2 tig and the next, from the tile
// corner p), to and from shared memory.
template <typename T, int NT>
__device__ inline void frag_to_tile(T* p, int ld, const typename Pair<T>::V (&v)[2][NT][2]) {
  const int gid = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        Pair<T>::st(p + (16 * mi + gid + 8 * h) * ld + 8 * ni + 2 * tig, v[mi][ni][h]);
}

template <typename T, int NT>
__device__ inline void frag_from_tile(const T* p, int ld, typename Pair<T>::V (&v)[2][NT][2]) {
  const int gid = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        v[mi][ni][h] = Pair<T>::ld(p + (16 * mi + gid + 8 * h) * ld + 8 * ni + 2 * tig);
}

// Warp (wm, wn) of the 4 x 4 layout owns rows 32 wm .. + 31 and columns
// 8 wn .. + 7 of the block's [S, 32] slice of every bar_k.  The terms come in
// chunks of at most kTermChunk, from the top of the walk down: a chunk's
// products g W_k^T are formed in registers (g streamed once a chunk), then
// the walk runs through the chunk.  Between steps the walk carries
// cur = b̄_kk (whole) and nx1 = b̄_{kk-1} (its product plus the step above)
// in registers at the accumulator's coordinates; step kk takes b̄_{kk-2}'s
// product from the chunk.
template <typename T>
__global__ void __launch_bounds__(kMmaThreads, 1)
    fused_bwd_dx_mma_kernel(const T* __restrict__ l, const T* __restrict__ w,
                            const T* __restrict__ gout, T* __restrict__ dx,
                            int S, int C, int F, int K) {
  using M = Mma<T>;
  using P = Pair<T>;
  using V = typename P::V;
  constexpr int CT = kDxCT, FK = M::kCT, KC = kTermChunk;
  constexpr int ldb = CT + M::kPadN, ldg = FK + M::kPadKP, ldw = FK + M::kPadKP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = pad32(S), ldl = sp + M::kPadK;
  const int kc = K < KC ? K : KC;  // W slices a chunk buffer holds
  T* ls = reinterpret_cast<T*>(smem_raw);
  T* bt = ls + sp * ldl;      // 2 tiles [sp][ldb]: the walk's operand, then dx
  T* gs = bt + 2 * sp * ldb;  // 2 chunks of g [sp][ldg]
  T* ws = gs + 2 * sp * ldg;  // 2 chunks of W [kc][CT][ldw]
  const int g = blockIdx.x, c0 = blockIdx.y * CT;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp >> 2) * 32, n0 = (warp & 3) * 8;
  const bool active = m0 < sp;
  const int corner = m0 * ldb + n0;
  const int chunks = (F + FK - 1) / FK;
  // step n of the products: term chunk n / chunks, F-chunk n % chunks
  const int steps = (K + KC - 1) / KC * chunks;
  const T* gg = gout + (size_t)g * S * F;

  auto load_step = [&](int n, int buf) {
    const int hi = K - n / chunks * KC, lo = hi > KC ? hi - KC : 0;
    const int f0 = n % chunks * FK;
    load_tile_async<T>(gs + buf * sp * ldg, ldg, gg + f0, F, sp, FK, S, F - f0);
    for (int k = lo; k < hi; ++k)
      load_tile_async<T>(ws + (buf * kc + k - lo) * CT * ldw, ldw,
                         w + ((size_t)k * C + c0) * F + f0, F, CT, FK, C - c0,
                         F - f0);
  };

  // lt = L @ v for the warp's coordinates: v goes through the shared tile
  // `buf`, which nobody reads any more (the barrier before the last use of
  // the other tile came after every read of this one).
  int buf = 0;
  float lt[2][1][4];
  auto l_times = [&](const V (&v)[2][1][2]) {
    T* tile = bt + buf * sp * ldb;
    if (active) frag_to_tile<T, 1>(tile + corner, ldb, v);
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int r = 0; r < 4; ++r) lt[mi][0][r] = 0.f;
    if (active)
      warp_gemm<T, 2, 1, true, false>(lt, ls + m0 * ldl, ldl, tile + n0, ldb, sp);
    buf ^= 1;
  };

  float bar[KC][2][4];  // g W_k^T of the chunk's terms lo + j
  V cur[2][1][2], nx1[2][1][2];

  // bar[j] = g W_{lo+j}^T for j < nk, term chunk tc: steps tc·chunks ..
  auto products = [&](int tc, int nk) {
#pragma unroll
    for (int j = 0; j < KC; ++j)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int r = 0; r < 4; ++r) bar[j][mi][r] = 0.f;
    for (int ch = 0; ch < chunks; ++ch) {
      const int n = tc * chunks + ch;
      cp_async_wait_all();
      __syncthreads();  // this step's chunk is whole; the last step's reads are done
      if (n + 1 < steps) load_step(n + 1, (n + 1) & 1);
      if (!active) continue;
      // bar[j] += g[rows, chunk] @ W_{lo+j}[columns, chunk]^T, one g fragment for all j
      const T* ga = gs + (n & 1) * sp * ldg + m0 * ldg;
      const T* wb = ws + (n & 1) * kc * CT * ldw + n0 * ldw;
#pragma unroll 2
      for (int k0 = 0; k0 < FK; k0 += M::kDepth) {
        typename M::AFrag af[2];
        M::template load_a_kmajor<true>(af[0], ga + k0, ldg);
        M::template load_a_kmajor<true>(af[1], ga + 16 * ldg + k0, ldg);
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          if (j < nk) {
            typename M::BFrag bf;
            M::template load_b_kmajor<true>(bf, wb + j * CT * ldw + k0, ldw);
            M::mma(bar[j][0], af[0], bf);
            M::mma(bar[j][1], af[1], bf);
          }
        }
      }
    }
  };
  // at the top of the walk b̄_{K-1} and b̄_{K-2} start as their products
  auto start_walk = [&](int nk) {
#pragma unroll
    for (int j = 0; j < KC; ++j)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const V p = P::of(bar[j][mi][2 * h], bar[j][mi][2 * h + 1]);
          if (j == nk - 1) cur[mi][0][h] = p;
          if (j == nk - 2) nx1[mi][0][h] = p;
        }
  };
  // steps kk = lo + top .. lo + 2 through the chunk
  auto walk = [&](int lo, int top) {
#pragma unroll
    for (int j = KC + 1; j >= 2; --j) {
      if (j > top) continue;
      // b̄_{kk-1} += (-L b̄_kk + (2i+1) b̄_kk) / (i+1) and
      // b̄_{kk-2} -= i/(i+1) b̄_kk with i = kk - 1, then the window moves down
      const float jf = (float)(lo + j - 1), a = 2.f * jf + 1.f, d = jf + 1.f;
      const float coef = Io<T>::round(jf / d);
      l_times(cur);
      if (!active) continue;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const V b0 = cur[mi][0][h];
          const V lv = P::of(lt[mi][0][2 * h], lt[mi][0][2 * h + 1]);
          cur[mi][0][h] = P::add(nx1[mi][0][h], P::div(P::sub(P::mul(a, b0), lv), d));
          nx1[mi][0][h] = P::sub(P::of(bar[j - 2][mi][2 * h], bar[j - 2][mi][2 * h + 1]),
                                 P::mul(coef, b0));
        }
    }
  };

  load_tile_async<T>(ls, ldl, l + (size_t)g * S * S, S, sp, sp, S, S);
  load_step(0, 0);
  if (K <= KC) {  // one chunk: the terms and the walk's coefficients are constants
    products(0, K);
    start_walk(K);
    walk(0, K - 1);
  } else {
    // chunks from the top down; the walk carries cur and nx1 from one to the
    // next, whose first step is the one above it
    for (int tc = 0, hi = K; hi > 0; ++tc, hi -= KC) {
      const int lo = hi > KC ? hi - KC : 0;
      products(tc, hi - lo);
      if (tc == 0) start_walk(hi - lo);
      walk(lo, tc == 0 ? hi - lo - 1 : hi - lo + 1);
    }
  }
  if (K > 1) {  // cur = b̄_1, nx1 = b̄_0: dx = b̄_0 + b̄_1 - L b̄_1
    l_times(cur);
    if (active) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const V lv = P::of(lt[mi][0][2 * h], lt[mi][0][2 * h + 1]);
          cur[mi][0][h] = P::sub(P::add(nx1[mi][0][h], cur[mi][0][h]), lv);
        }
    }
  }
  // dx (in cur) leaves through the tile l_times would write next, with
  // 16-byte stores
  T* tile = bt + buf * sp * ldb;
  if (active) frag_to_tile<T, 1>(tile + corner, ldb, cur);
  __syncthreads();
  store_tile<T>(dx + (size_t)g * S * C + c0, C, tile, ldb, S, CT, C - c0);
}

// partial[split][K*C*F + F]: this slice's share of dW (then db).  The
// recurrence runs on an 8 x 2 warp layout (rows 16 rm .., half the channel
// slice each); the accumulation T_k^T g splits the F-tile over the 16 warps.
// dW is accumulated for kTermChunk terms at a time: with K <= kTermChunk
// over all of the slice's graph blocks, written once; with more terms each
// chunk of each graph block is added into the block's own share of partial
// (in graph-block order) and the registers are cleared, while the
// recurrence runs on from the two tiles in shared memory.
template <typename T>
__global__ void __launch_bounds__(kMmaThreads, 1)
    fused_bwd_dw_mma_kernel(const T* __restrict__ l, const T* __restrict__ x,
                            const T* __restrict__ gout,
                            float* __restrict__ partial, int G, int S, int C,
                            int F, int K) {
  using M = Mma<T>;
  using P = Pair<T>;
  constexpr int CT = kDwCT, FT = kDwFT, KC = kTermChunk;
  constexpr int MT = CT / 16;    // m16-tiles of the accumulation
  constexpr int NTA = FT / 128;  // n8-tiles a warp owns in the accumulation
  constexpr int NTL = CT / 16;   // n8-tiles a warp owns in L·T
  static_assert(KC % 2 == 0, "a chunk starts at an even term");
  constexpr int ldt = CT + M::kPadN, ldg = FT + M::kPadN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = pad32(S), ldl = sp + M::kPadK;
  T* ls = reinterpret_cast<T*>(smem_raw);
  T* tb = ls + sp * ldl;      // 2 rotating term tiles [sp][ldt]
  T* gs = tb + 2 * sp * ldt;  // g[:, f0:f0+FT] as [sp][ldg]
  const int c0 = blockIdx.x * CT, f0 = blockIdx.y * FT;
  const int split = blockIdx.z, n_split = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rm0 = (warp >> 1) * 16, rn0 = (warp & 1) * (CT / 2);
  const bool rec_on = rm0 < sp;
  const int an0 = warp * (FT / 16);
  const bool acc_on = f0 + an0 < F;
  const bool sums_db = blockIdx.x == 0 && threadIdx.x < FT &&
                       f0 + (int)threadIdx.x < F;
  const size_t n_w = (size_t)K * C * F;
  float* mine = partial + (size_t)split * (n_w + F);

  float acc[KC][MT][NTA][4] = {};
  // acc of the terms lo .. into mine (added to what is there unless first),
  // then cleared
  auto flush = [&](int lo, bool first) {
    if (!acc_on) return;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (lo + j < K) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < NTA; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int c = c0 + 16 * mi + gid + 8 * (r >> 1);
              const int f = f0 + an0 + 8 * ni + 2 * tig + (r & 1);
              if (c < C && f < F) {
                float* dst = mine + ((size_t)(lo + j) * C + c) * F + f;
                *dst = first ? acc[j][mi][ni][r] : *dst + acc[j][mi][ni][r];
              }
              acc[j][mi][ni][r] = 0.f;
            }
      }
    }
  };

  // acc[j] += T_{lo+j}^T g for the chunk's terms, the recurrence running on
  // from the two tiles (lo is even, so T_k sits in tile k & 1 = j & 1)
  auto terms = [&](int lo) {
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int k = lo + j;
      if (k < K) {
        const T* cur = tb + (j & 1) * sp * ldt;
        T* other = tb + ((j + 1) & 1) * sp * ldt;  // T_{k-1}, receives T_{k+1}
        if (acc_on)
          warp_gemm<T, MT, NTA, false, false>(acc[j], cur, ldt, gs + an0, ldg, sp);
        if (k + 1 < K) {
          if (rec_on) {
            float lt[1][NTL][4] = {};
            warp_gemm<T, 1, NTL, true, false>(lt, ls + rm0 * ldl, ldl, cur + rn0, ldt, sp);
#pragma unroll
            for (int ni = 0; ni < NTL; ++ni)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int at = (rm0 + gid + 8 * h) * ldt + rn0 + 8 * ni + 2 * tig;
                const typename P::V tp = k > 0 ? P::ld(other + at) : P::of(0.f, 0.f);
                P::st(other + at, laguerre_step_pair<T>(lt[0][ni][2 * h], lt[0][ni][2 * h + 1],
                                                        P::ld(cur + at), tp, k));
              }
          }
          __syncthreads();  // T_{k+1} is whole; T_k's readers are done
        }
      }
    }
  };

  float db = 0.f;
  for (int g = split; g < G; g += n_split) {
    __syncthreads();  // the previous graph block's reads are done
    load_tile_async<T>(ls, ldl, l + (size_t)g * S * S, S, sp, sp, S, S);
    load_tile_async<T>(tb, ldt, x + (size_t)g * S * C + c0, C, sp, CT, S, C - c0);
    load_tile_async<T>(gs, ldg, gout + (size_t)g * S * F + f0, F, sp, FT, S,
                       F - f0);
    cp_async_wait_all();
    __syncthreads();
    if (sums_db)
      for (int r = 0; r < S; ++r) db += Io<T>::load(gs, r * ldg + threadIdx.x);
    if (K <= KC) {  // one chunk: the term index is a constant
      terms(0);
    } else {
      for (int lo = 0; lo < K; lo += KC) {
        terms(lo);
        flush(lo, g == split);
      }
    }
  }
  if (K <= KC) flush(0, true);
  if (sums_db) mine[n_w + f0 + threadIdx.x] = db;
}

// Warp w owns rows 32 (w / WN) .. + 31 and the channels (CT / WN)·(w % WN)
// .. of the block's slice of every cotangent.  The walk keeps three of them
// in registers at the accumulator's coordinates: cur = b̄_kk, nx1 = b̄_{kk-1},
// nx2 = b̄_{kk-2}.  Two shared tiles alternate: dt_j arrives in tb[j & 1],
// and the step kk = j + 2 reads it at its own coordinates and writes b̄_kk
// there, the operand of its L·b̄.
template <typename T, int WN>
__global__ void __launch_bounds__(128 * WN, 4 / WN)
    terms_bwd_mma_kernel(const T* __restrict__ l, const T* __restrict__ dt,
                         T* __restrict__ dx, int G, int S, int C, int K) {
  using M = Mma<T>;
  using P = Pair<T>;
  using V = typename P::V;
  constexpr int CT = kTermsCT;
  constexpr int NT = CT / (8 * WN);  // n8-tiles a warp owns in L·b̄
  static_assert(NT >= 1 && CT % (8 * WN) == 0, "a warp owns whole n8-tiles");
  constexpr int ldt = CT + M::kPadN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = pad32(S), ldl = sp + M::kPadK;
  const int tile = sp * ldt;
  T* ls = reinterpret_cast<T*>(smem_raw);
  T* tb = ls + sp * ldl;  // 2 tiles [sp][ldt]
  const int c0 = blockIdx.y * CT, cv = C - c0;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp / WN) * 32, n0 = (warp % WN) * (CT / WN);
  const bool active = m0 < sp;
  const int corner = m0 * ldt + n0;
  const size_t at = (size_t)blockIdx.x * S * C + c0;  // the slice in [G,S,C]
  const size_t term_stride = (size_t)G * S * C;

  auto load_dt = [&](int j) {
    load_tile_async<T>(tb + (j & 1) * tile, ldt, dt + j * term_stride + at, C,
                       sp, CT, S, cv);
  };
  // lt = L @ (the tile tb[b]) at the warp's coordinates
  auto l_times = [&](float (&lt)[2][NT][4], int b) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) lt[mi][ni][r] = 0.f;
    warp_gemm<T, 2, NT, true, false>(lt, ls + m0 * ldl, ldl, tb + b * tile + n0,
                                     ldt, sp);
  };

  if (K > 1)
    load_tile_async<T>(ls, ldl, l + (size_t)blockIdx.x * S * S, S, sp, sp, S, S);
  load_dt(K - 1);
  if (K > 1) load_dt(K - 2);
  cp_async_wait_all();
  __syncthreads();
  V cur[2][NT][2], nx1[2][NT][2], nx2[2][NT][2];
  float lt[2][NT][4];
  if (active) {
    frag_from_tile<T, NT>(tb + ((K - 1) & 1) * tile + corner, ldt, cur);
    if (K > 1) frag_from_tile<T, NT>(tb + (K & 1) * tile + corner, ldt, nx1);
  }
  if (K > 2) {
    __syncthreads();  // both tiles are read
    load_dt(K - 3);
  }
  for (int kk = K - 1; kk > 1; --kk) {
    const int b = kk & 1;
    const float jf = (float)(kk - 1), a = 2.f * jf + 1.f, d = jf + 1.f;
    const float coef = Io<T>::round(jf / d);
    cp_async_wait_all();
    __syncthreads();  // dt_{kk-2} has landed in tb[b]
    if (active) {
      // each thread reads dt_{kk-2} and writes b̄_kk at the same coordinates
      frag_from_tile<T, NT>(tb + b * tile + corner, ldt, nx2);
      frag_to_tile<T, NT>(tb + b * tile + corner, ldt, cur);
    }
    __syncthreads();  // b̄_kk is whole
    // dt_{kk-3} arrives in the other tile while L·b̄_kk runs; that tile's
    // last reader, the previous step's product, finished before the barriers
    if (kk > 2) load_dt(kk - 3);
    if (active) {
      l_times(lt, b);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // b̄_{kk-1} += (-L b̄_kk + (2j+1) b̄_kk) / (j+1) and
            // b̄_{kk-2} -= j/(j+1) b̄_kk, then the window moves down one term
            const V b0 = cur[mi][ni][h];
            const V lv = P::of(lt[mi][ni][2 * h], lt[mi][ni][2 * h + 1]);
            cur[mi][ni][h] = P::add(nx1[mi][ni][h], P::div(P::sub(P::mul(a, b0), lv), d));
            nx1[mi][ni][h] = P::sub(nx2[mi][ni][h], P::mul(coef, b0));
          }
    }
  }
  if (K > 1) {  // cur = b̄_1, nx1 = b̄_0: dx = b̄_0 + b̄_1 - L b̄_1
    // tb[1] was last read by the product of step 3 (or, at K = 2, at these
    // coordinates only): no barrier before the write
    if (active) frag_to_tile<T, NT>(tb + tile + corner, ldt, cur);
    __syncthreads();
    if (active) {
      l_times(lt, 1);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const V lv = P::of(lt[mi][ni][2 * h], lt[mi][ni][2 * h + 1]);
            cur[mi][ni][h] = P::sub(P::add(nx1[mi][ni][h], cur[mi][ni][h]), lv);
          }
    }
  }
  // dx (in cur) leaves through tb[0] with 16-byte stores; its last reader
  // was the product of step 2 (or this thread)
  if (active) frag_to_tile<T, NT>(tb + corner, ldt, cur);
  __syncthreads();
  store_tile<T>(dx + at, C, tb, ldt, S, CT, cv);
}

template <typename T>
size_t dx_smem_bytes(int S, int K) {
  using M = Mma<T>;
  const int sp = pad32(S), kc = K < kTermChunk ? K : kTermChunk;
  return sizeof(T) * ((size_t)sp * (sp + M::kPadK) +
                      2 * (size_t)sp * (kDxCT + M::kPadN) +
                      2 * (size_t)sp * (M::kCT + M::kPadKP) +
                      2 * (size_t)kc * kDxCT * (M::kCT + M::kPadKP));
}

template <typename T>
size_t dw_smem_bytes(int S) {
  using M = Mma<T>;
  const int sp = pad32(S);
  return sizeof(T) * ((size_t)sp * (sp + M::kPadK) +
                      2 * (size_t)sp * (kDwCT + M::kPadN) +
                      (size_t)sp * (kDwFT + M::kPadN));
}

template <typename T>
size_t fused_bwd_smem_bytes(int S, int K) {
  const size_t a = dx_smem_bytes<T>(S, K), b = dw_smem_bytes<T>(S);
  return a > b ? a : b;
}

int dw_splits(int G, int C, int F) {
  const int tiles =
      ((C + kDwCT - 1) / kDwCT) * ((F + kDwFT - 1) / kDwFT);
  int n = kTargetBlocks / tiles;  // rounded down: one wave
  if (n > G) n = G;
  return n < 1 ? 1 : n;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// wt: scratch of K·C·F elements of T that receives W in x's type (unused,
// may be null, when T is float: w is taken as it is).
template <typename T>
int launch_fused_bwd(const void* l_, const void* x_, const void* w_,
                     const void* g_, void* dx_, void* dwdb_, void* partial_,
                     void* wt_, int G, int S, int C, int F, int K, int n_split,
                     cudaStream_t stream) {
  const T* l = static_cast<const T*>(l_);
  const T* x = static_cast<const T*>(x_);
  const T* g = static_cast<const T*>(g_);
  const T* w = static_cast<const T*>(w_);
  float* partial = static_cast<float*>(partial_);
  if (K < 1 || n_split < 1 || n_split > G)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (sizeof(T) != sizeof(float)) {
    const size_t n = (size_t)K * C * F;
    cast_w_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(w_), static_cast<T*>(wt_), n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    w = static_cast<const T*>(wt_);
  }

  size_t smem = dx_smem_bytes<T>(S, K);
  err = allow_smem(fused_bwd_dx_mma_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  fused_bwd_dx_mma_kernel<T>
      <<<dim3(G, (C + kDxCT - 1) / kDxCT), kMmaThreads, smem, stream>>>(
          l, w, g, static_cast<T*>(dx_), S, C, F, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  smem = dw_smem_bytes<T>(S);
  err = allow_smem(fused_bwd_dw_mma_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + kDwCT - 1) / kDwCT, (F + kDwFT - 1) / kDwFT,
                  n_split);
  fused_bwd_dw_mma_kernel<T><<<grid, kMmaThreads, smem, stream>>>(
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
  constexpr int CT = kTermsCT, WN = TermsTile<T>::kWnb;
  if (K < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = terms_smem_bytes<T>(S);
  cudaError_t err = allow_smem(terms_bwd_mma_kernel<T, WN>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(G, (C + CT - 1) / CT);
  terms_bwd_mma_kernel<T, WN><<<grid, 128 * WN, smem, stream>>>(
      static_cast<const T*>(l), static_cast<const T*>(dt), static_cast<T*>(dx),
      G, S, C, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Most shared memory a kernel of the fused backward needs (block size S, K
// terms; bf16 != 0: bfloat16, else float32).
size_t hlhgat_laguerre_fused_bwd_smem(int S, int K, int bf16) {
  return bf16 ? fused_bwd_smem_bytes<__nv_bfloat16>(S, K)
              : fused_bwd_smem_bytes<float>(S, K);
}

// Number of graph-block slices of the dW/db partial sums: the caller
// allocates partial [n_split, K*C*F + F] float32.
int hlhgat_laguerre_fused_bwd_splits(int G, int C, int F) {
  return dw_splits(G, C, F);
}

// l [G,S,S], x [G,S,C], g [G,S,F], dx [G,S,C] in x's dtype (bf16 != 0:
// bfloat16, else float32); w [K,C,F] float32; dwdb [K*C*F + F] float32
// receives dW then db; wt: scratch of K·C·F bfloat16 when bf16 != 0 (W in
// x's type), else unused.  Returns a cudaError_t.
int hlhgat_laguerre_fused_bwd(const void* l, const void* x, const void* w,
                              const void* g, void* dx, void* dwdb,
                              void* partial, void* wt, int G, int S, int C,
                              int F, int K, int n_split, int bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fused_bwd<__nv_bfloat16>(l, x, w, g, dx, dwdb, partial,
                                                wt, G, S, C, F, K, n_split, s)
              : launch_fused_bwd<float>(l, x, w, g, dx, dwdb, partial, wt, G, S,
                                        C, F, K, n_split, s);
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
