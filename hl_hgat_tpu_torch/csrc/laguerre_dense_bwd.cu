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
//   terms bwd: 2·G·S·S·C·(K-1) = 3.3 GFLOP -> 0.020 ms f32, bound by
//              operations; in bf16 by the bytes of the K cotangents it reads.
//
// The fused backward, against what the TPU kernel relied on and what this
// card offers.  The TPU kernel keeps the [K,Ct,F] dW block resident while its
// sequential grid sweeps the graph blocks.  GPU blocks run in no order, so
// the fused backward is three kernels behind one entry point, the first two
// on tensor cores (laguerre_common.cuh, part 2: bf16 mma.sync.m16n8k16 fed
// by ldmatrix, float32 as 3xTF32 on mma.sync.m16n8k8; f32 accumulators;
// operands in shared memory in x's type; 16 warps a block; 16-byte cp.async
// loads with a scalar path for ragged edges and unaligned bases):
// - dx (fused_bwd_dx_mma_kernel): one block per (graph block, 32-wide
//   C-slice).  It streams g and the K weight slices in F-chunks (64 features
//   in bf16, 32 in f32; double-buffered with cp.async, so a chunk arrives
//   while the last one is multiplied) and keeps all K products
//   bar_k = g W_k^T as f32 accumulators in registers (8 a term and thread),
//   one g fragment serving the K terms.  The adjoint walk then runs in those
//   registers: only the tile that L multiplies next goes through shared
//   memory (two tiles, alternating), L·bar comes back at the accumulator's
//   own coordinates and the two cotangents below are updated in place.  So
//   shared memory holds L, two [S,32] tiles and the streamed chunks: 162 KB
//   in bf16, 226 KB in f32 at S=128, K=8 — every K <= 8 fits.
// - dW/db partials (fused_bwd_dw_mma_kernel): one block per (16-channel
//   C-slice, 256-wide F-tile, slice of the graph blocks), about one block an
//   SM.  It walks its graph blocks in a fixed order with L, the x slice and
//   g loaded once per graph block, recomputes the terms once per (graph
//   block, channel) for F <= 256 with two rotating tiles (T_{k+1} is written
//   over T_{k-1}) and adds T_k^T g into one register accumulator set per
//   term (8 a term and thread, hence K <= 8).  Blocks of the first C-slice
//   also sum g over rows for db.  Each writes its partial tile; no atomics.
//   Shared memory at S=128: L, two [S,16] tiles and g [S,256]: 112 KB in
//   bf16, 222 KB in f32.
// - reduce (reduce_partials_kernel): adds the slices' partials in slice order
//   into dW and db.
// The sum order depends on the shapes only, so the gradient is the same from
// run to run.
// * Block sizes S <= 128 of any value are padded with zeros to a multiple
//   of 32 rows in shared memory; any C and F; K <= 8.
// * Rounding follows the JAX kernel: g and W are taken in x's dtype; bar_k
//   and each L·bar product are accumulated in f32 and rounded to x's dtype;
//   every elementwise step of the walk is rounded to x's dtype (the j/(j+1)
//   coefficient too); T_k^T g and the sums over graph blocks stay in f32.
//
// The terms backward (terms_bwd_kernel) is the first version on CUDA cores:
// one block of 256 threads per (graph block, 32-wide C-tile) with all K
// cotangent tiles as f32 in shared memory beside L.

#include "laguerre_common.cuh"

namespace {

constexpr int kDxCT = 32;           // channel slice of the dx kernel
constexpr int kDwCT = 16;           // dW tile: channels ...
constexpr int kDwFT = 256;          // ... x features
constexpr int kTargetBlocks = 132;  // one block an SM on an H100

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

// Warp (wm, wn) of the 4 x 4 layout owns rows 32 wm .. + 31 and columns
// 8 wn .. + 7 of the block's [S, 32] slice of every bar_k.
template <typename T>
__global__ void __launch_bounds__(kMmaThreads, 1)
    fused_bwd_dx_mma_kernel(const T* __restrict__ l, const T* __restrict__ w,
                            const T* __restrict__ gout, T* __restrict__ dx,
                            int S, int C, int F, int K) {
  using M = Mma<T>;
  constexpr int CT = kDxCT, FK = M::kCT;
  constexpr int ldb = CT + M::kPadN, ldg = FK + M::kPadKP, ldw = FK + M::kPadKP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = pad32(S), ldl = sp + M::kPadK;
  T* ls = reinterpret_cast<T*>(smem_raw);
  T* bt = ls + sp * ldl;      // 2 tiles [sp][ldb]: the walk's operand
  T* gs = bt + 2 * sp * ldb;  // 2 chunks of g [sp][ldg]
  T* ws = gs + 2 * sp * ldg;  // 2 chunks of W [K][CT][ldw]
  const int g = blockIdx.x, c0 = blockIdx.y * CT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = (warp >> 2) * 32, n0 = (warp & 3) * 8;
  const bool active = m0 < sp;
  const int chunks = (F + FK - 1) / FK;
  const T* gg = gout + (size_t)g * S * F;

  auto load_chunk = [&](int ch, int buf) {
    const int f0 = ch * FK;
    load_tile_async<T>(gs + buf * sp * ldg, ldg, gg + f0, F, sp, FK, S, F - f0);
    for (int k = 0; k < K; ++k)
      load_tile_async<T>(ws + (buf * K + k) * CT * ldw, ldw,
                         w + ((size_t)k * C + c0) * F + f0, F, CT, FK, C - c0,
                         F - f0);
  };

  load_tile_async<T>(ls, ldl, l + (size_t)g * S * S, S, sp, sp, S, S);
  load_chunk(0, 0);

  // bar[k] += g[rows, chunk] @ W_k[columns, chunk]^T, one g fragment for all k
  float bar[kMaxK][2][4] = {};
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait_all();
    __syncthreads();  // this chunk is whole; the last chunk's reads are done
    if (ch + 1 < chunks) load_chunk(ch + 1, (ch + 1) & 1);
    if (!active) continue;
    const T* ga = gs + (ch & 1) * sp * ldg + m0 * ldg;
    const T* wb = ws + (ch & 1) * K * CT * ldw + n0 * ldw;
#pragma unroll 2
    for (int k0 = 0; k0 < FK; k0 += M::kDepth) {
      typename M::AFrag af[2];
      M::template load_a_kmajor<true>(af[0], ga + k0, ldg);
      M::template load_a_kmajor<true>(af[1], ga + 16 * ldg + k0, ldg);
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
          typename M::BFrag bf;
          M::template load_b_kmajor<true>(bf, wb + k * CT * ldw + k0, ldw);
          M::mma(bar[k][0], af[0], bf);
          M::mma(bar[k][1], af[1], bf);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 t = Io<T>::round2(
            make_float2(bar[k][mi][2 * h], bar[k][mi][2 * h + 1]));
        bar[k][mi][2 * h] = t.x;
        bar[k][mi][2 * h + 1] = t.y;
      }

  // lt = L @ v for the warp's coordinates: v goes through the shared tile
  // `buf`, which nobody reads any more (the barrier before the last use of
  // the other tile came after every read of this one).
  auto l_times_tile = [&](const float (&v)[2][4], float (&lt)[2][1][4], int buf) {
    T* tile = bt + buf * sp * ldb;
    if (active) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          st_pair(tile + (m0 + 16 * mi + gid + 8 * h) * ldb + n0 + 2 * tig,
                  v[mi][2 * h], v[mi][2 * h + 1]);
    }
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int r = 0; r < 4; ++r) lt[mi][0][r] = 0.f;
    if (active)
      warp_gemm<T, 2, 1, true, false>(lt, ls + m0 * ldl, ldl, tile + n0, ldb, sp);
  };

  using R = Io<T>;
  int buf = 0;
  float lt[2][1][4];
#pragma unroll
  for (int kk = kMaxK - 1; kk > 1; --kk) {
    if (kk < K) {
      const float jf = (float)(kk - 1), a = 2.f * jf + 1.f, d = jf + 1.f;
      const float coef = R::round(jf / d);
      l_times_tile(bar[kk], lt, buf);
      buf ^= 1;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* bt2 = &bar[kk][mi][2 * h];      // read
          float* b1 = &bar[kk - 1][mi][2 * h];   // += (-L bar + (2j+1) bar) / (j+1)
          float* b2 = &bar[kk - 2][mi][2 * h];   // -= j/(j+1) bar
          const float2 lv = R::round2(make_float2(lt[mi][0][2 * h], lt[mi][0][2 * h + 1]));
          const float2 av = R::round2(make_float2(a * bt2[0], a * bt2[1]));
          float2 s = R::round2(make_float2(av.x - lv.x, av.y - lv.y));
          s = R::round2(make_float2(R::div(s.x, d), R::div(s.y, d)));
          s = R::round2(make_float2(b1[0] + s.x, b1[1] + s.y));
          b1[0] = s.x;
          b1[1] = s.y;
          const float2 cv = R::round2(make_float2(coef * bt2[0], coef * bt2[1]));
          const float2 t = R::round2(make_float2(b2[0] - cv.x, b2[1] - cv.y));
          b2[0] = t.x;
          b2[1] = t.y;
        }
    }
  }
  if (K > 1) {
    l_times_tile(bar[1], lt, buf);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* b0 = &bar[0][mi][2 * h];
        const float* b1 = &bar[1][mi][2 * h];
        const float2 lv = R::round2(make_float2(lt[mi][0][2 * h], lt[mi][0][2 * h + 1]));
        const float2 sum = R::round2(make_float2(b0[0] + b1[0], b0[1] + b1[1]));
        const float2 t = R::round2(make_float2(sum.x - lv.x, sum.y - lv.y));
        b0[0] = t.x;
        b0[1] = t.y;
      }
  }
  if (!active) return;
  const bool pair_ok =
      C % 2 == 0 && reinterpret_cast<size_t>(dx) % (2 * sizeof(T)) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + 16 * mi + gid + 8 * h, c = c0 + n0 + 2 * tig;
      if (r >= S) continue;
      T* drow = dx + ((size_t)g * S + r) * C;
      if (c + 1 < C && pair_ok) {
        st_pair(drow + c, bar[0][mi][2 * h], bar[0][mi][2 * h + 1]);
      } else {
        if (c < C) Io<T>::store(drow, c, bar[0][mi][2 * h]);
        if (c + 1 < C) Io<T>::store(drow, c + 1, bar[0][mi][2 * h + 1]);
      }
    }
}

// partial[split][K*C*F + F]: this slice's share of dW (then db).  The
// recurrence runs on an 8 x 2 warp layout (rows 16 rm .., half the channel
// slice each); the accumulation T_k^T g splits the F-tile over the 16 warps.
template <typename T>
__global__ void __launch_bounds__(kMmaThreads, 1)
    fused_bwd_dw_mma_kernel(const T* __restrict__ l, const T* __restrict__ x,
                            const T* __restrict__ gout,
                            float* __restrict__ partial, int G, int S, int C,
                            int F, int K) {
  using M = Mma<T>;
  constexpr int CT = kDwCT, FT = kDwFT;
  constexpr int MT = CT / 16;    // m16-tiles of the accumulation
  constexpr int NTA = FT / 128;  // n8-tiles a warp owns in the accumulation
  constexpr int NTL = CT / 16;   // n8-tiles a warp owns in L·T
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

  float acc[kMaxK][MT][NTA][4] = {};
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
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < K) {
        const T* cur = tb + (k & 1) * sp * ldt;
        T* other = tb + ((k + 1) & 1) * sp * ldt;  // T_{k-1}, receives T_{k+1}
        // acc[k] += T_k^T @ g[:, own features]
        if (acc_on)
          warp_gemm<T, MT, NTA, false, false>(acc[k], cur, ldt, gs + an0, ldg, sp);
        if (k + 1 < K) {
          if (rec_on) {
            float lt[1][NTL][4] = {};
            warp_gemm<T, 1, NTL, true, false>(lt, ls + rm0 * ldl, ldl, cur + rn0,
                                              ldt, sp);
#pragma unroll
            for (int ni = 0; ni < NTL; ++ni)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int at = (rm0 + gid + 8 * h) * ldt + rn0 + 8 * ni + 2 * tig;
                const float2 tc = ld_pair(cur + at);
                float2 tp = make_float2(0.f, 0.f);
                if (k > 0) tp = ld_pair(other + at);
                const float2 tn = laguerre_step2<T>(
                    make_float2(lt[0][ni][2 * h], lt[0][ni][2 * h + 1]), tc, tp, k);
                st_pair(other + at, tn.x, tn.y);
              }
          }
          __syncthreads();  // T_{k+1} is whole; T_k's readers are done
        }
      }
    }
  }
  const size_t n_w = (size_t)K * C * F;
  float* mine = partial + (size_t)split * (n_w + F);
  if (acc_on) {
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < K) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < NTA; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int c = c0 + 16 * mi + gid + 8 * (r >> 1);
              const int f = f0 + an0 + 8 * ni + 2 * tig + (r & 1);
              if (c < C && f < F)
                mine[((size_t)k * C + c) * F + f] = acc[k][mi][ni][r];
            }
      }
    }
  }
  if (sums_db) mine[n_w + f0 + threadIdx.x] = db;
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

template <typename T>
size_t dx_smem_bytes(int S, int K) {
  using M = Mma<T>;
  const int sp = pad32(S);
  return sizeof(T) * ((size_t)sp * (sp + M::kPadK) +
                      2 * (size_t)sp * (kDxCT + M::kPadN) +
                      2 * (size_t)sp * (M::kCT + M::kPadKP) +
                      2 * (size_t)K * kDxCT * (M::kCT + M::kPadKP));
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

size_t terms_bwd_smem_bytes(int S, int K) {
  const int sp = pad4(S);
  return sizeof(float) * ((size_t)sp * (sp + 1) + (size_t)K * sp * kLdt);
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
  if (K < 1 || K > kMaxK || n_split < 1 || n_split > G)
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
// terms; bf16 != 0: bfloat16, else float32), and what the terms backward
// needs.
size_t hlhgat_laguerre_fused_bwd_smem(int S, int K, int bf16) {
  return bf16 ? fused_bwd_smem_bytes<__nv_bfloat16>(S, K)
              : fused_bwd_smem_bytes<float>(S, K);
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
