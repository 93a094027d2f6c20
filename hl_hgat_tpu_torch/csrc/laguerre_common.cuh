// Shared pieces of the dense-block Laguerre kernels (forward and backward).
// Included by laguerre_dense.cu and laguerre_dense_bwd.cu; every function is
// inlined into its kernel.
//
// Part 1 (CUDA cores, used by the terms kernels): the dtype helpers with the
// JAX kernels' rounding points, scalar tile loaders and the recurrence step.
// Thread layout of its row-owning steps: 256 threads as 32 row groups x 8
// column lanes; thread (rg, lane) owns rows 4rg..4rg+3 and columns
// lane + 8q, q < 4, of a [S, 32] channel tile.
//
// Part 2 (tensor cores, used by the fused kernels): blocks of 16 warps whose
// operands sit in shared memory in their own type.
// * bfloat16: mma.sync.m16n8k16 with f32 accumulators, fragments fetched
//   with ldmatrix (.trans where the tile is stored along the other axis).
//   Rows are padded by 16 bytes, so a row stride is an odd multiple of 16
//   bytes and the eight rows of an ldmatrix hit eight different bank groups.
// * float32: 3xTF32.  Each operand is split in registers into
//   hi = tf32(a), lo = tf32(a - hi) and the product is formed as
//   a_lo*b_hi + a_hi*b_lo + a_hi*b_hi on mma.sync.m16n8k8.tf32 with f32
//   accumulators: about 21 bits of each operand survive, against 10 of a
//   single TF32 pass.  Each k-step of 8 is summed in a fresh accumulator and
//   added to the running sum with a float add (round to nearest), because
//   the tensor core's own accumulation truncates.  Fragments are plain shared-memory loads.  An mma
//   does not care in which order the k index is walked as long as both
//   operands agree, so a product may pair the fragment's slots (t, t + 4)
//   with the memory indices (2t, 2t + 1) ("paired"): an operand stored
//   along k then needs one 8-byte load where it needed two 4-byte ones.
//   Row paddings make every read free of bank conflicts: a row stride of 8
//   x odd floats for a tile read down its columns or in pairs along its
//   rows (the term tiles are read both ways), 4 x odd for one read singly
//   along its rows (L) or down its columns in paired order (the forward's
//   W).
// * Global loads are 16-byte cp.async where the tile's origin and row
//   stride are 16-byte aligned and the chunk lies inside the array; ragged
//   edges and unaligned bases take scalar loads, and everything beyond the
//   array is zero in shared memory.  Nothing is padded in device memory.

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
  __device__ static float div(float a, float b) { return a / b; }
  __device__ static float2 round2(float2 v) { return v; }
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
  // a / b for a result that is rounded to bfloat16 next: the fast quotient
  // (2 ulp of float32) rounds to the same bfloat16 as the exact one for the
  // small integer divisors of the recurrence.
  __device__ static float div(float a, float b) { return __fdividef(a, b); }
  // both halves rounded with one packed conversion
  __device__ static float2 round2(float2 v) {
    return __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
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


// ---------------------------------------------------------------------------
// Part 2: tensor-core primitives of the fused kernels
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 512;  // 16 warps
constexpr int kMaxK = 8;          // register accumulator sets of the backward

__host__ __device__ inline int pad32(int s) { return (s + 31) & ~31; }

__device__ inline unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Every cp.async this thread has started has landed.
__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ inline void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ inline void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ inline void ldsm_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ inline void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// v = hi + lo with hi = tf32(v) and lo = tf32(v - hi), each rounded to
// TF32's 10 mantissa bits (nearest, ties away from zero: what
// cvt.rna.tf32.f32 gives, done on the integer pipe, which is faster than
// the conversion unit).  v - hi is exact.  Cutting lo instead of rounding it
// would bias every product towards zero: a model's gradients showed it.
__device__ inline void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ inline void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp-wide multiply-accumulate c[16x8] += a[16xkDepth] * b[kDepthx8].
// A lane (gid = lane / 4, tig = lane % 4) holds c[0..3] = rows gid, gid, gid
// + 8, gid + 8 and columns 2 tig, 2 tig + 1, 2 tig, 2 tig + 1.  The loaders
// take the address of the fragment's first element in a shared-memory tile
// stored along k ("kmajor": [M][K] for a, [N][K] for b) or along the other
// axis ("mmajor": [K][M], "nmajor": [K][N]).
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kDepth = 16;
  static constexpr int kPadK = 8;   // row padding of a tile read along its rows
  static constexpr int kPadN = 8;   // ... of one read down its columns
  static constexpr int kPadKP = 8;  // ... along its rows, paired order
  static constexpr int kPadNP = 8;  // ... down its columns, paired order
  static constexpr int kCT = 64;    // channel slice of the forward: 128 bytes
  struct AFrag { unsigned r[4]; };
  struct BFrag { unsigned r[2]; };

  // kPaired is a float32 matter: ldmatrix serves either order
  template <bool kPaired>
  __device__ static void load_a_kmajor(AFrag& f, const T* p, int ld) {
    const int l = threadIdx.x & 31;
    ldsm_x4(f.r, p + ((l & 7) + 8 * ((l >> 3) & 1)) * ld + 8 * (l >> 4));
  }
  __device__ static void load_a_mmajor(AFrag& f, const T* p, int ld) {
    const int l = threadIdx.x & 31;
    ldsm_x4_t(f.r, p + ((l & 7) + 8 * (l >> 4)) * ld + 8 * ((l >> 3) & 1));
  }
  template <bool kPaired>
  __device__ static void load_b_kmajor(BFrag& f, const T* p, int ld) {
    const int l = threadIdx.x & 15;
    ldsm_x2(f.r, p + (l & 7) * ld + 8 * (l >> 3));
  }
  template <bool kPaired>
  __device__ static void load_b_nmajor(BFrag& f, const T* p, int ld) {
    const int l = threadIdx.x & 15;
    ldsm_x2_t(f.r, p + l * ld);
  }
  __device__ static void mma(float (&c)[4], const AFrag& a, const BFrag& b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
          "r"(b.r[1]));
  }
};

template <>
struct Mma<float> {
  using T = float;
  static constexpr int kDepth = 8;
  static constexpr int kPadK = 4;
  static constexpr int kPadN = 8;
  static constexpr int kPadKP = 8;
  static constexpr int kPadNP = 4;
  static constexpr int kCT = 32;  // 128 bytes
  struct AFrag { unsigned hi[4], lo[4]; };
  struct BFrag { unsigned hi[2], lo[2]; };

  // Fragment slots: a0 (gid, tig), a1 (gid + 8, tig), a2 (gid, tig + 4),
  // a3 (gid + 8, tig + 4); b0 (k = tig, n = gid), b1 (k = tig + 4, n = gid).
  // Paired order reads slot tig at k = 2 tig and slot tig + 4 at 2 tig + 1.
  template <bool kPaired>
  __device__ static void load_a_kmajor(AFrag& f, const T* p, int ld) {
    const int gid = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
    if (kPaired) {
      const float2 u = *reinterpret_cast<const float2*>(p + gid * ld + 2 * tig);
      const float2 v = *reinterpret_cast<const float2*>(p + (gid + 8) * ld + 2 * tig);
      split_tf32(u.x, f.hi[0], f.lo[0]);
      split_tf32(v.x, f.hi[1], f.lo[1]);
      split_tf32(u.y, f.hi[2], f.lo[2]);
      split_tf32(v.y, f.hi[3], f.lo[3]);
    } else {
      split_tf32(p[gid * ld + tig], f.hi[0], f.lo[0]);
      split_tf32(p[(gid + 8) * ld + tig], f.hi[1], f.lo[1]);
      split_tf32(p[gid * ld + tig + 4], f.hi[2], f.lo[2]);
      split_tf32(p[(gid + 8) * ld + tig + 4], f.hi[3], f.lo[3]);
    }
  }
  __device__ static void load_a_mmajor(AFrag& f, const T* p, int ld) {
    const int gid = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
    split_tf32(p[tig * ld + gid], f.hi[0], f.lo[0]);
    split_tf32(p[tig * ld + gid + 8], f.hi[1], f.lo[1]);
    split_tf32(p[(tig + 4) * ld + gid], f.hi[2], f.lo[2]);
    split_tf32(p[(tig + 4) * ld + gid + 8], f.hi[3], f.lo[3]);
  }
  template <bool kPaired>
  __device__ static void load_b_kmajor(BFrag& f, const T* p, int ld) {
    const int gid = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
    if (kPaired) {
      const float2 u = *reinterpret_cast<const float2*>(p + gid * ld + 2 * tig);
      split_tf32(u.x, f.hi[0], f.lo[0]);
      split_tf32(u.y, f.hi[1], f.lo[1]);
    } else {
      split_tf32(p[gid * ld + tig], f.hi[0], f.lo[0]);
      split_tf32(p[gid * ld + tig + 4], f.hi[1], f.lo[1]);
    }
  }
  template <bool kPaired>
  __device__ static void load_b_nmajor(BFrag& f, const T* p, int ld) {
    const int gid = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
    const int k0 = kPaired ? 2 * tig : tig, k1 = kPaired ? 2 * tig + 1 : tig + 4;
    split_tf32(p[k0 * ld + gid], f.hi[0], f.lo[0]);
    split_tf32(p[k1 * ld + gid], f.hi[1], f.lo[1]);
  }
  // The two cross terms first, the large product last, summed over this
  // k-step of 8 in a fresh accumulator; the running sum is then taken on the
  // CUDA cores.  The tensor core adds into its accumulator by truncation,
  // a bias that a long sum and 18 layers of a model turn into a visible
  // error (whole-model gradients went from 4e-5 to 2e-3 of their norm with
  // the running sum inside the tensor core); a float add rounds to nearest.
  __device__ static void mma(float (&c)[4], const AFrag& a, const BFrag& b) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(t, a.lo, b.hi);
    mma_tf32(t, a.hi, b.lo);
    mma_tf32(t, a.hi, b.hi);
#pragma unroll
    for (int r = 0; r < 4; ++r) c[r] += t[r];
  }
};

// acc[mi][ni] += A[16 mi .., :depth] * B[:depth, 8 ni ..] for one warp.  a
// and b point at the warp's first row (column) of the tiles; kAK / kBK say
// whether the tile is stored along k, kPaired whether float32 walks k in
// paired order (not with an A stored along m).
template <typename T, int MT, int NT, bool kAK, bool kBK, bool kPaired = false>
__device__ inline void warp_gemm(float (&acc)[MT][NT][4], const T* a, int lda,
                                 const T* b, int ldb, int depth) {
  using M = Mma<T>;
  static_assert(kAK || !kPaired, "paired order needs A stored along k");
  // the widest float32 tile has no registers left for a second k-step in flight
  constexpr int kUnroll = (sizeof(T) == 4 && NT >= 8) ? 1 : 4;
#pragma unroll kUnroll
  for (int k0 = 0; k0 < depth; k0 += M::kDepth) {
    typename M::AFrag af[MT];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      if (kAK) M::template load_a_kmajor<kPaired>(af[mi], a + 16 * mi * lda + k0, lda);
      else M::load_a_mmajor(af[mi], a + k0 * lda + 16 * mi, lda);
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      typename M::BFrag bf;
      if (kBK) M::template load_b_kmajor<kPaired>(bf, b + 8 * ni * ldb + k0, ldb);
      else M::template load_b_nmajor<kPaired>(bf, b + k0 * ldb + 8 * ni, ldb);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) M::mma(acc[mi][ni], af[mi], bf);
    }
  }
}

// Two neighbouring elements (an accumulator's column pair) as floats.
__device__ inline float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ inline float2 ld_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ inline void st_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ inline void st_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A [rows_t, cols_t] tile of src (row stride ld_src) into dst (row stride
// ld_dst), zero beyond rows_valid x cols_valid.  16-byte cp.async where it
// can, scalar loads elsewhere; the caller waits (cp_async_wait_all) and
// synchronises before anyone reads.  cols_t is a multiple of 16 bytes.
template <typename T>
__device__ inline void load_tile_async(T* dst, int ld_dst, const T* src,
                                       size_t ld_src, int rows_t, int cols_t,
                                       int rows_valid, int cols_valid) {
  constexpr int V = 16 / sizeof(T);
  const bool vec_ok = (reinterpret_cast<size_t>(src) % 16 == 0) &&
                      ((ld_src * sizeof(T)) % 16 == 0);
  const int chunks = cols_t / V;
  for (int idx = threadIdx.x; idx < rows_t * chunks; idx += blockDim.x) {
    const int r = idx / chunks, c = (idx % chunks) * V;
    T* d = dst + r * ld_dst + c;
    if (vec_ok && r < rows_valid && c + V <= cols_valid) {
      cp_async16(d, src + r * ld_src + c);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        d[v] = (r < rows_valid && c + v < cols_valid) ? src[r * ld_src + c + v]
                                                      : T(0.f);
    }
  }
}

// T_{k+1} at two neighbouring coordinates from lt = (L T_k), cur = T_k,
// prev = T_{k-1} there, with next_term's rounding points.
template <typename T>
__device__ inline float2 laguerre_step2(float2 lt, float2 cur, float2 prev, int k) {
  using R = Io<T>;
  const float2 v = R::round2(lt);
  if (k == 0) return R::round2(make_float2(cur.x - v.x, cur.y - v.y));
  const float kf = (float)k, a = 2.f * kf + 1.f, d = kf + 1.f;
  const float2 ac = R::round2(make_float2(a * cur.x, a * cur.y));
  float2 s = R::round2(make_float2(ac.x - v.x, ac.y - v.y));
  const float2 kp = R::round2(make_float2(kf * prev.x, kf * prev.y));
  s = R::round2(make_float2(s.x - kp.x, s.y - kp.y));
  return R::round2(make_float2(R::div(s.x, d), R::div(s.y, d)));
}

// w [n] float32 -> wt [n] in T: the kernels take W in x's type.
template <typename T>
__global__ void cast_w_kernel(const float* __restrict__ w, T* __restrict__ wt,
                              size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) Io<T>::store(wt, i, w[i]);
}

}  // namespace
