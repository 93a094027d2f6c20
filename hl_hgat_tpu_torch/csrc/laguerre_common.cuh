// Shared pieces of the dense-block Laguerre kernels (forward and backward).
// Included by laguerre_dense.cu and laguerre_dense_bwd.cu; every function is
// inlined into its kernel.
//
// Io<T>: the dtype helpers with the JAX kernels' rounding points.  Then the
// tensor-core primitives of all four Laguerre kernels, whose operands sit in
// shared memory in their own type:
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
//   Tiles leave shared memory the same way (store_tile): 16-byte stores along
//   rows where the destination allows, scalar stores elsewhere.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;  // blocks of the elementwise kernels

template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static float load(const float* p, size_t i) { return p[i]; }
  __device__ static void store(float* p, size_t i, float v) { p[i] = v; }
  __device__ static float round(float v) { return v; }
  __device__ static float div(float a, float b) { return a / b; }
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
};

// ---------------------------------------------------------------------------
// tensor-core primitives
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 512;  // 16 warps: the fused kernels' blocks

__host__ __device__ inline int pad32(int s) { return (s + 31) & ~31; }

// Tiling of the terms kernels: a block owns one graph block and a slice of
// kTermsCT = 32 channels (16 and 64 measured slower in both types), its
// warps sit 4 along the rows (32 each) and kWn (forward) or kWnb (backward)
// along the slice, so a warp owns 32 rows x 32 / kWn channels.  These were
// the fastest layouts measured on an H100 (PERF.md, kernels 2 and 4).
constexpr int kTermsCT = 32;
template <typename T>
struct TermsTile;
template <>
struct TermsTile<__nv_bfloat16> {
  static constexpr int kWn = 2, kWnb = 1;
};
template <>
struct TermsTile<float> {
  static constexpr int kWn = 2, kWnb = 2;
};

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

// Shared memory of a terms kernel's block, forward and backward alike: L
// and two [S, ct] tiles in T.
template <typename T>
size_t terms_smem_bytes(int S) {
  const int sp = pad32(S);
  return sizeof(T) * ((size_t)sp * (sp + Mma<T>::kPadK) +
                      2 * (size_t)sp * (kTermsCT + Mma<T>::kPadN));
}

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

// The rows < rows_valid, columns < cols_valid of a [*, cols_t] shared tile src
// (row stride ld_src) out to dst (row stride ld_dst): 16-byte stores along
// rows where dst and its row stride are 16-byte aligned and the chunk lies
// inside the array, scalar stores elsewhere.  The caller has synchronised
// after the tile's last write.  cols_t is a multiple of 16 bytes.
template <typename T>
__device__ inline void store_tile(T* dst, size_t ld_dst, const T* src,
                                  int ld_src, int rows_valid, int cols_t,
                                  int cols_valid) {
  constexpr int V = 16 / sizeof(T);
  const bool vec_ok = (reinterpret_cast<size_t>(dst) % 16 == 0) &&
                      ((ld_dst * sizeof(T)) % 16 == 0);
  const int chunks = cols_t / V;
  for (int idx = threadIdx.x; idx < rows_valid * chunks; idx += blockDim.x) {
    const int r = idx / chunks, c = (idx % chunks) * V;
    const T* s = src + r * ld_src + c;
    T* d = dst + r * ld_dst + c;
    if (vec_ok && c + V <= cols_valid) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (c + v < cols_valid) d[v] = s[v];
    }
  }
}

// Two neighbouring elements of a tile (an accumulator's column pair) in T's
// own arithmetic, for every Laguerre kernel's elementwise steps: float2 for
// float; for bfloat16 the packed bf16x2 operations, each rounding once to
// bfloat16 (.rn, so never contracted into an fma).  The exact result of an
// operation on two bfloat16 values rounded once is what rounding the float
// result to bfloat16 gives, so these follow the JAX kernels' rounding points
// with two conversions a pair instead of seven.
template <typename T>
struct Pair;

template <>
struct Pair<float> {
  using V = float2;
  __device__ static V ld(const float* p) { return *reinterpret_cast<const float2*>(p); }
  __device__ static void st(float* p, V v) { *reinterpret_cast<float2*>(p) = v; }
  __device__ static V of(float a, float b) { return make_float2(a, b); }
  __device__ static V add(V a, V b) { return make_float2(a.x + b.x, a.y + b.y); }
  __device__ static V sub(V a, V b) { return make_float2(a.x - b.x, a.y - b.y); }
  __device__ static V mul(float s, V a) { return make_float2(s * a.x, s * a.y); }
  __device__ static V div(V a, float d) { return make_float2(a.x / d, a.y / d); }
};

template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  __device__ static V ld(const __nv_bfloat16* p) {
    return *reinterpret_cast<const __nv_bfloat162*>(p);
  }
  __device__ static void st(__nv_bfloat16* p, V v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = v;
  }
  __device__ static V of(float a, float b) { return __floats2bfloat162_rn(a, b); }
  __device__ static V add(V a, V b) { return __hadd2_rn(a, b); }
  __device__ static V sub(V a, V b) { return __hsub2_rn(a, b); }
  // s·a in float, rounded once, as the plain version multiplies (s need not
  // be a bfloat16): the float product is exact for the integer 2k+1 while
  // K < 2^15 and for a coefficient already rounded to bfloat16
  __device__ static V mul(float s, V a) {
    const float2 f = __bfloat1622float2(a);
    return __floats2bfloat162_rn(s * f.x, s * f.y);
  }
  __device__ static V div(V a, float d) {
    const float2 f = __bfloat1622float2(a);
    return __floats2bfloat162_rn(Io<__nv_bfloat16>::div(f.x, d),
                                 Io<__nv_bfloat16>::div(f.y, d));
  }
};

// T_{k+1} from lt = (L T_k), cur = T_k, prev = T_{k-1} at two neighbouring
// coordinates, rounded where the JAX kernel rounds.
template <typename T>
__device__ inline typename Pair<T>::V laguerre_step_pair(float lt0, float lt1,
                                                         typename Pair<T>::V cur,
                                                         typename Pair<T>::V prev,
                                                         int k) {
  using P = Pair<T>;
  const typename P::V v = P::of(lt0, lt1);
  if (k == 0) return P::sub(cur, v);
  const float kf = (float)k;
  return P::div(P::sub(P::sub(P::mul(2.f * kf + 1.f, cur), v), P::mul(kf, prev)),
                kf + 1.f);
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

// w [n] float32 -> wt [n] in T: the kernels take W in x's type.
template <typename T>
__global__ void cast_w_kernel(const float* __restrict__ w, T* __restrict__ wt,
                              size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) Io<T>::store(wt, i, w[i]);
}

}  // namespace
