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
// L streams from device memory, one launch a recurrence step: each step
// needs the whole of T_k (every row of L·T_k reads all of it), so T_k lives
// in device memory and the kernel boundary is the step's barrier.
//
// band_step_kernel: the recurrence step of all four entry points (kernels 2
// and 4 are nothing else; kernels 1 and 3 run it before their products).
// It forms lt = L·V for V = T_k (forward) or b̄_kk (the adjoint walk, which
// reads L where the math has Lᵀ, as the plain version and the TPU kernel
// do) and applies the step's combine: T_{k+1} from lt, T_k and T_{k-1}
// (laguerre_step_pair); the walk's updates of b̄_{kk-1} and b̄_{kk-2} in
// place; dx = b̄_0 + b̄_1 − lt at the end.
//
// What bounds it.  A step is 2·G·S²·C operations on G·S² elements of L.  At
// the brain's level-0 L1 (S = 8997, C = 512): 82.9 GFLOP, 0.084 ms in
// bfloat16 at 989 TFLOP/s and 0.502 ms in float32 as three TF32 products
// (165 TFLOP/s), against L's 162 MB in bfloat16 (0.048 ms at 3.35 TB/s) and
// its TF32 halves' 648 MB in float32 (0.193 ms): operations.  At C = 128 the
// operations fall to a quarter (0.021 / 0.126 ms) and L's bytes bound the
// step (0.048 ms bfloat16; 0.193 ms float32 as the halves, 0.097 as L), so
// L must come from device memory once a step, not once a slice of
// channels.  Every row tile also reads all of T_k (9.2 MB at C = 512 in
// bfloat16) from L2.
//
// Design, and what each choice does about that:
// * The product is formed transposed, ltᵀ [C, rows] = Vᵀ · Lᵀ, on wgmma
//   with L as the K-major B operand: Lᵀ stored K-major is L's rows as
//   stored, so the TMA tile of L feeds the tensor core untouched and no
//   symmetry of L is assumed.  M = 64 channels a wgmma, N = 64 to 128 rows,
//   a depth chunk one 128-byte swizzle row (64 bfloat16, 32 float32).
// * bfloat16: both operands from shared memory, Vᵀ M-major straight from
//   the T tile as TMA stores it; a warpgroup keeps one wgmma group in flight
//   and hands the stage before it back to the producer.  float32: TF32
//   wgmma takes both operands only K-major, so Vᵀ comes from registers, read
//   from the T tile and split once per element and tile into hi =
//   tf32(v), lo = tf32(v − hi) (laguerre_common.cuh's split); L's halves
//   are prepared once per operator by the caller (hi = tf32(L), lo = L −
//   hi exactly, so hi + lo is L; the tensor core reads lo's top 10 mantissa
//   bits): no split in the loop, at twice L's bytes.  Each chunk's three
//   products lo·hi, hi·lo, hi·hi go to a fresh accumulator that is added to
//   the running sum with a float add: the tensor core's own accumulation
//   truncates, so it never carries more than one chunk (12 wgmma).
// * A CTA is 1, 2 or 4 consumer warpgroups and one producer warp.  The
//   producer keeps 4 stages of (L tile, T tile) in flight by TMA (128-byte
//   swizzle, zeros past S and C), signalled by mbarriers; the consumers run
//   wgmma on the stage that has arrived and release it.  The accumulators
//   stay in registers over the whole depth.
// * L's reads a step, by count: each L tile is requested by the
//   ceil(C / cols) CTAs of its row tile (4 at S = 8997, C = 512 with
//   96 x 128 tiles; 1 where one tile spans C), which are consecutive in
//   launch order (channel tiles innermost) and start together.  L2 (50 MB)
//   can hold every tile in flight (at most 132 CTAs x 4 stages x 32 KB =
//   17 MB) until all of them have read it, so that device memory would
//   supply each tile once a step and L2 the other requests; that is argued
//   from launch order and L2's size, not counted: no DRAM counter could be
//   read on the machine the kernel was measured on.  A thread-block cluster
//   that multicast each L tile to the CTAs sharing it (its first CTA
//   loading the tile, or each CTA a slice) would make it one read by
//   construction; in sweeps on an H100, whose times were not kept, it ran
//   slower than these plain loads at these shapes (the cluster waits for
//   its slowest CTA at every stage), and it was dropped.
// * The tile: 64 x 64 for C <= 64; else, of 64 x 64, 64 x 128, 96 x 128,
//   and 128 x 128 in float32 or 256 x 128 (four warpgroups) in bfloat16,
//   the one with the least work on the busiest SM, ceil(CTAs / SMs) tiles
//   weighted by (1 + 128/rows + 64/cols), fitted to the times measured at
//   the brain's shapes.  Each of these is the choice at some band shape
//   that chip_smoke.py launches (its [band] lines); it keeps C = 64 (G =
//   41, S = 256) off a wide tile and takes S = 8997, C = 512 in three
//   rounds of 96-row tiles (2.85 waves) rather than three of 128-row ones
//   (2.15 waves).
// * The combine goes through shared memory: the accumulators are stored as
//   the [rows][cols] tile, then each thread takes four neighbouring channels
//   of a row, so T's rows are read and written along their length.
// * No atomics: every output element is written once, by one thread, and
//   the depth is summed in a fixed order, so a second launch gives the same
//   bits.

// The other kernels (one launch each) keep the file's first design: a 128 x 64 output
// tile a block of 8 warps, 32 x 32 a warp, A and B streamed through shared
// memory in depth chunks of 32 by a two-stage cp.async ring, the fragments
// and the 3xTF32 / bf16 mma.sync of laguerre_common.cuh.
// * band_out_kernel (fused forward): out = Σ_k T_k W_k + b, one product of
//   depth K·C over the terms, summed in f32 and rounded once with the bias.
// * band_bar_kernel (fused backward): b̄_k = g W_kᵀ for every k, rounded to
//   x's type; the adjoint walk then runs as in the terms backward.
// * band_dw_kernel / band_db_kernel (fused backward): per-slice partial sums
//   of dW_k = T_kᵀ g and db = Σ g over contiguous runs of graph blocks, in
//   f32; reduce_partials_kernel adds the slices in slice order.
// The terms of a fused call go to a scratch buffer [K−1, G, S, C] in x's
// type that the caller allocates (b̄ likewise, [K, G, S, C]).  TMA needs
// 16-byte strides: L's rows lie ldl >= S elements apart with ldl·size a
// multiple of 16 (graph blocks S·ldl apart), C·size is a multiple of 16,
// and x, the scratch buffers and L start on 16 bytes; the caller pads (with
// K = 1 no step runs and none of this applies).
//
// Rounding follows the S <= 128 kernels: L and W in x's type; each L·V and
// each g W_kᵀ accumulated in f32 and rounded to x's type; the combine in
// x's arithmetic (Pair<T>); the output sums in f32 plus the f32 bias
// rounded once; dW and db in f32.

#include "laguerre_common.cuh"

namespace {

using u64 = unsigned long long;

// A TMA tensor map (cuda.h's CUtensorMap: 128 opaque bytes on 64) and the
// values of cuda.h's enums that its encoder takes, declared here so that the
// source needs the runtime's headers alone; the encoder itself is fetched
// through the runtime (cudaGetDriverEntryPoint), no libcuda link.
struct alignas(64) TensorMap {
  u64 opaque[16];
};
constexpr int kMapFloat32 = 7, kMapBfloat16 = 9;  // CU_TENSOR_MAP_DATA_TYPE_*
constexpr int kMapInterleaveNone = 0, kMapSwizzle128B = 3, kMapL2Promote256B = 3,
              kMapOobFillZeros = 0;

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

// ---------------------------------------------------------------------------
// the recurrence step: TMA, mbarriers, wgmma
// ---------------------------------------------------------------------------

enum StepMode { kForward = 0, kWalk = 1, kLast = 2 };

__device__ inline void mbar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` more from the TMA loads of this phase.
__device__ inline void mbar_expect_tx(u64* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ inline void mbar_arrive(u64* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Until the phase of parity `parity` has completed.
__device__ inline void mbar_wait(u64* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// The box of `map` at (c0, c1, c2) into dst, completing on bar.
__device__ inline void tma_load(void* dst, const TensorMap* map, u64* bar, int c0, int c1,
                                int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<u64>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// A barrier of the consumer warps alone (named barrier 1; the producer
// warp, past its loop, takes no part).
template <int kThreadsN>
__device__ inline void consumers_sync_n() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreadsN) : "memory");
}

__device__ inline void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma that owns them.
template <int N>
__device__ inline void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma's shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (the tile starts on 1024
// bytes; a step along the depth adds 32 bytes to the start).
__device__ inline u64 sw128_desc(unsigned addr) {
  return (u64)((addr & 0x3FFFF) >> 4) | ((u64)1 << 16) | ((u64)(1024 >> 4) << 32) |
         ((u64)1 << 62);
}

// d[m64 x N] (+)= a[m64 x k8] · B(desc)[k8 x N] in TF32, A from registers (a
// warp's 16 rows as mma.sync's A fragment), B K-major; scale_d = 0
// overwrites d.
__device__ inline void wgmma_tf32_n64(float (&d)[32], const unsigned (&a)[4], u64 desc,
                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ inline void wgmma_tf32_n128(float (&d)[64], const unsigned (&a)[4], u64 desc,
                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d[m64 x N] (+)= A(desc)[m64 x k16] · B(desc)[k16 x N] in bfloat16, A
// M-major (the T tile as TMA stores it), B K-major; scale_d = 0 overwrites d.
__device__ inline void wgmma_bf16_ss_n64(float (&d)[32], u64 a, u64 b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ inline void wgmma_bf16_ss_n128(float (&d)[64], u64 a, u64 b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ inline void wgmma_tf32_n96(float (&d)[48], const unsigned (&a)[4], u64 desc,
                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ inline void wgmma_bf16_ss_n96(float (&d)[48], u64 a, u64 b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int kN>
struct Wgmma;
template <>
struct Wgmma<64> {
  __device__ static void tf32(float (&d)[32], const unsigned (&a)[4], u64 b, int sc) {
    wgmma_tf32_n64(d, a, b, sc);
  }
  __device__ static void bf16(float (&d)[32], u64 a, u64 b, int sc) {
    wgmma_bf16_ss_n64(d, a, b, sc);
  }
};
template <>
struct Wgmma<96> {
  __device__ static void tf32(float (&d)[48], const unsigned (&a)[4], u64 b, int sc) {
    wgmma_tf32_n96(d, a, b, sc);
  }
  __device__ static void bf16(float (&d)[48], u64 a, u64 b, int sc) {
    wgmma_bf16_ss_n96(d, a, b, sc);
  }
};
template <>
struct Wgmma<128> {
  __device__ static void tf32(float (&d)[64], const unsigned (&a)[4], u64 b, int sc) {
    wgmma_tf32_n128(d, a, b, sc);
  }
  __device__ static void bf16(float (&d)[64], u64 a, u64 b, int sc) {
    wgmma_bf16_ss_n128(d, a, b, sc);
  }
};
// The step kernel's tiles.  kWr x kWc consumer warpgroups: warpgroup (wr,
// wc) owns rows [wr·kN, +kN) of the CTA's tile (wgmma's N) and kMb blocks
// of 64 channels from wc·64·kMb (wgmma's M); the CTA's tile is kWr·kN rows
// x 64·kMb·kWc channels, depth chunks of one 128-byte row.  A stage holds
// the L tile (float32: its hi and lo halves) [kWr·kN][128 B] and the T tile
// as boxes of [depth][128 B] (64 bfloat16 or 32 float32 channels each),
// every piece on 1024 bytes.
template <typename T, int kWr, int kWc, int kMb, int kN>
struct StepTile {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kDepth = 128 / sizeof(T);
  static constexpr int kRows = kWr * kN;
  static constexpr int kCols = 64 * kMb * kWc;
  static constexpr int kLBox = kN * 128;  // one warpgroup's rows of one L array
  static constexpr int kLTile = kRows * 128;
  static constexpr int kLBytes = kLTile * (kF32 ? 2 : 1);
  static constexpr int kBoxCols = 128 / sizeof(T);
  static constexpr int kBoxBytes = kDepth * 128;
  static constexpr int kBoxes = kCols / kBoxCols;
  static constexpr int kStageBytes = kLBytes + kBoxes * kBoxBytes;
  static constexpr int kStages = 4;
  static constexpr int kConsumers = kWr * kWc;
  static constexpr int kThreads = 128 * kConsumers + 32;  // consumers, then the producer warp
  static constexpr size_t kSmem = (size_t)kStages * kStageBytes + 1024;  // + alignment
  static constexpr int kAcc = kN / 2;  // accumulator floats a thread and m-block
  static_assert((size_t)kStages * kStageBytes + 2048 <= 227 * 1024, "too many stages");
  static_assert((size_t)kRows * (kCols + 4) * 4 <= (size_t)kStages * kStageBytes,
                "the combine's tile does not fit in the stages");
};

// One recurrence step on rows [blockIdx.y·kRows, +kRows) x channels
// [blockIdx.x·kCols, +kCols) of graph block blockIdx.z: lt = L · V (V
// [G,S,C], l_map over L or its TF32 hi half, lo_map over the lo half), then
// by `mode`
//   kForward (step k):  out = T_{k+1} from lt, T_k = V and T_{k-1} = x1;
//   kWalk (step kk):    x1 = b̄_{kk-1} += (−lt + (2j+1) b̄_kk)/(j+1) and
//                       x2 = b̄_{kk-2} −= j/(j+1) b̄_kk, j = kk − 1, V = b̄_kk;
//   kLast:              out = dx = x1 (b̄_0) + V (b̄_1) − lt.
template <typename T, int kWr, int kWc, int kMb, int kN>
__global__ void __launch_bounds__(StepTile<T, kWr, kWc, kMb, kN>::kThreads, 1)
    band_step_kernel(const __grid_constant__ TensorMap l_map,
                     const __grid_constant__ TensorMap lo_map,
                     const __grid_constant__ TensorMap v_map, const T* __restrict__ v,
                     T* __restrict__ x1, T* __restrict__ x2, T* __restrict__ out, int S, int C,
                     int k, int mode) {
  using Tl = StepTile<T, kWr, kWc, kMb, kN>;
  using P = Pair<T>;
  using V = typename P::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) u64 full[Tl::kStages], empty[Tl::kStages];
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.z, row0 = blockIdx.y * Tl::kRows, col0 = blockIdx.x * Tl::kCols;
  const int chunks = (S + Tl::kDepth - 1) / Tl::kDepth;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Tl::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * Tl::kConsumers);  // every consumer warp releases a stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * Tl::kConsumers) {
    // producer: one thread keeps the stages in flight
    if (lane == 0) {
      for (int it = 0; it < chunks; ++it) {
        const int st = it % Tl::kStages;
        mbar_wait(&empty[st], ((it / Tl::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], Tl::kStageBytes);
        unsigned char* stage = smem + st * Tl::kStageBytes;
        const int k0 = it * Tl::kDepth;
        tma_load(stage, &l_map, &full[st], k0, row0, g);
        if (Tl::kF32) tma_load(stage + Tl::kLTile, &lo_map, &full[st], k0, row0, g);
        for (int b = 0; b < Tl::kBoxes; ++b)
          tma_load(stage + Tl::kLBytes + b * Tl::kBoxBytes, &v_map, &full[st],
                   col0 + b * Tl::kBoxCols, k0, g);
      }
    }
  } else {
    // consumers: warpgroup (wr, wc); its warp q holds channels 16 q + gid
    // (+8) of each m-block; accumulator element (channel m, row n)
    const int w = warp >> 2, wr = w / kWc, wc = w % kWc;
    const int q = warp & 3, gid = lane >> 2, tig = lane & 3;
    const int ch0 = wc * 64 * kMb;  // the warpgroup's first channel in the tile
    float acc[kMb][Tl::kAcc];
#pragma unroll
    for (int mb = 0; mb < kMb; ++mb)
#pragma unroll
      for (int i = 0; i < Tl::kAcc; ++i) acc[mb][i] = 0.f;
    // a stage goes back to the producer once every warp is done with it
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    };
    for (int it = 0; it < chunks; ++it) {
      const int st = it % Tl::kStages;
      mbar_wait(&full[st], (it / Tl::kStages) & 1);
      const unsigned char* stage = smem + st * Tl::kStageBytes;
      const unsigned l_addr = smem_addr(stage) + wr * Tl::kLBox;
      const unsigned char* boxes = stage + Tl::kLBytes;
      if constexpr (Tl::kF32) {
        // Vᵀ fragments (m = 16q + gid (+8), k = tig (+4)) split into TF32
        // halves: box c / 32 holds channel c, its 16-byte chunk c % 32 / 4 of
        // row k swizzled with k % 8
#pragma unroll
        for (int mb = 0; mb < kMb; ++mb) {
          unsigned ah[4][4], al[4][4];
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int m = ch0 + 64 * mb + 16 * q + gid + 8 * (r & 1);
              const int kr = 8 * ks + tig + 4 * (r >> 1), cc = m & 31;
              const float val = *reinterpret_cast<const float*>(
                  boxes + (m >> 5) * Tl::kBoxBytes + kr * 128 +
                  ((((cc >> 2) ^ (kr & 7)) << 4) | ((cc & 3) << 2)));
              split_tf32(val, ah[ks][r], al[ks][r]);
            }
          float part[Tl::kAcc];
          fence_regs(part);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const u64 hi = sw128_desc(l_addr + 32 * ks);
            const u64 lo = sw128_desc(l_addr + Tl::kLTile + 32 * ks);
            Wgmma<kN>::tf32(part, al[ks], hi, ks > 0);
            Wgmma<kN>::tf32(part, ah[ks], lo, 1);
            Wgmma<kN>::tf32(part, ah[ks], hi, 1);
          }
          wgmma_commit();
          wgmma_wait0();
          fence_regs(part);
#pragma unroll
          for (int i = 0; i < Tl::kAcc; ++i) acc[mb][i] += part[i];
        }
      } else {
        // Vᵀ straight from the T tile: M-major, 128-byte swizzle, 8-row
        // groups 1024 bytes apart, a k-step 16 rows (2048 bytes) on
#pragma unroll
        for (int mb = 0; mb < kMb; ++mb) fence_regs(acc[mb]);
        wgmma_fence();
        const unsigned a_addr = smem_addr(boxes) + ((ch0 >> 6) * Tl::kBoxBytes);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int mb = 0; mb < kMb; ++mb)
            Wgmma<kN>::bf16(acc[mb], sw128_desc(a_addr + mb * Tl::kBoxBytes + 2048 * ks),
                            sw128_desc(l_addr + 32 * ks), 1);
        wgmma_commit();
        // one group stays in flight: the previous stage is done and goes back
        wgmma_wait1();
#pragma unroll
        for (int mb = 0; mb < kMb; ++mb) fence_regs(acc[mb]);
        if (it > 0) release((it - 1) % Tl::kStages);
        continue;
      }
      release(st);
    }
    if constexpr (!Tl::kF32) {
      wgmma_wait0();
#pragma unroll
      for (int mb = 0; mb < kMb; ++mb) fence_regs(acc[mb]);
      if (chunks > 0) release((chunks - 1) % Tl::kStages);
    }

    // the step's combine, through shared memory: the warpgroups store their
    // accumulators as the tile [rows][cols + 4] of floats (acc[mb][4 j + 2 h
    // + e] is channel 16 q + gid + 8 h of m-block mb, row 8 j + 2 tig + e of
    // the warpgroup's rows), then each thread takes 4 neighbouring channels
    // of a row, so T's rows are read and written along their length
    const auto consumers_sync = [] { consumers_sync_n<128 * Tl::kConsumers>(); };
    consumers_sync();  // every warpgroup is done with the stages
    float* tile = reinterpret_cast<float*>(smem);
    constexpr int kLd = Tl::kCols + 4;  // 4 mod 32 words: the stores hit 32 banks
#pragma unroll
    for (int mb = 0; mb < kMb; ++mb)
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            tile[(wr * kN + 8 * j + 2 * tig + e) * kLd + ch0 + 64 * mb + 16 * q + gid + 8 * h] =
                acc[mb][4 * j + 2 * h + e];
    consumers_sync();
    const size_t blk = (size_t)g * S * C;
    const float jf = (float)(k - 1), a2 = 2.f * jf + 1.f, d = jf + 1.f;
    const float coef = Io<T>::round(jf / d);
    constexpr int kQuads = Tl::kCols / 4;
    for (int idx = threadIdx.x; idx < Tl::kRows * kQuads; idx += 128 * Tl::kConsumers) {
      const int row = idx / kQuads, c4 = (idx % kQuads) * 4;
      const int r = row0 + row, c = col0 + c4;
      if (r >= S || c >= C) continue;  // C is a multiple of 4: a quad lies inside
      const float4 lt = *reinterpret_cast<const float4*>(tile + row * kLd + c4);
      const float lts[4] = {lt.x, lt.y, lt.z, lt.w};
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const size_t i = blk + (size_t)r * C + c + 2 * p;
        const V cur = P::ld(v + i), lv = P::of(lts[2 * p], lts[2 * p + 1]);
        if (mode == kForward) {
          const V prev = k > 0 ? P::ld(x1 + i) : P::of(0.f, 0.f);
          P::st(out + i, laguerre_step_pair<T>(lts[2 * p], lts[2 * p + 1], cur, prev, k));
        } else if (mode == kWalk) {
          P::st(x1 + i, P::add(P::ld(x1 + i), P::div(P::sub(P::mul(a2, cur), lv), d)));
          P::st(x2 + i, P::sub(P::ld(x2 + i), P::mul(coef, cur)));
        } else {
          P::st(out + i, P::sub(P::add(P::ld(x1 + i), cur), lv));
        }
      }
    }
  }
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

#define STEP_TRY(expr)                          \
  do {                                          \
    const cudaError_t e_ = (expr);              \
    if (e_ != cudaSuccess) return e_;           \
  } while (0)

using EncodeTiled = int (*)(TensorMap*, int, unsigned, void*, const u64*, const u64*,
                            const unsigned*, const unsigned*, int, int, int, int);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A TMA map over a [d2][d1][d0] array (d0 innermost; d1 rows s1 bytes apart,
// d2 blocks s2 bytes apart), boxes of b0 x b1 x 1 with 128-byte swizzle;
// reads past the array give zeros.
cudaError_t make_map(TensorMap* map, const void* base, bool bf16, u64 d0, u64 d1, u64 d2,
                     u64 s1, u64 s2, unsigned b0, unsigned b1) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const u64 dims[3] = {d0, d1, d2};
  const u64 strides[2] = {s1, s2};
  const unsigned box[3] = {b0, b1, 1};
  const unsigned unit[3] = {1, 1, 1};
  const int r = encode(map, bf16 ? kMapBfloat16 : kMapFloat32, 3, const_cast<void*>(base), dims,
                       strides, box, unit, kMapInterleaveNone, kMapSwizzle128B,
                       kMapL2Promote256B, kMapOobFillZeros);
  return r == 0 ? cudaSuccess : cudaErrorInvalidValue;  // CUDA_SUCCESS
}

template <int kWr_, int kWc_, int kMb_, int kN_>
struct Variant {
  static constexpr int kWr = kWr_, kWc = kWc_, kMb = kMb_, kN = kN_;
};

// The step kernels T has, by index: (warpgroups along rows, along
// channels, 64-channel blocks a warpgroup, rows a warpgroup).
template <typename T, typename F>
cudaError_t with_variant(int id, F&& f) {
  if constexpr (sizeof(T) == 2) {
    switch (id) {
      case 0: return f(Variant<1, 1, 1, 64>{});   // 64 x 64
      case 1: return f(Variant<1, 2, 1, 64>{});   // 64 x 128
      case 2: return f(Variant<2, 2, 1, 128>{});  // 256 x 128
      case 3: return f(Variant<1, 2, 1, 96>{});   // 96 x 128
    }
  } else {
    switch (id) {
      case 0: return f(Variant<1, 1, 1, 64>{});   // 64 x 64
      case 1: return f(Variant<1, 2, 1, 64>{});   // 64 x 128
      case 2: return f(Variant<1, 2, 1, 128>{});  // 128 x 128
      case 3: return f(Variant<1, 2, 1, 96>{});   // 96 x 128
    }
  }
  return cudaErrorInvalidValue;
}

struct StepPlan {
  dim3 grid;
  int threads = 0, variant = 0, rows = 0, cols = 0, regs = 0, per_sm = 0, sms = 0;
  size_t smem = 0;
};

template <typename T, typename Var>
cudaError_t step_plan(int G, int S, int C, StepPlan& p) {
  using Tl = StepTile<T, Var::kWr, Var::kWc, Var::kMb, Var::kN>;
  const auto kernel = band_step_kernel<T, Var::kWr, Var::kWc, Var::kMb, Var::kN>;
  static int per_sm = -1, regs = -1, sms = -1;
  if (per_sm < 0) {
    STEP_TRY(allow_smem(kernel, Tl::kSmem));
    int n = 0, dev = 0;
    STEP_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, Tl::kThreads, Tl::kSmem));
    cudaFuncAttributes fa;
    STEP_TRY(cudaFuncGetAttributes(&fa, kernel));
    STEP_TRY(cudaGetDevice(&dev));
    STEP_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    regs = fa.numRegs;
    per_sm = n;
  }
  p.grid = dim3((C + Tl::kCols - 1) / Tl::kCols, (S + Tl::kRows - 1) / Tl::kRows, G);
  p.threads = Tl::kThreads;
  p.rows = Tl::kRows;
  p.cols = Tl::kCols;
  p.smem = Tl::kSmem;
  p.regs = regs;
  p.per_sm = per_sm;
  p.sms = sms;
  return cudaSuccess;
}

template <typename T>
cudaError_t plan_variant(int id, int G, int S, int C, StepPlan& p) {
  p.variant = id;
  return with_variant<T>(id, [&](auto var) { return step_plan<T, decltype(var)>(G, S, C, p); });
}

// The step's tile: 64 x 64 for C <= 64; else the variant with the least
// work on the busiest SM, ceil(CTAs / SMs) tiles of rows x cols, each
// weighted by (1 + 128/rows + 64/cols) for what a smaller tile spends on
// its edges, a row tile costing more (each re-reads all of T_k) (fitted
// to times measured on an H100 at the brain's shapes); the larger tile on
// a tie.
template <typename T>
cudaError_t choose_step(int G, int S, int C, StepPlan& best) {
  if (C <= 64) return plan_variant<T>(0, G, S, C, best);
  double best_cost = -1.0;
  for (int id = 0;; ++id) {
    StepPlan p;
    const cudaError_t e = plan_variant<T>(id, G, S, C, p);
    if (e == cudaErrorInvalidValue) break;  // no more variants for T
    STEP_TRY(e);
    if (p.per_sm < 1) continue;
    const long ctas = (long)p.grid.x * p.grid.y * p.grid.z;
    const double area = (double)p.rows * p.cols;
    const double cost =
        (double)((ctas + p.sms - 1) / p.sms) * area * (1.0 + 128.0 / p.rows + 64.0 / p.cols);
    if (best_cost < 0 || cost < best_cost ||
        (cost == best_cost && area > (double)best.rows * best.cols)) {
      best_cost = cost;
      best = p;
    }
  }
  return best_cost < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// One recurrence step (band_step_kernel) over G blocks: l is L [G,S,ldl] in
// bfloat16, or in float32 its TF32 halves [2,G,S,ldl] (hi, then lo).
template <typename T>
cudaError_t launch_step(const T* l, const T* v, T* x1, T* x2, T* out, int G, int S, int ldl,
                        int C, int k, int mode, cudaStream_t stream) {
  constexpr bool bf16 = sizeof(T) == 2;
  const size_t es = sizeof(T);
  if ((ldl * es) % 16 != 0 || (C * es) % 16 != 0 || reinterpret_cast<size_t>(l) % 16 != 0 ||
      reinterpret_cast<size_t>(v) % 16 != 0 || ldl < S)
    return cudaErrorInvalidValue;
  StepPlan p;
  STEP_TRY(choose_step<T>(G, S, C, p));
  return with_variant<T>(p.variant, [&](auto var) {
    using Var = decltype(var);
    using Tl = StepTile<T, Var::kWr, Var::kWc, Var::kMb, Var::kN>;
    TensorMap lm, lom, vm;
    const u64 l_row = (u64)ldl * es, l_blk = (u64)S * ldl * es;
    STEP_TRY(make_map(&lm, l, bf16, S, S, G, l_row, l_blk, Tl::kDepth, Tl::kRows));
    if (bf16) lom = lm;
    else STEP_TRY(make_map(&lom, l + (size_t)G * S * ldl, bf16, S, S, G, l_row, l_blk,
                           Tl::kDepth, Tl::kRows));
    STEP_TRY(make_map(&vm, v, bf16, C, S, G, (u64)C * es, (u64)S * C * es,
                      Tl::kBoxCols, Tl::kDepth));
    band_step_kernel<T, Var::kWr, Var::kWc, Var::kMb, Var::kN>
        <<<p.grid, Tl::kThreads, Tl::kSmem, stream>>>(lm, lom, vm, v, x1, x2, out, S, C, k, mode);
    return cudaGetLastError();
  });
}

// T_1 .. T_{K-1} from T_0 = x: term k + 1 into term_out(k + 1).
template <typename T, typename TermFn>
cudaError_t run_recurrence(const T* l, TermFn term, int G, int S, int ldl, int C, int K,
                           cudaStream_t stream) {
  for (int k = 0; k + 1 < K; ++k)
    STEP_TRY(launch_step<T>(l, term(k), const_cast<T*>(k > 0 ? term(k - 1) : nullptr), nullptr,
                            const_cast<T*>(term(k + 1)), G, S, ldl, C, k, kForward, stream));
  return cudaSuccess;
}

// The adjoint walk over bar(0) .. bar(K-1), in place, then dx.
template <typename T, typename BarFn>
cudaError_t run_walk(const T* l, BarFn bar, T* dx, int G, int S, int ldl, int C, int K,
                     cudaStream_t stream) {
  for (int kk = K - 1; kk > 1; --kk)
    STEP_TRY(launch_step<T>(l, bar(kk), bar(kk - 1), bar(kk - 2), nullptr, G, S, ldl, C, kk,
                            kWalk, stream));
  if (K > 1)
    return launch_step<T>(l, bar(1), bar(0), nullptr, dx, G, S, ldl, C, 1, kLast, stream);
  return cudaMemcpyAsync(dx, bar(0), (size_t)G * S * C * sizeof(T), cudaMemcpyDeviceToDevice,
                         stream);
}

template <typename T>
int step_plan_of(int G, int S, int C, int* out) {
  StepPlan p;
  BAND_TRY(choose_step<T>(G, S, C, p));
  const int v[10] = {(int)p.grid.x, (int)p.grid.y, (int)p.grid.z, p.threads, (int)p.smem,
                     p.regs, p.per_sm, p.sms, p.rows, p.cols};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
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

// Every entry point takes L as the band operator the caller prepares once:
// in bfloat16 L [G,S,ldl], in float32 its TF32 halves [2,G,S,ldl] (hi =
// tf32(L), then lo = L − hi); ldl >= S with ldl·size a multiple of 16 bytes.
// C·size is a multiple of 16 bytes and x, dt, the scratch buffers and L
// start on 16 bytes (cudaErrorInvalidValue otherwise).
//
// l (row stride ldl), x [G,S,C], out [G,S,F] in x's dtype (bf16 !=
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

// l (row stride ldl), x [G,S,C] -> t [K,G,S,C], all in x's dtype.
int hlhgat_band_terms_fwd(const void* l, const void* x, void* t, int G, int S, int ldl, int C,
                          int K, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? band_terms_fwd<__nv_bfloat16>(l, x, t, G, S, ldl, C, K, s)
              : band_terms_fwd<float>(l, x, t, G, S, ldl, C, K, s);
}

// Number of graph-block slices of the dW/db partial sums: the caller
// allocates partial [n_split, K*C*F + F] float32.
int hlhgat_band_fused_bwd_splits(int G, int C, int F, int K) { return band_splits(G, C, F, K); }

// l (row stride ldl), x [G,S,C], g [G,S,F], dx [G,S,C] in x's
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

// l (row stride ldl), dt [K,G,S,C] -> dx [G,S,C], all in dt's
// dtype; bars: scratch [K-1,G,S,C] (unused when K = 1).
int hlhgat_band_terms_bwd(const void* l, const void* dt, void* dx, void* bars, int G, int S,
                          int ldl, int C, int K, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? band_terms_bwd<__nv_bfloat16>(l, dt, dx, bars, G, S, ldl, C, K, s)
              : band_terms_bwd<float>(l, dt, dx, bars, G, S, ldl, C, K, s);
}

// The step kernel's launch for G blocks of S rows and C channels (bf16 !=
// 0: bfloat16): out[0..9] = grid x, y, z, threads, dynamic shared bytes,
// registers a thread, CTAs an SM holds at once, SMs, rows and channels a
// tile.  Returns a cudaError_t.
int hlhgat_band_step_plan(int G, int S, int C, int bf16, int* out) {
  return bf16 ? step_plan_of<__nv_bfloat16>(G, S, C, out) : step_plan_of<float>(G, S, C, out);
}


const char* hlhgat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
