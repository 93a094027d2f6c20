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

// The products of the fused entry points, one launch each, on the step
// kernel's machinery: a ring of TMA stages (128-byte swizzle, zeros past
// the arrays) filled by one producer warp and drained by one consumer
// warpgroup that runs wgmma, 64 output rows a CTA:
// * band_out_kernel (fused forward) <- the products of _fwd_kernel
//   (:97-105): out [R, F] = Σ_k T_k W_k + b over the R = G·S rows, one
//   product of depth K·C whose ring runs across the terms (A from x for k =
//   0, from the scratch ts after: two tensor maps), summed in f32, the f32
//   bias added and rounded once.  N = 64 columns for F <= 64, else 128, so
//   F = 256 takes two CTAs a row tile: a 64 x 256 float32 tile would need
//   128 accumulator registers and 128 more for the chunk's fresh
//   accumulator, and a bfloat16 stage of W 256 wide would leave one CTA an
//   SM.
// * band_bar_kernel (fused backward) <- b_list of _bwd_kernel (:149-155):
//   b̄_k = g W_kᵀ for every k, rounded to x's type; N = 64 channels, the
//   depth F, k outer and g's column chunks inner.  Where they fit (F <= 576
//   float32, 1472 bfloat16) the CTA's 64 rows of g stay in shared memory
//   while it walks k, so g is read once, not K times; past that each ring
//   stage carries g's chunk beside W_k's, so shared memory does not grow
//   with F and g's rows come from L2 K times.  Both walk the same chunks in
//   the same order through the same wgmma, so b̄ has the same bits either
//   way.  The adjoint walk then runs as in the terms backward.
// * band_dw_kernel (fused backward) <- dW and db of _bwd_kernel (:134-146):
//   partial sums of dW_k = T_kᵀ g (M = 64 channels, so C = 64 fills the
//   tile; N = 64 columns of g; the depth the rows) for two terms a CTA over
//   a fixed slice of row chunks, and db = Σ g in the CTAs of channel tile 0
//   and terms 0-1, summed from g's tile in shared memory in a fixed order;
//   band_reduce_kernel adds the slices in a fixed order.
// What bounds them.  At G = 41, S = 256, C = F = 64, K = 4 (the pooled
// path's band shape, R = 10496) band_out moves K·R·C + R·F elements: 13.4
// MB in float32, 4.0 µs at 3.35 TB/s, and 2.0 µs in bfloat16, against 0.34
// GFLOP (2.1 µs as three TF32 products at 165 TFLOP/s, 0.35 µs in
// bfloat16).  The backward's products move R·F + 2·K·R·C elements (7.2 /
// 3.6 µs) for 0.69 GFLOP (4.2 / 0.7 µs).  At S = 512 all of it doubles.
// Bytes bound them, so each term tile and each row of g comes from device
// memory once a CTA (W, at most a few hundred KB, from L2), the ring runs
// across the terms instead of draining at each, and every CTA keeps its
// loads in flight while the tensor cores stay far from their limit.  The
// out and b̄ tiles are staged in shared memory and leave by TMA stores:
// stored from the accumulators' registers, four bytes a thread, b̄ (K
// outputs a row of g) ran 2.5x slower in bfloat16 on an H100.  dW runs
// about one CTA an SM (kDwTarget), each over a slice of row chunks, with
// a deep ring; more slices or more terms a CTA measured no faster there.
// * bfloat16: both operands from shared memory, A K-major (out: T's rows;
//   bar: g's rows) or M-major (dW: T_kᵀ as T's tile lies), B K-major (bar:
//   W_k as stored) or N-major by wgmma's transpose bit (out: W_k; dW: g),
//   each N-major piece one 128-byte swizzle atom (64 columns) wide.
// * float32: TF32 wgmma takes B only K-major, A K-major from registers.
//   The caller prepares W's TF32 halves once (hi = tf32(W), lo = W − hi;
//   Wᵀ [K, F, C] for out, W [K, C, F] for bar), A is split once an element
//   in registers, and dW's B (g) is written by the consumers transposed
//   into a K-major buffer as TF32 halves once a stage, shared by the CTA's
//   terms.  Each chunk's 12 wgmma go to a fresh accumulator that is added
//   to the running sum with a float add.
// * No atomics: every output element is written once by one thread and the
//   depth is summed in a fixed order, so a second launch gives the same bits.
// The terms of a fused call go to a scratch buffer [K−1, G, S, C] in x's
// type that the caller allocates (b̄ likewise, [K, G, S, C]).  TMA needs
// 16-byte strides: L's rows lie ldl >= S elements apart with ldl·size a
// multiple of 16 (graph blocks S·ldl apart), C·size and ldf·size (the row
// stride of g, W and out, ldf >= F) are multiples of 16, and every array
// TMA reads or writes starts on 16 bytes.  The caller pads: a ragged C
// with zero channels, a ragged F with zero columns of W and g and an out
// buffer of ldf columns, F of which are written.
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

// d[m64 x N] (+)= A(desc)[m64 x k16] · B(desc)[k16 x N] in bfloat16; kTA /
// kTB: A M-major / B N-major (wgmma's transpose bits), else K-major; the
// step kernel's A is M-major (the T tile as TMA stores it), its B K-major;
// scale_d = 0 overwrites d.
template <int kTA, int kTB>
__device__ inline void wgmma_bf16_ss_n64(float (&d)[32], u64 a, u64 b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
}

template <int kTA, int kTB>
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
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
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

template <int kTA, int kTB>
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
      "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
}

template <int kN>
struct Wgmma;
template <>
struct Wgmma<64> {
  __device__ static void tf32(float (&d)[32], const unsigned (&a)[4], u64 b, int sc) {
    wgmma_tf32_n64(d, a, b, sc);
  }
  template <int kTA = 1, int kTB = 0>
  __device__ static void bf16(float (&d)[32], u64 a, u64 b, int sc) {
    wgmma_bf16_ss_n64<kTA, kTB>(d, a, b, sc);
  }
};
template <>
struct Wgmma<96> {
  __device__ static void tf32(float (&d)[48], const unsigned (&a)[4], u64 b, int sc) {
    wgmma_tf32_n96(d, a, b, sc);
  }
  template <int kTA = 1, int kTB = 0>
  __device__ static void bf16(float (&d)[48], u64 a, u64 b, int sc) {
    wgmma_bf16_ss_n96<kTA, kTB>(d, a, b, sc);
  }
};
template <>
struct Wgmma<128> {
  __device__ static void tf32(float (&d)[64], const unsigned (&a)[4], u64 b, int sc) {
    wgmma_tf32_n128(d, a, b, sc);
  }
  template <int kTA = 1, int kTB = 0>
  __device__ static void bf16(float (&d)[64], u64 a, u64 b, int sc) {
    wgmma_bf16_ss_n128<kTA, kTB>(d, a, b, sc);
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

// ---------------------------------------------------------------------------
// the products of the fused entry points: TMA ring, mbarriers, wgmma
// ---------------------------------------------------------------------------

constexpr int kBox = 64 * 128;          // a TMA box of 64 rows of 128 bytes
constexpr int kRing = 4;                // stages of band_out_kernel and band_bar_kernel
constexpr int kProdThreads = 128 + 32;  // one consumer warpgroup, then the producer warp
constexpr int kDwTarget = 132;          // dW slices: about one CTA an SM
// dynamic shared memory a block may opt into, less room for its static barriers
constexpr size_t kSmemMax = 232448 - 1024;

__device__ inline unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// Generic-proxy stores to shared memory before wgmma reads them.
__device__ inline void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The ring's barriers: full[s] completes on the producer's arrival and its
// TMA bytes, empty[s] once each of the 4 consumer warps released stage s.
__device__ inline void ring_init(u64* full, u64* empty, int stages) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], 4);
  }
}

__device__ inline void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Producer: waits until stage it % stages is free, then arms it for `bytes`.
__device__ inline u64* ring_fill(u64* full, u64* empty, int stages, int it, unsigned bytes) {
  const int st = it % stages;
  mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
  mbar_expect_tx(&full[st], bytes);
  return &full[st];
}

__device__ inline void ring_wait(u64* full, int stages, int it) {
  mbar_wait(&full[it % stages], (it / stages) & 1);
}

__device__ inline void ring_release(u64* empty, int stages, int it) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[it % stages]);
}

// The tile at src into the box of `map` at (c0, c1, c2): a TMA store, which
// the hardware clips to the array.
__device__ inline void tma_store(const TensorMap* map, const void* src, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(
          reinterpret_cast<u64>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(src))
      : "memory");
}

__device__ inline void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// Until this thread's TMA stores have read their shared memory.
__device__ inline void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The consumer warpgroup's accumulator (element (row 16 warp + gid + 8h,
// column 8j + 2tig + e) of a 64 x kCols tile is acc[4j + 2h + e]) rounded to
// T into `tile`, laid out as TMA reads it for a store: boxes of [64 rows][128
// B] with 128-byte swizzle, box b holding columns b·128/size on.
template <typename T, int kCols>
__device__ inline void stage_tile(unsigned char* tile, const float (&acc)[kCols / 2]) {
  using P = Pair<T>;
  constexpr int kBoxCols = 128 / sizeof(T);
  const int warp = threadIdx.x >> 5, gid = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + gid + 8 * h, col = 8 * j + 2 * tig;
      const int byte = (col % kBoxCols) * (int)sizeof(T);
      unsigned char* at = tile + (col / kBoxCols) * kBox + row * 128 +
                          ((((byte >> 4) ^ (row & 7)) << 4) | (byte & 15));
      P::st(reinterpret_cast<T*>(at), P::of(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
    }
}

// Element (row, col) of a tile of 128-byte rows of floats, 128-byte swizzle
// (the 16-byte chunk j of row r lies at j ^ (r % 8)).
__device__ inline float swz_f32(const unsigned char* tile, int row, int col) {
  return *reinterpret_cast<const float*>(
      tile + row * 128 + ((((col >> 2) ^ (row & 7)) << 4) | ((col & 3) << 2)));
}

// The A fragments of a k32 chunk for consumer warp q (m64 x k8 a step ks, as
// mma.sync's A: rows 16q + gid (+8), depth 8ks + tig (+4)), split into TF32
// halves.  a_rows_tf32: A's rows are the tile's rows (K-major, [64][32]
// floats).  a_cols_tf32: A's rows are the tile's columns, its depth the
// tile's rows, in boxes of [32 rows][32 columns] box_bytes apart.
__device__ inline void a_rows_tf32(const unsigned char* tile, unsigned (&ah)[4][4],
                                   unsigned (&al)[4][4]) {
  const int q = (threadIdx.x >> 5) & 3, gid = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_tf32(swz_f32(tile, 16 * q + gid + 8 * (r & 1), 8 * ks + tig + 4 * (r >> 1)),
                 ah[ks][r], al[ks][r]);
}

__device__ inline void a_cols_tf32(const unsigned char* boxes, int box_bytes, unsigned (&ah)[4][4],
                                   unsigned (&al)[4][4]) {
  const int q = (threadIdx.x >> 5) & 3, gid = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = 16 * q + gid + 8 * (r & 1);
      split_tf32(swz_f32(boxes + (m >> 5) * box_bytes, 8 * ks + tig + 4 * (r >> 1), m & 31),
                 ah[ks][r], al[ks][r]);
    }
}

// acc += one k32 chunk of A·B as three TF32 products, lo·hi + hi·lo + hi·hi,
// in a fresh accumulator (12 wgmma) added with a float add; B K-major in
// shared memory, its halves at b_hi and b_lo (rows of 128 bytes).
template <int kN>
__device__ inline void tf32x3_chunk(float (&acc)[kN / 2], const unsigned (&ah)[4][4],
                                    const unsigned (&al)[4][4], unsigned b_hi, unsigned b_lo) {
  float part[kN / 2];
  fence_regs(part);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const u64 hi = sw128_desc(b_hi + 32 * ks), lo = sw128_desc(b_lo + 32 * ks);
    Wgmma<kN>::tf32(part, al[ks], hi, ks > 0);
    Wgmma<kN>::tf32(part, ah[ks], lo, 1);
    Wgmma<kN>::tf32(part, ah[ks], hi, 1);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] += part[i];
}

// 32 of a flat accumulator: n-block nb of 64 columns
__device__ inline float (&block32(float* acc, int nb))[32] {
  return *reinterpret_cast<float(*)[32]>(acc + 32 * nb);
}

// band_out_kernel's tile: 64 rows x kN = 64·kNb output columns; a stage holds
// the term tile [64 rows][128 B] and W's chunk: float32 Wᵀ's hi and lo
// halves [kN][128 B] each, bfloat16 kNb boxes of W_k [64 channels][64 columns].
template <typename T, int kNb>
struct OutTile {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kDepth = 128 / sizeof(T);  // channels a stage
  static constexpr int kN = 64 * kNb;
  static constexpr int kStageBytes = kBox + kN * 128 * (kF32 ? 2 : 1);
  static constexpr size_t kSmem = (size_t)kRing * kStageBytes + 1024;  // + alignment
};

// out [R, F] = Σ_k T_k [R, C] · W_k [C, F] + b on rows [blockIdx.y·64, +64)
// x columns [blockIdx.x·kN, +kN): x_map over x [R, C], ts_map over ts [K-1,
// R, C]; w_map over Wᵀ's halves [2K, F', C] (float32: hi at k, lo at K + k)
// or W [K, C, F'] (bfloat16), F' >= F; out_map over out [R, F].  The tile
// leaves through shared memory by a TMA store.
template <typename T, int kNb>
__global__ void __launch_bounds__(kProdThreads)
    band_out_kernel(const __grid_constant__ TensorMap x_map,
                    const __grid_constant__ TensorMap ts_map,
                    const __grid_constant__ TensorMap w_map,
                    const __grid_constant__ TensorMap out_map, const float* __restrict__ b,
                    int C, int F, int K) {
  using Tl = OutTile<T, kNb>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) u64 full[kRing], empty[kRing];
  unsigned char* smem = align1024(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * 64, col0 = blockIdx.x * Tl::kN;
  const int chunks = (C + Tl::kDepth - 1) / Tl::kDepth, total = K * chunks;
  if (threadIdx.x == 0) {
    ring_init(full, empty, kRing);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // producer: the stages run across the terms, one ring for the whole depth
    if (lane == 0)
      for (int it = 0; it < total; ++it) {
        u64* bar = ring_fill(full, empty, kRing, it, Tl::kStageBytes);
        unsigned char* stage = smem + (it % kRing) * Tl::kStageBytes;
        const int k = it / chunks, c0 = (it % chunks) * Tl::kDepth;
        if (k == 0) tma_load(stage, &x_map, bar, c0, row0, 0);
        else tma_load(stage, &ts_map, bar, c0, row0, k - 1);
        if constexpr (Tl::kF32) {
          tma_load(stage + kBox, &w_map, bar, c0, col0, k);
          tma_load(stage + kBox + Tl::kN * 128, &w_map, bar, c0, col0, K + k);
        } else {
          for (int nb = 0; nb < kNb; ++nb)
            tma_load(stage + kBox + nb * kBox, &w_map, bar, col0 + 64 * nb, c0, k);
        }
      }
    return;
  }
  // consumers: accumulator element (row 16 warp + gid + 8h, column 8j + 2tig
  // + e) is acc[4j + 2h + e]
  float acc[Tl::kN / 2];
#pragma unroll
  for (int i = 0; i < Tl::kN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < total; ++it) {
    ring_wait(full, kRing, it);
    const unsigned char* stage = smem + (it % kRing) * Tl::kStageBytes;
    const unsigned a = smem_addr(stage), w = a + kBox;
    if constexpr (Tl::kF32) {
      unsigned ah[4][4], al[4][4];
      a_rows_tf32(stage, ah, al);
      tf32x3_chunk<Tl::kN>(acc, ah, al, w, w + Tl::kN * 128);
    } else {
      // A K-major (T's rows), B = W_k N-major: a k-step is 16 channels, 32
      // bytes along A's rows and 16 rows (2048 bytes) down W's box
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int nb = 0; nb < kNb; ++nb)
          Wgmma<64>::bf16<0, 1>(block32(acc, nb), sw128_desc(a + 32 * ks),
                                sw128_desc(w + nb * kBox + 2048 * ks), 1);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
    }
    ring_release(empty, kRing, it);
  }
  // the f32 bias, then one rounding as the tile is staged in the first stage
  const int tig = lane & 3;
#pragma unroll
  for (int j = 0; j < Tl::kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = col0 + 8 * j + 2 * tig + e;
      const float bc = c < F ? b[c] : 0.f;
      acc[4 * j + e] += bc;
      acc[4 * j + 2 + e] += bc;
    }
  consumers_sync_n<128>();  // every warp is done with the stages
  stage_tile<T, Tl::kN>(smem, acc);
  fence_async_smem();
  consumers_sync_n<128>();
  if (threadIdx.x == 0) {
    for (int bx = 0; bx < Tl::kN * (int)sizeof(T) / 128; ++bx)
      tma_store(&out_map, smem + bx * kBox, col0 + bx * 128 / (int)sizeof(T), row0, 0);
    bulk_commit();
    bulk_wait_read();
  }
}

// band_bar_kernel's shared memory: the ring, a stage W_k's chunk [64
// channels][128 B] (float32: hi, lo) and, where g streams (kResidentG
// false), g's chunk [64 rows][128 B] after it; the output tile [64][64]
// staged for its TMA store; where g is resident, the CTA's rows of g,
// fchunks boxes [64][128 B].
template <typename T, bool kResidentG>
struct BarTile {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kDepth = 128 / sizeof(T);  // columns of g a chunk
  static constexpr int kWBytes = kBox * (kF32 ? 2 : 1);
  static constexpr int kStageBytes = kWBytes + (kResidentG ? 0 : kBox);
  static constexpr int kOutBytes = 64 * 64 * sizeof(T);
  static size_t smem(int fchunks) {
    return (size_t)kRing * kStageBytes + kOutBytes + (kResidentG ? (size_t)fchunks * kBox : 0) +
           1024;
  }
};

// bars[k] [R, C] = g [R, F] · W_kᵀ rounded to T, for every k, on rows
// [blockIdx.y·64, +64) x channels [blockIdx.x·64, +64): g_map over g [R,
// F'], w_map over W's halves [2K, C, F'] (float32) or W [K, C, F'], bar_map
// over bars [K, R, C]; the g rows stay in shared memory while the CTA walks
// k (kResidentG) or come with W_k's chunk in every stage, each term's tile
// leaves by a TMA store.
template <typename T, bool kResidentG>
__global__ void __launch_bounds__(kProdThreads)
    band_bar_kernel(const __grid_constant__ TensorMap g_map,
                    const __grid_constant__ TensorMap w_map,
                    const __grid_constant__ TensorMap bar_map, int K, int fchunks) {
  using Tl = BarTile<T, kResidentG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) u64 full[kRing], empty[kRing], g_full;
  unsigned char* smem = align1024(smem_raw);
  unsigned char* staged = smem + kRing * Tl::kStageBytes;
  unsigned char* g_tile = staged + Tl::kOutBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * 64, c0 = blockIdx.x * 64, total = K * fchunks;
  if (threadIdx.x == 0) {
    ring_init(full, empty, kRing);
    mbar_init(&g_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0) {
      if constexpr (kResidentG) {
        mbar_expect_tx(&g_full, fchunks * kBox);
        for (int fc = 0; fc < fchunks; ++fc)
          tma_load(g_tile + fc * kBox, &g_map, &g_full, fc * Tl::kDepth, row0, 0);
      }
      for (int it = 0; it < total; ++it) {
        u64* bar = ring_fill(full, empty, kRing, it, Tl::kStageBytes);
        unsigned char* stage = smem + (it % kRing) * Tl::kStageBytes;
        const int k = it / fchunks, f0 = (it % fchunks) * Tl::kDepth;
        tma_load(stage, &w_map, bar, f0, c0, k);
        if constexpr (Tl::kF32) tma_load(stage + kBox, &w_map, bar, f0, c0, K + k);
        if constexpr (!kResidentG) tma_load(stage + Tl::kWBytes, &g_map, bar, f0, row0, 0);
      }
    }
    return;
  }
  if constexpr (kResidentG) mbar_wait(&g_full, 0);
  for (int k = 0; k < K; ++k) {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int fc = 0; fc < fchunks; ++fc) {
      const int it = k * fchunks + fc;
      ring_wait(full, kRing, it);
      const unsigned char* stage = smem + (it % kRing) * Tl::kStageBytes;
      const unsigned char* a = kResidentG ? g_tile + fc * kBox : stage + Tl::kWBytes;
      const unsigned w = smem_addr(stage);
      if constexpr (Tl::kF32) {
        unsigned ah[4][4], al[4][4];
        a_rows_tf32(a, ah, al);
        tf32x3_chunk<64>(acc, ah, al, w, w + kBox);
      } else {
        // both K-major: a k-step is 16 columns of g, 32 bytes along the rows
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Wgmma<64>::bf16<0, 0>(acc, sw128_desc(smem_addr(a) + 32 * ks), sw128_desc(w + 32 * ks),
                                1);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
      }
      ring_release(empty, kRing, it);
    }
    // the tile out through shared memory, once the last one's store has read it
    if (threadIdx.x == 0) bulk_wait_read();
    consumers_sync_n<128>();
    stage_tile<T, 64>(staged, acc);
    fence_async_smem();
    consumers_sync_n<128>();
    if (threadIdx.x == 0) {
      for (int bx = 0; bx < 64 * (int)sizeof(T) / 128; ++bx)
        tma_store(&bar_map, staged + bx * kBox, c0 + bx * Tl::kDepth, row0, k);
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait_read();
}

// band_dw_kernel's tile: kRows rows (the depth) a stage; a piece is 64
// channels (or columns of g) of those rows, 8 KB, as boxes of [kRows][128
// B]; a stage holds kTerms term pieces, then g's.  float32 adds two
// buffers of g's piece transposed, [64 columns][32 rows] as TF32 hi and lo.
template <typename T>
struct DwTile {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kTerms = 2;  // terms a CTA carries
  static constexpr int kRows = kF32 ? 32 : 64;  // one k32 chunk, or four k16 steps
  static constexpr int kBoxCols = 128 / sizeof(T);
  static constexpr int kBoxBytes = kRows * 128;
  static constexpr int kPiece = 64 / kBoxCols * kBoxBytes;
  static constexpr int kStageBytes = (kTerms + 1) * kPiece;
  // a CTA an SM (kDwTarget), so a deep ring keeps the SM's loads in flight
  static constexpr int kStages = kF32 ? 5 : 6;
  static constexpr int kHalf = kF32 ? 64 * 128 : 0;
  static constexpr size_t kSmem = (size_t)kStages * kStageBytes + 4 * (size_t)kHalf + 1024;
};

// partial[split][k·C·F + c·F + f] = Σ over the slice's rows of T_k[r, c]
// g[r, f] for the CTA's terms k0, k0 + 1, its 64 channels and 64 columns;
// the slice is chunks [q0, q1) of the G·ceil(S / kRows) row chunks (chunk q:
// block q / cps, rows from (q % cps)·kRows; TMA gives zeros past S).  The
// CTAs of channel tile 0 and terms 0-1 also write partial[split][K·C·F + f] =
// Σ g[r, f].  x_map over x [G, S, C], ts_map over ts [(K-1)·G, S, C], g_map
// over g [G, S, F'].
template <typename T>
__global__ void __launch_bounds__(kProdThreads)
    band_dw_kernel(const __grid_constant__ TensorMap x_map,
                   const __grid_constant__ TensorMap ts_map,
                   const __grid_constant__ TensorMap g_map, float* __restrict__ partial, int G,
                   int S, int C, int F, int K, int n_split) {
  using Tl = DwTile<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) u64 full[Tl::kStages], empty[Tl::kStages];
  __shared__ float db_half[64];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* gt = smem + Tl::kStages * Tl::kStageBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ctiles = (C + 63) / 64, ftiles = (F + 63) / 64;
  const int ft = blockIdx.x % ftiles, ct = blockIdx.x / ftiles % ctiles;
  const int grp = blockIdx.x / (ftiles * ctiles);
  const int c0 = 64 * ct, f0 = 64 * ft, k0 = Tl::kTerms * grp;
  const int nk = K - k0 < Tl::kTerms ? K - k0 : Tl::kTerms;
  const int split = blockIdx.y, cps = (S + Tl::kRows - 1) / Tl::kRows;
  const long long n = (long long)G * cps;
  const int q0 = (int)(n * split / n_split), chunks = (int)(n * (split + 1) / n_split) - q0;
  const bool with_db = ct == 0 && grp == 0;
  if (threadIdx.x == 0) {
    ring_init(full, empty, Tl::kStages);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0)
      for (int it = 0; it < chunks; ++it) {
        const int q = q0 + it, blk = q / cps, s0 = (q % cps) * Tl::kRows;
        u64* bar = ring_fill(full, empty, Tl::kStages, it, (nk + 1) * Tl::kPiece);
        unsigned char* stage = smem + (it % Tl::kStages) * Tl::kStageBytes;
        for (int bx = 0; bx < 64 / Tl::kBoxCols; ++bx) {
          const int off = bx * Tl::kBoxBytes, col = bx * Tl::kBoxCols;
          for (int j = 0; j < nk; ++j) {
            const int k = k0 + j;
            if (k == 0) tma_load(stage + j * Tl::kPiece + off, &x_map, bar, c0 + col, s0, blk);
            else tma_load(stage + j * Tl::kPiece + off, &ts_map, bar, c0 + col, s0,
                          (k - 1) * G + blk);
          }
          tma_load(stage + Tl::kTerms * Tl::kPiece + off, &g_map, bar, f0 + col, s0, blk);
        }
      }
    return;
  }
  // consumers: accumulator element (channel 16 warp + gid + 8h, column 8j +
  // 2tig + e) of term j is acc[j][4j' + 2h + e]; thread t sums db's column
  // t % 64 over half t / 64 of each chunk's rows
  const int gid = lane >> 2, tig = lane & 3;
  const int col = threadIdx.x & 63, half = threadIdx.x >> 6;
  float acc[Tl::kTerms][32];
#pragma unroll
  for (int j = 0; j < Tl::kTerms; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  float db = 0.f;
  for (int it = 0; it < chunks; ++it) {
    ring_wait(full, Tl::kStages, it);
    const unsigned char* stage = smem + (it % Tl::kStages) * Tl::kStageBytes;
    const unsigned char* g_piece = stage + Tl::kTerms * Tl::kPiece;
    if constexpr (Tl::kF32) {
      // g's piece transposed into [64 columns][32 rows] TF32 halves (K-major,
      // 128-byte swizzle): this thread's column, rows 4rq .. 4rq + 3 for rq =
      // half, half + 2, ..., one 16-byte store a half and quad
      unsigned char* hi = gt + (it & 1) * 2 * Tl::kHalf;
      unsigned char* lo = hi + Tl::kHalf;
      const unsigned char* box = g_piece + (col >> 5) * Tl::kBoxBytes;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rq = half + 2 * i;
        unsigned h4[4], l4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = swz_f32(box, 4 * rq + e, col & 31);
          db += v;
          split_tf32(v, h4[e], l4[e]);
        }
        const int at = col * 128 + ((rq ^ (col & 7)) << 4);
        *reinterpret_cast<uint4*>(hi + at) = make_uint4(h4[0], h4[1], h4[2], h4[3]);
        *reinterpret_cast<uint4*>(lo + at) = make_uint4(l4[0], l4[1], l4[2], l4[3]);
      }
      // every warp's piece is written; the buffer written two chunks ago
      // was read by wgmma that every warp has waited for before this barrier
      fence_async_smem();
      consumers_sync_n<128>();
#pragma unroll
      for (int j = 0; j < Tl::kTerms; ++j)
        if (j < nk) {
          unsigned ah[4][4], al[4][4];
          a_cols_tf32(stage + j * Tl::kPiece, Tl::kBoxBytes, ah, al);
          tf32x3_chunk<64>(acc[j], ah, al, smem_addr(hi), smem_addr(lo));
        }
    } else {
      // A = T_kᵀ M-major and B = g N-major, both as TMA stores the rows: a
      // k-step is 16 rows, 2048 bytes down each piece.  Every term slot is
      // multiplied, a slot past K on whatever its piece holds: no branch
      // between the wgmma, and its sums are never stored
#pragma unroll
      for (int j = 0; j < Tl::kTerms; ++j) fence_regs(acc[j]);
      wgmma_fence();
      const unsigned g_addr = smem_addr(g_piece), t_addr = smem_addr(stage);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int j = 0; j < Tl::kTerms; ++j)
          Wgmma<64>::bf16<1, 1>(acc[j], sw128_desc(t_addr + j * Tl::kPiece + 2048 * ks),
                                sw128_desc(g_addr + 2048 * ks), 1);
      wgmma_commit();
      if (with_db) {  // while the tensor cores run
#pragma unroll 8
        for (int r = 32 * half; r < 32 * half + 32; ++r)
          db += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
              g_piece + r * 128 + ((((col >> 3) ^ (r & 7)) << 4) | ((col & 7) << 1))));
      }
      wgmma_wait0();
#pragma unroll
      for (int j = 0; j < Tl::kTerms; ++j) fence_regs(acc[j]);
    }
    ring_release(empty, Tl::kStages, it);
  }
  float* dst = partial + (size_t)split * ((size_t)K * C * F + F);
#pragma unroll
  for (int j = 0; j < Tl::kTerms; ++j) {
    if (j >= nk) continue;
    float* dk = dst + (size_t)(k0 + j) * C * F;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + 16 * warp + gid + 8 * h, f = f0 + 8 * jj + 2 * tig;
        if (c >= C || f >= F) continue;
        float* d = dk + (size_t)c * F + f;
        if ((F & 1) == 0) {
          *reinterpret_cast<float2*>(d) = make_float2(acc[j][4 * jj + 2 * h], acc[j][4 * jj + 2 * h + 1]);
        } else {
          d[0] = acc[j][4 * jj + 2 * h];
          if (f + 1 < F) d[1] = acc[j][4 * jj + 2 * h + 1];
        }
      }
  }
  if (with_db) {
    if (half == 1) db_half[col] = db;
    consumers_sync_n<128>();
    if (half == 0 && f0 + col < F) dst[(size_t)K * C * F + f0 + col] = db + db_half[col];
  }
}

// out[i] = Σ_p partial[p][i] over the n_split slices: warp w of the block
// sums slices w, w + 8, ... in order for 32 neighbouring i, then the eight
// sums are added in warp order.  A fixed order: a second launch gives the
// same bits.
__global__ void __launch_bounds__(256)
    band_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, size_t n,
                       int n_split) {
  __shared__ float sums[8][32];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t i = (size_t)blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < n)
    for (int p = w; p < n_split; p += 8) s += partial[(size_t)p * n + i];
  sums[w][lane] = s;
  __syncthreads();
  if (w == 0 && i < n) {
    float t = sums[0][lane];
#pragma unroll
    for (int v = 1; v < 8; ++v) t += sums[v][lane];
    out[i] = t;
  }
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

template <int N>
struct Nb {
  static constexpr int value = N;
};

// A product kernel's launch, and what the [band] plan lines print of it.
struct ProductLaunch {
  dim3 grid;
  size_t smem = 0;
  int cols = 64;  // the tile's columns (rows: 64)
};

// out[0..9] as hlhgat_band_step_plan gives them, for a product kernel.
template <typename Kernel>
cudaError_t product_plan(Kernel kernel, const ProductLaunch& p, int* out) {
  int per_sm = 0, dev = 0, sms = 0;
  STEP_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kProdThreads, p.smem));
  cudaFuncAttributes fa;
  STEP_TRY(cudaFuncGetAttributes(&fa, kernel));
  STEP_TRY(cudaGetDevice(&dev));
  STEP_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const int v[10] = {(int)p.grid.x, (int)p.grid.y, (int)p.grid.z, kProdThreads, (int)p.smem,
                     fa.numRegs, per_sm, sms, 64, p.cols};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return cudaSuccess;
}

template <typename T>
bool rows16(int n) {
  return ((size_t)n * sizeof(T)) % 16 == 0;
}

inline bool on16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

// out = Σ_k T_k W_k + b (band_out_kernel) over R rows; w as band_out_kernel
// reads it, ldf its row stride (bfloat16) or its rows (float32), and out's
// row stride.  With plan != nullptr only the launch's plan is written.
template <typename T>
cudaError_t launch_out(const T* x, const T* ts, const T* w, const float* b, T* out, int R, int C,
                       int F, int ldf, int K, cudaStream_t stream, int* plan = nullptr) {
  constexpr bool bf16 = sizeof(T) == 2;
  const u64 es = sizeof(T);
  auto run = [&](auto nb) -> cudaError_t {
    constexpr int kNb = decltype(nb)::value;
    using Tl = OutTile<T, kNb>;
    const auto kernel = band_out_kernel<T, kNb>;
    ProductLaunch p;
    p.grid = dim3((F + Tl::kN - 1) / Tl::kN, (R + 63) / 64);
    p.smem = Tl::kSmem;
    p.cols = Tl::kN;
    STEP_TRY(allow_smem(kernel, p.smem));
    if (plan != nullptr) return product_plan(kernel, p, plan);
    TensorMap xm, tm, wm;
    STEP_TRY(make_map(&xm, x, bf16, C, R, 1, C * es, (u64)R * C * es, Tl::kDepth, 64));
    STEP_TRY(make_map(&tm, K > 1 ? ts : x, bf16, C, R, K > 1 ? K - 1 : 1, C * es,
                      (u64)R * C * es, Tl::kDepth, 64));
    if (bf16)
      STEP_TRY(make_map(&wm, w, bf16, ldf, C, K, ldf * es, (u64)C * ldf * es, 64, 64));
    else
      STEP_TRY(make_map(&wm, w, bf16, C, ldf, 2 * K, C * es, (u64)ldf * C * es, 32, Tl::kN));
    TensorMap om;
    STEP_TRY(make_map(&om, out, bf16, F, R, 1, ldf * es, (u64)R * ldf * es, Tl::kDepth, 64));
    kernel<<<p.grid, kProdThreads, p.smem, stream>>>(xm, tm, wm, om, b, C, F, K);
    return cudaGetLastError();
  };
  return F > 64 ? run(Nb<2>{}) : run(Nb<1>{});
}

// bars[k] = g W_kᵀ for every k (band_bar_kernel); g [R, ldf], w W's halves
// [2K, C, ldf] (float32) or W [K, C, ldf].  g's rows stay resident where
// they fit (ldf <= 576 float32, 1472 bfloat16), else they stream with W.
template <typename T>
cudaError_t launch_bar(const T* g, const T* w, T* bars, int R, int C, int ldf, int K,
                       cudaStream_t stream, int* plan = nullptr) {
  constexpr bool bf16 = sizeof(T) == 2;
  const u64 es = sizeof(T);
  using Resident = BarTile<T, true>;
  const int fchunks = (ldf + Resident::kDepth - 1) / Resident::kDepth;
  auto run = [&](auto resident) -> cudaError_t {
    constexpr bool kResidentG = decltype(resident)::value != 0;
    using Tl = BarTile<T, kResidentG>;
    const auto kernel = band_bar_kernel<T, kResidentG>;
    ProductLaunch p;
    p.grid = dim3((C + 63) / 64, (R + 63) / 64);
    p.smem = Tl::smem(fchunks);
    STEP_TRY(allow_smem(kernel, p.smem));
    if (plan != nullptr) return product_plan(kernel, p, plan);
    TensorMap gm, wm, bm;
    STEP_TRY(make_map(&gm, g, bf16, ldf, R, 1, ldf * es, (u64)R * ldf * es, Tl::kDepth, 64));
    STEP_TRY(make_map(&wm, w, bf16, ldf, C, bf16 ? K : 2 * K, ldf * es, (u64)C * ldf * es,
                      Tl::kDepth, 64));
    STEP_TRY(make_map(&bm, bars, bf16, C, R, K, C * es, (u64)R * C * es, Tl::kDepth, 64));
    kernel<<<p.grid, kProdThreads, p.smem, stream>>>(gm, wm, bm, K, fchunks);
    return cudaGetLastError();
  };
  return Resident::smem(fchunks) <= kSmemMax ? run(Nb<1>{}) : run(Nb<0>{});
}

// The CTAs of band_dw_kernel a slice: term groups x channel tiles x column tiles.
template <typename T>
int dw_tiles(int C, int F, int K) {
  constexpr int kTerms = DwTile<T>::kTerms;
  return (K + kTerms - 1) / kTerms * ((C + 63) / 64) * ((F + 63) / 64);
}

// The row chunks of the dW sums (G blocks of ceil(S / rows) chunks).
template <typename T>
long long dw_chunks(int G, int S) {
  return (long long)G * ((S + DwTile<T>::kRows - 1) / DwTile<T>::kRows);
}

// Slices of the dW and db sums: about kDwTarget CTAs in all, each slice at
// least one chunk.
template <typename T>
int band_splits(int G, int S, int C, int F, int K) {
  long long n = kDwTarget / dw_tiles<T>(C, F, K);  // rounded down: one wave
  const long long chunks = dw_chunks<T>(G, S);
  if (n > chunks) n = chunks;
  return n < 1 ? 1 : (int)n;
}

// partial [n_split, K·C·F + F] (band_dw_kernel): dW and db by slices.
template <typename T>
cudaError_t launch_dw(const T* x, const T* ts, const T* g, float* partial, int G, int S, int C,
                      int F, int ldf, int K, int n_split, cudaStream_t stream,
                      int* plan = nullptr) {
  constexpr bool bf16 = sizeof(T) == 2;
  using Tl = DwTile<T>;
  const u64 es = sizeof(T);
  if (n_split < 1 || n_split > dw_chunks<T>(G, S)) return cudaErrorInvalidValue;
  ProductLaunch p;
  p.grid = dim3(dw_tiles<T>(C, F, K), n_split);
  p.smem = Tl::kSmem;
  const auto kernel = band_dw_kernel<T>;
  STEP_TRY(allow_smem(kernel, p.smem));
  if (plan != nullptr) return product_plan(kernel, p, plan);
  TensorMap xm, tm, gm;
  const u64 row = C * es, blk = (u64)S * C * es;
  STEP_TRY(make_map(&xm, x, bf16, C, S, G, row, blk, Tl::kBoxCols, Tl::kRows));
  STEP_TRY(make_map(&tm, K > 1 ? ts : x, bf16, C, S, (u64)G * (K > 1 ? K - 1 : 1), row, blk,
                    Tl::kBoxCols, Tl::kRows));
  STEP_TRY(make_map(&gm, g, bf16, ldf, S, G, ldf * es, (u64)S * ldf * es, Tl::kBoxCols,
                    Tl::kRows));
  kernel<<<p.grid, kProdThreads, p.smem, stream>>>(xm, tm, gm, partial, G, S, C, F, K, n_split);
  return cudaGetLastError();
}

template <typename T>
int band_fused_fwd(const void* l_, const void* x_, const void* w_, const void* b_, void* out_,
                   void* ts_, int G, int S, int ldl, int C, int F, int ldf, int K,
                   cudaStream_t stream) {
  const T* l = static_cast<const T*>(l_);
  const T* x = static_cast<const T*>(x_);
  const T* w = static_cast<const T*>(w_);
  T* ts = static_cast<T*>(ts_);
  if (K < 1 || ldf < F || !rows16<T>(C) || !rows16<T>(ldf) || !on16(x) || !on16(w) ||
      !on16(out_) || (K > 1 && !on16(ts)))
    return (int)cudaErrorInvalidValue;
  const size_t gsc = (size_t)G * S * C;
  BAND_TRY(run_recurrence<T>(l, [&](int k) { return term_of<T>(x, ts, gsc, k); }, G, S, ldl, C, K,
                             stream));
  return (int)launch_out<T>(x, ts, w, static_cast<const float*>(b_), static_cast<T*>(out_), G * S,
                            C, F, ldf, K, stream);
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

template <typename T>
int band_fused_bwd(const void* l_, const void* x_, const void* w_, const void* g_, void* dx_,
                   void* dwdb_, void* partial_, void* ts_, void* bars_, int G, int S, int ldl,
                   int C, int F, int ldf, int K, int n_split, cudaStream_t stream) {
  const T* l = static_cast<const T*>(l_);
  const T* x = static_cast<const T*>(x_);
  const T* w = static_cast<const T*>(w_);
  const T* g = static_cast<const T*>(g_);
  T* ts = static_cast<T*>(ts_);
  T* dx = static_cast<T*>(dx_);
  float* partial = static_cast<float*>(partial_);
  if (K < 1 || ldf < F || !rows16<T>(C) || !rows16<T>(ldf) || !on16(x) || !on16(w) ||
      !on16(g) || !on16(dx) || (K > 1 && (!on16(ts) || !on16(bars_))))
    return (int)cudaErrorInvalidValue;
  const size_t gsc = (size_t)G * S * C;
  const int R = G * S;
  // the terms, recomputed from x
  BAND_TRY(run_recurrence<T>(l, [&](int k) { return term_of<T>(x, ts, gsc, k); }, G, S, ldl, C, K,
                             stream));
  // b̄_k = g W_kᵀ (with one term, b̄_0 is dx), then the adjoint walk
  T* bars = K > 1 ? static_cast<T*>(bars_) : dx;
  BAND_TRY(launch_bar<T>(g, w, bars, R, C, ldf, K, stream));
  if (K > 1)
    BAND_TRY(run_walk<T>(l, [&](int k) { return bars + (size_t)k * gsc; }, dx, G, S, ldl, C, K,
                         stream));
  // dW and db: per-slice partials, then the fixed-order sum
  BAND_TRY(launch_dw<T>(x, ts, g, partial, G, S, C, F, ldf, K, n_split, stream));
  const size_t n = (size_t)K * C * F + F;
  band_reduce_kernel<<<(unsigned)((n + 31) / 32), 256, 0, stream>>>(
      partial, static_cast<float*>(dwdb_), n, n_split);
  return (int)cudaGetLastError();
}

// The plan of product kernel `kind` (0 band_out_kernel, 1 band_bar_kernel,
// 2 band_dw_kernel) at G blocks of S rows, C channels, F columns, K terms.
template <typename T>
int product_plan_of(int kind, int G, int S, int C, int F, int K, int* out) {
  const int ldf = (int)((F * sizeof(T) + 15) / 16 * 16 / sizeof(T));
  const int R = G * S;
  if (kind == 0)
    return (int)launch_out<T>(nullptr, nullptr, nullptr, nullptr, nullptr, R, C, F, ldf, K,
                              nullptr, out);
  if (kind == 1)
    return (int)launch_bar<T>(nullptr, nullptr, nullptr, R, C, ldf, K, nullptr, out);
  return (int)launch_dw<T>(nullptr, nullptr, nullptr, nullptr, G, S, C, F, ldf, K,
                           band_splits<T>(G, S, C, F, K), nullptr, out);
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
// l (row stride ldl), x [G,S,C], out [G,S,ldf] (columns past F untouched)
// in x's dtype (bf16 != 0: bfloat16, else float32), 16-byte aligned; b [F]
// float32; w: W [K,C,F] as the products read
// it, prepared by the caller in x's type with ldf >= F columns (ldf·size a
// multiple of 16 bytes), zero past C and F: bfloat16 W [K,C,ldf], float32
// the TF32 halves of Wᵀ [2,K,ldf,C] (hi = tf32(Wᵀ), then lo = Wᵀ − hi); ts:
// scratch [K-1,G,S,C] in x's type (unused when K = 1).  Returns a
// cudaError_t.
int hlhgat_band_fused_fwd(const void* l, const void* x, const void* w, const void* b,
                          void* out, void* ts, int G, int S, int ldl, int C, int F, int ldf,
                          int K, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? band_fused_fwd<__nv_bfloat16>(l, x, w, b, out, ts, G, S, ldl, C, F, ldf, K, s)
              : band_fused_fwd<float>(l, x, w, b, out, ts, G, S, ldl, C, F, ldf, K, s);
}

// l (row stride ldl), x [G,S,C] -> t [K,G,S,C], all in x's dtype.
int hlhgat_band_terms_fwd(const void* l, const void* x, void* t, int G, int S, int ldl, int C,
                          int K, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? band_terms_fwd<__nv_bfloat16>(l, x, t, G, S, ldl, C, K, s)
              : band_terms_fwd<float>(l, x, t, G, S, ldl, C, K, s);
}

// Number of slices of the dW/db partial sums (bf16 != 0: bfloat16): the
// caller allocates partial [n_split, K*C*F + F] float32.
int hlhgat_band_fused_bwd_splits(int G, int S, int C, int F, int K, int bf16) {
  return bf16 ? band_splits<__nv_bfloat16>(G, S, C, F, K) : band_splits<float>(G, S, C, F, K);
}

// l (row stride ldl), x [G,S,C], g [G,S,ldf], dx [G,S,C] in x's dtype; w:
// W [K,C,F] as band_bar_kernel reads it, in x's type, zero past C and F:
// bfloat16 W [K,C,ldf], float32 its TF32 halves [2,K,C,ldf]; dwdb
// [K*C*F + F] float32 receives dW then db; ts: scratch [K-1,G,S,C] and
// bars: scratch [K,G,S,C] in x's type (both unused when K = 1).
int hlhgat_band_fused_bwd(const void* l, const void* x, const void* w, const void* g,
                          void* dx, void* dwdb, void* partial, void* ts, void* bars, int G,
                          int S, int ldl, int C, int F, int ldf, int K, int n_split, int bf16,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? band_fused_bwd<__nv_bfloat16>(l, x, w, g, dx, dwdb, partial, ts, bars, G, S,
                                              ldl, C, F, ldf, K, n_split, s)
              : band_fused_bwd<float>(l, x, w, g, dx, dwdb, partial, ts, bars, G, S, ldl, C, F,
                                      ldf, K, n_split, s);
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

// A product kernel's launch (kind 0: band_out_kernel, 1: band_bar_kernel,
// 2: band_dw_kernel) for G blocks of S rows, C channels (a multiple of 16
// bytes), F columns and K terms: out[0..9] as hlhgat_band_step_plan gives
// them, the tile's rows and columns last.  Returns a cudaError_t.
int hlhgat_band_product_plan(int kind, int G, int S, int C, int F, int K, int bf16, int* out) {
  return bf16 ? product_plan_of<__nv_bfloat16>(kind, G, S, C, F, K, out)
              : product_plan_of<float>(kind, G, S, C, F, K, out);
}


const char* hlhgat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
