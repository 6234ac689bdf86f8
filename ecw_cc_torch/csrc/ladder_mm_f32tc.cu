// The f32 ladder NT GEMM on Hopper's tensor cores (sm_90a), in three TF32
// passes:
//
//     C[m, n] = sum_k A[m, k] * B[n, k]
//
// A (M, K) and B (N, K) row-major, contiguous along K, with row strides
// lda and ldb (B's a multiple of 16 bytes); C (M, N) contiguous, f32.
// Instances of one template:
//
// * kPasses = 3, the 'f32' variant where the planner routes it (the sector
//   GEMMs from cc-pVTZ up): each operand split as x = hi + lo, hi =
//   rna_tf32(x), lo = rna_tf32(x - hi), and C = lo_a hi_b + hi_a lo_b +
//   hi_a hi_b in f32: the f32 contract of csrc/ladder_mm.cu (<= 1e-5
//   max|C| of a @ b.T), where the dropped lo_a lo_b is ~2^-22 of each
//   product.  A lo that is not finite (x is Inf or NaN, or hi rounded to
//   Inf) is taken as 0, so NaN and Inf reach C through hi: a NaN as a NaN,
//   an Inf as an Inf, or as a NaN where a cross term is Inf x 0 (the
//   other operand's lo is 0), where a @ b.T would give an Inf.
// * kPasses = 1, the 'tf32' variant at the sector shapes where the planner
//   routes it: both operands rounded with cvt.rna, hi_a hi_b in f32, the
//   arithmetic of csrc/ladder_mm_tc.cu's TF32 kernel.
//
// Replaces the TPU kernel ecw_cc_tpu/ops/ladder.py::_ladder_mm_pallas for
// the f32 products of the sorted sectored route, ECW's f32 main path from
// cc-pVTZ up (98 x {3240, 6561}^2 a solver iteration at C2H2/cc-pVTZ, 294 x
// the same with three lambda lanes, 98 x {2211, 4489}^2 at the flagship
// basis).  The JAX package ran that kernel's dot at
// jax_default_matmul_precision='highest' (ecw_cc_tpu/config.py:175): f32
// on the TPU's matrix unit as six bf16 passes.  This is Hopper's
// counterpart, where csrc/ladder_mm.cu keeps f32 on the CUDA cores.
//
// What bounds it.  At M = 98 a byte of B carries 2 * 98 / 4 = 49 flops;
// three passes at TF32's 494 TFLOP/s run 165 TFLOP/s of f32-accurate work,
// a balance point of 49 flops per byte at 3.35 TB/s, so these products sit
// on the line between the two bounds: max(3 * 2MNK / 494 TFLOP/s, one pass
// over A, B and C / 3.35 TB/s) is 13.3 us at 98 x 3240^2 and 52.9 us at
// 98 x 6561^2 (bytes), 153.7 us at 294 x 6561^2 (operations), against
// 30.7 and 125.9 us for the FFMA kernel's own bound at 67 TFLOP/s.  So
// B (172 MB at 6561^2) has to stream from device memory once, split on the
// way at no cost in bytes, and the tensor cores have to be kept fed.  The
// design, choice by choice:
//
// * A and B swapped onto wgmma's sides.  B, the large operand, is wgmma's
//   M side: a 128-row tile per block (two consumer warpgroups of 64 rows),
//   loaded by TMA into a ring of kStages shared-memory stages and read into
//   registers as the A fragment of the register form of wgmma, where the
//   split into hi and lo is a cvt and a subtraction per element.  No pass
//   over B is made outside the kernel, and B is read once per launch.
// * A, the small operand (98 rows a lambda lane), is wgmma's N side from
//   shared memory, one group of BM = 104 rows per block (98 padded to a
//   multiple of 8: 6% of the tensor work wasted, where a 128-row tile
//   wasted 23%), or 152 (two groups for the 294 rows of three lanes).
//   Its hi and lo come from one split pass per launch (split_a, a second
//   kernel on the same stream): A is 2.6 MB at 98 x 6561 against B's
//   172 MB, and the pass writes both halves into 16-byte rows of the
//   wrapper's scratch, which TMA loads beside B.  Splitting each staged A
//   tile in the kernel cost more, since every block split its own copy of
//   A's K range: three splitter warps could not keep up with the wgmmas
//   (98 x 6561^2 at split 2: 163 us with the in-kernel split and 130 us
//   with it skipped; 294 x 6561^2: 619 against 480), and splitting in the
//   consumer warpgroups, which then met on a barrier per chunk, 199 us
//   (earlier versions of this file, tools/f32tc_splits.py, H100 SXM at
//   700 W).
// * Three wgmma per 8-deep K step, lo_b hi_a, hi_b lo_a, then hi_b hi_a,
//   into one f32 accumulator.  wgmma's .tf32 takes both operands K-major,
//   which the NT layout gives as it is.  Each warpgroup issues a chunk as
//   two groups of two k8 steps, loading one group's B fragments while the
//   other runs, and the two warpgroups meet on no barrier.  A ring of
//   kStages = 4 stages of 42 KB (B, A's hi, A's lo) ran 8% faster than 5.
// * The tensor cores' f32 accumulation truncates: as in ladder_mm_tc.cu,
//   each run of kFlushK = 256 of K (96 wgmma) starts a fresh accumulator,
//   whose sum is added to a second set of f32 registers with
//   round-to-nearest adds.  Both sets live in registers: 104 accumulators
//   a thread at BM = 104 (163 registers), 152 at BM = 152, where ptxas's
//   limit of 168 spills about 300 bytes.
// * More rows of A (lambda lanes: 196, 294, 784): cm = ceil(M / BM)
//   blocks, one per row group, form a thread block cluster and share each
//   B tile: block r loads boxes r, r + cm, ... of the tile's nb =
//   pow2ceil(cm) row boxes and multicasts them into every block of the
//   group, so B still leaves L2 once per launch.  A stage is refilled only
//   when every consumer warp of the group has released it.
// * Deterministic split-K across the cluster's z extent, the partials
//   summed in the fixed order 0..split-1 through distributed shared
//   memory, as ladder_mm.cu and ladder_mm_tc.cu do: no atomics and no
//   workspace, so a launch is bitwise repeatable and a graph replay
//   equals it.  The planner (kernels/ladder_mm.py _f32tc_split) keeps the
//   launch within one wave (one block an SM): a second wave with half the
//   K a block ran slower (98 x 6561^2: 128 us at split 2, 104 blocks,
//   against 142 us at split 4, 208 blocks).
// * TMA needs 16-byte row strides.  K = 465, 961, 2211, 3240, 4489, 6561
//   are odd or not multiples of 4, so the solver's f32 sector operands are
//   built with rows padded to 4 floats (models/eris.py, f32_rows); A may
//   have any row stride (the split pass reads it).
// * Measured (chip_smoke.py phase 3, H100 SXM at 700 W, us): 98 x 6561^2
//   125.8 (FFMA kernel 370.8, cuBLAS SGEMM 225.1), 98 x 3240^2 43.8 (99.1,
//   69.4), 294 x 6561^2 317.3 (1074.1, 560.6); at 98 x {465, 961}^2 it is
//   not faster than the FFMA kernel, which the planner keeps there.

#include <cooperative_groups.h>
#include <cuda.h>   // CUtensorMap and the encoder's types (no libcuda link)
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kBN = 128;              // rows of B per block, 64 per warpgroup
constexpr int kBK = 32;               // K per chunk: one 128-byte row
constexpr int kRowBytes = 128;
constexpr int kStages = 4;
constexpr int kConsumers = 256;       // two warpgroups
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kSplitThreads = 256;    // the split pass: a row's K per block
constexpr int kMaxGroups = 8;         // cm: row groups of A per cluster
constexpr int kMaxCluster = 16;       // cm * split (non-portable above 8)
constexpr int kMaxDevices = 64;
constexpr int kFlushK = 256;          // K per wgmma accumulator run
constexpr int kBTile = kBN * kRowBytes;        // 16 KB

// The tile of A's rows per block, wgmma's N: 104 (98 rows a lambda lane,
// padded to a multiple of 8) or 152 (two groups for 294 rows, 3 lanes).
template <int BM>
struct Width {
  static constexpr int kATile = BM * kRowBytes;
  // a stage: the B tile, A's hi tile, A's lo tile (three passes)
  static constexpr int kStageBytes = kBTile + 2 * kATile;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // the ring at a 1024-byte boundary (the swizzle's period), then the
  // full and empty barriers of each stage
  static constexpr int kSmemBytes = kRingBytes + 1024 + 2 * kStages * 8;
  static constexpr int kSlots = BM / 2;   // f32 accumulators a thread
  static_assert(kATile % 1024 == 0, "the swizzle's period");
  static_assert(kSlots * kConsumers == kBN * BM, "every output has a slot");
  static_assert(kRingBytes >= kBN * BM * 4, "ring too small for the partial");
  static_assert(kSmemBytes <= 232448, "over the block's shared memory");
};
static_assert(kBTile % 1024 == 0, "the swizzle's period");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of parity `parity` has completed; a wait that
// outlasts any launch (2^28 polls) traps, where a lost arrival would hang
// the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (unsigned n = 0; !mbar_try(bar, parity); ++n)
    if (n > (1u << 28)) __trap();
}

// Arrive on the barrier at the same offset in block `cta` of the cluster
// (CTA-scope release, as ladder_mm_tc.cu measured).
__device__ __forceinline__ void mbar_arrive_cluster(unsigned bar,
                                                    unsigned cta) {
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// ---- TMA -----------------------------------------------------------------

__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         int k, int row, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// The same box into the same offset of every block in `mask`.
__device__ __forceinline__ void tma_load_multicast(unsigned dst,
                                                   const CUtensorMap* map,
                                                   int k, int row,
                                                   unsigned bar,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar),
      "h"(mask)
      : "memory");
}

// ---- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major tile written by TMA with
// SWIZZLE_128B: rows of 128 bytes, 8-row groups 1024 bytes apart, layout
// type 1 (128-byte swizzle).  The k-th 8-deep step (32 bytes) adds 2 * k.
__device__ __forceinline__ uint64_t smem_desc(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keep register reads and writes from moving across the asynchronous wgmma.
template <int S>
__device__ __forceinline__ void pin(float (&d)[S]) {
#pragma unroll
  for (int e = 0; e < S; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// D (64 x 104) (+)= X (64 x 8, registers) Y (104 x 8, shared)^T, TF32 in.
// Lane 4g + t of warp w holds X[16w + g][t], X[16w + g + 8][t],
// X[16w + g][t + 4], X[16w + g + 8][t + 4].
__device__ __forceinline__ void wgmma_tf32(float (&d)[52],
                                           const unsigned (&x)[4],
                                           uint64_t dy, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51}, "
      "{%52, %53, %54, %55}, %56, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "l"(dy), "r"(accumulate)
      : "memory");
}

// The same, D (64 x 152).
__device__ __forceinline__ void wgmma_tf32(float (&d)[76],
                                           const unsigned (&x)[4],
                                           uint64_t dy, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %81, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n152k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75}, "
      "{%76, %77, %78, %79}, %80, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "l"(dy), "r"(accumulate)
      : "memory");
}

// f32 -> TF32 as cvt.rna.tf32.f32 (to nearest, ties away from zero), the
// low 13 bits cleared.
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xFFFFE000u;
}

// The lo part of x = hi + lo: rna_tf32(x - hi), or 0 where that is not
// finite (x Inf or NaN, or hi rounded to Inf).
__device__ __forceinline__ unsigned lo_tf32(float x, unsigned hi) {
  const float d = x - __uint_as_float(hi);
  return fabsf(d) <= 3.402823466e38f ? to_tf32(d) : 0u;
}

__device__ __forceinline__ float lds_f32(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// The split pass: A (M x K, row stride lda) into hi = rna_tf32(A) and, for
// three passes, lo = rna_tf32(A - hi), each (M x K) with row stride ldh
// (16-byte rows for TMA).  grid = (ceil(K / kSplitThreads), M).
template <int kPasses>
__global__ void __launch_bounds__(kSplitThreads)
split_a(const float* __restrict__ a, float* __restrict__ hi,
        float* __restrict__ lo, int K, int lda, int ldh) {
  const int k = blockIdx.x * kSplitThreads + threadIdx.x;
  if (k >= K) return;
  const size_t m = blockIdx.y;
  const float x = a[m * lda + k];
  const unsigned h = to_tf32(x);
  hi[m * ldh + k] = __uint_as_float(h);
  if (kPasses == 3) lo[m * ldh + k] = __uint_as_float(lo_tf32(x, h));
}

// The B fragments of one half chunk (k8 steps 2 * half and 2 * half + 1)
// for this warp, split into hi and lo on the way.  Element (r, k) of a
// swizzled row sits in 16-byte piece (k / 4) ^ (r % 8), and r % 8 = g for
// all of this lane's rows.  Lane 4g + t of warp w holds X[16w + g][t],
// X[16w + g + 8][t], X[16w + g][t + 4], X[16w + g + 8][t + 4] of a step.
struct Frag {
  unsigned hi[2][4], lo[2][4];
};

template <int kPasses>
__device__ __forceinline__ void load_half(Frag& f, unsigned sb, int half,
                                          int warp, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        const float x = lds_f32(sb + r * kRowBytes +
                                (((4 * half + 2 * kk + q) ^ g) << 4) + 4 * t);
        f.hi[kk][h + 2 * q] = to_tf32(x);
        if (kPasses == 3) f.lo[kk][h + 2 * q] = lo_tf32(x, f.hi[kk][h + 2 * q]);
      }
    }
  }
}

// Issue the wgmmas of one half chunk as one group: per k8 step lo_b hi_a,
// hi_b lo_a, then hi_b hi_a (three passes), or hi_b hi_a.  dh, dl: the A
// tile's hi and lo descriptors; accumulate = 0 starts a fresh run.
template <int kPasses, int S>
__device__ __forceinline__ void issue_half(float (&acc)[S],
                                           const Frag& f, uint64_t dh,
                                           uint64_t dl, int half,
                                           int accumulate) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int ks = 2 * half + kk;
    const int first = kk == 0 ? accumulate : 1;
    if (kPasses == 3) {
      wgmma_tf32(acc, f.lo[kk], dh + 2 * ks, first);
      wgmma_tf32(acc, f.hi[kk], dl + 2 * ks, 1);
      wgmma_tf32(acc, f.hi[kk], dh + 2 * ks, 1);
    } else {
      wgmma_tf32(acc, f.hi[kk], dh + 2 * ks, first);
    }
  }
  wgmma_commit();
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Slot e of consumer thread ct (warpgroup ct / 128, warp w, lane 4g + t)
// is D[64 (ct / 128) + 16 w + g + 8 ((e % 4) / 2)][8 (e / 4) + 2 t + e % 2]:
// D's row is B's (C's column), its column A's (C's row).
__device__ __forceinline__ int slot_b(int e, int ct) {
  return 64 * (ct / 128) + 16 * ((ct % 128) / 32) + (ct % 32) / 4 +
         8 * ((e % 4) / 2);
}
__device__ __forceinline__ int slot_a(int e, int ct) {
  return 8 * (e / 4) + 2 * (ct % 4) + e % 2;
}

// grid = (cm, ceil(N / kBN), split), clusters of (cm, 1, split): the cm
// blocks of one B tile take A's row groups and share the tile by
// multicast (nb boxes of kBN / nb rows), the split blocks of one output
// tile sum their partials.  Cluster rank x + cm z.
template <int kPasses, int BM>
__global__ void __launch_bounds__(kThreads, 1)
ladder_mm_f32tc(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tl,
                const __grid_constant__ CUtensorMap tb, float* __restrict__ c,
                int M, int N, int K, int cm, int nb, int split) {
  using W = Width<BM>;
  constexpr int kSlots = W::kSlots, kATile = W::kATile;
  constexpr int kStageBytes = W::kStageBytes;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_addr(smem_raw);
  const unsigned ring = (raw + 1023) & ~1023u;   // stage 0
  unsigned char* ring_p = smem_raw + (ring - raw);
  const unsigned full0 = ring + W::kRingBytes, empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int mx = blockIdx.x, n0 = blockIdx.y * kBN, s = blockIdx.z;
  const int m0 = mx * BM;
  const int chunks = (K + kBK - 1) / kBK;
  const int c0 = static_cast<int>(static_cast<long long>(s) * chunks / split);
  const int nch =
      static_cast<int>(static_cast<long long>(s + 1) * chunks / split) - c0;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned group0 = cluster.block_rank() - mx;   // rank of x = 0

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kConsumerWarps * cm);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();   // every barrier of the cluster is set before any use

  float tot[kSlots];   // the round-to-nearest sum of the accumulator runs
#pragma unroll
  for (int e = 0; e < kSlots; ++e) tot[e] = 0.f;

  if (tid < kConsumers) {
    // Consumers: per chunk the B fragments (split in registers) and the
    // wgmmas, in two half chunks of two k8 steps, each one wgmma group:
    // one half's fragments load while the other half's group runs, and
    // the two warpgroups meet on no barrier, so that one's loads also
    // overlap the other's tensor-core work.  A stage is released once
    // both halves of its chunk have completed.
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    constexpr int kFlushChunks = kFlushK / kBK;
    float acc[kSlots];
#pragma unroll
    for (int e = 0; e < kSlots; ++e) acc[e] = 0.f;
    const auto release = [&](int st) {
      // this warp is done with the stage: release it in every block of the
      // group (their producers multicast into it)
      __syncwarp();
      if (lane == 0)
        for (int j = 0; j < cm; ++j)
          mbar_arrive_cluster(empty0 + 8 * st, group0 + j);
    };
    const auto stage_b = [&](int i) {   // wait for chunk i: its B rows
      const int st = i % kStages;
      mbar_wait(full0 + 8 * st, (i / kStages) & 1);
      return ring + st * kStageBytes + wg * 64 * kRowBytes;
    };
    Frag f0, f1;
    load_half<kPasses>(f0, stage_b(0), 0, warp, g, t);
    for (int i = 0; i < nch; ++i) {
      const int st = i % kStages;
      const unsigned sb = ring + st * kStageBytes + wg * 64 * kRowBytes;
      const unsigned sa = ring + st * kStageBytes + kBTile;
      const uint64_t dh = smem_desc(sa), dl = smem_desc(sa + kATile);
      issue_half<kPasses>(acc, f0, dh, dl, 0, i % kFlushChunks != 0);
      wgmma_wait<1>();              // chunk i - 1 has completed
      if (i > 0) release((i - 1) % kStages);
      load_half<kPasses>(f1, sb, 1, warp, g, t);
      issue_half<kPasses>(acc, f1, dh, dl, 1, 1);
      wgmma_wait<1>();              // half 0 of chunk i has completed
      if (i + 1 < nch) {
        if ((i + 1) % kFlushChunks == 0) {
          // the run ends with chunk i: its sum into tot before chunk i + 1
          // starts a fresh accumulator
          wgmma_wait<0>();
          pin(acc);
#pragma unroll
          for (int e = 0; e < kSlots; ++e) tot[e] += acc[e];
        }
        load_half<kPasses>(f0, stage_b(i + 1), 0, warp, g, t);
      }
    }
    wgmma_wait<0>();
    pin(acc);
    release((nch - 1) % kStages);
#pragma unroll
    for (int e = 0; e < kSlots; ++e) tot[e] += acc[e];
    if (split == 1) {
#pragma unroll
      for (int e = 0; e < kSlots; ++e) {
        const int r = m0 + slot_a(e, tid), cl = n0 + slot_b(e, tid);
        if (r < M && cl < N) c[static_cast<size_t>(r) * N + cl] = tot[e];
      }
    }
  } else {
    // the producer warp (lane 0 issues): this block's rows of A's hi (and
    // lo), and boxes mx, mx + cm, ... of the B tile for the whole group
    const int box = kBN / nb;
    const uint16_t mask = static_cast<uint16_t>(((1u << cm) - 1) << group0);
    for (int i = 0; i < nch; ++i) {
      const int st = i % kStages;
      if (i >= kStages) mbar_wait(empty0 + 8 * st, (i / kStages - 1) & 1);
      if (tid == kConsumers) {
        const unsigned full = full0 + 8 * st;
        mbar_expect_tx(full, kBTile + (kPasses == 3 ? 2 : 1) * kATile);
        const int k = (c0 + i) * kBK;
        const unsigned sb = ring + st * kStageBytes;
        tma_load(sb + kBTile, &ta, k, m0, full);
        if (kPasses == 3) tma_load(sb + kBTile + kATile, &tl, k, m0, full);
        for (int j = mx; j < nb; j += cm) {
          if (cm == 1)
            tma_load(sb + j * box * kRowBytes, &tb, k, n0 + j * box, full);
          else
            tma_load_multicast(sb + j * box * kRowBytes, &tb, k,
                               n0 + j * box, full, mask);
        }
      }
      __syncwarp();
    }
  }

  if (split > 1) {
    // Each block leaves its f32 partial in its own ring (slot e of thread
    // t at e * kConsumers + t); block z of the output tile then sums
    // element slice z over the blocks 0..split-1 in that order.
    __syncthreads();                  // every wgmma is done with the ring
    float* part = reinterpret_cast<float*>(ring_p);
    if (tid < kConsumers) {
#pragma unroll
      for (int e = 0; e < kSlots; ++e) part[e * kConsumers + tid] = tot[e];
    }
    cluster.sync();                   // every partial of the tile is in place
    constexpr int kTile = kBN * BM;
    const int lo = static_cast<int>(static_cast<long long>(s) * kTile / split);
    const int hi =
        static_cast<int>(static_cast<long long>(s + 1) * kTile / split);
    for (int i = lo + tid; i < hi; i += kThreads) {
      const int e = i / kConsumers, t = i % kConsumers;
      const int r = m0 + slot_a(e, t), cl = n0 + slot_b(e, t);
      if (r >= M || cl >= N) continue;
      float v = 0.f;
      for (int ss = 0; ss < split; ++ss)
        v += cluster.map_shared_rank(part, mx + cm * ss)[i];
      c[static_cast<size_t>(r) * N + cl] = v;
    }
  }
  // no block leaves while a peer may still arrive on its barriers, write
  // into its ring or read its partial
  if (cm * split > 1) cluster.sync();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 2-D map of a (rows, K) f32 operand with row stride ld elements, boxes
// of one 128-byte row of K by box_rows rows, SWIZZLE_128B; what lies past
// the rows or K reads as zero.
CUresult encode(EncodeTiled fn, CUtensorMap* map, const float* p, int rows,
                int K, int ld, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int kEncodeError = 10000;   // + the CUresult of a failed encode

template <int kPasses, int BM>
int launch(int device, const float* a, const float* b, float* c,
           float* scratch, int M, int N, int K, int lda, int ldb, int bn,
           int bk, int cm, int split, void* stream) {
  using W = Width<BM>;
  // The planner's tile must be this kernel's; cm must be the row groups of
  // A and cm * split fit a cluster; split must leave every block at least
  // one chunk (or be 1); TMA needs 16-byte aligned bases and row strides
  // (A is read by the split pass, which writes TMA rows into scratch).
  const int chunks = (K + kBK - 1) / kBK;
  const int n_tiles = (N + kBN - 1) / kBN;
  const int ldh = (K + 3) / 4 * 4;   // the split rows' stride
  const bool aligned = (static_cast<size_t>(ldb) * 4) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(scratch) % 16 == 0;
  if (bn != kBN || bk != kBK || M < 1 || N < 1 || K < 0 ||
      lda < K || ldb < K || (K > 0 && !aligned) || split < 1 || cm < 1 ||
      cm > kMaxGroups || cm != (M + BM - 1) / BM ||
      cm * split > kMaxCluster || split > (chunks > 1 ? chunks : 1) ||
      n_tiles > 65535 || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 0)   // an empty sum: no operand row is read
    return static_cast<int>(
        cudaMemsetAsync(c, 0, static_cast<size_t>(M) * N * sizeof(float), st));
  float* hi = scratch;
  float* lo = scratch + static_cast<size_t>(M) * ldh;
  split_a<kPasses><<<dim3((K + kSplitThreads - 1) / kSplitThreads, M),
                     kSplitThreads, 0, st>>>(a, hi, lo, K, lda, ldh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int nb = 1;   // B boxes per tile: cm rounded up to a power of two
  while (nb < cm) nb *= 2;
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap ta, tl, tb;
  CUresult res = encode(fn, &ta, hi, M, K, ldh, BM);
  if (res == CUDA_SUCCESS)
    res = encode(fn, &tl, kPasses == 3 ? lo : hi, M, K, ldh, BM);
  if (res == CUDA_SUCCESS) res = encode(fn, &tb, b, N, K, ldb, kBN / nb);
  if (res != CUDA_SUCCESS) return kEncodeError + static_cast<int>(res);
  static bool configured[kMaxDevices] = {};   // per instantiation and device
  if (!configured[device]) {
    err = cudaFuncSetAttribute(ladder_mm_f32tc<kPasses, BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               W::kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ladder_mm_f32tc<kPasses, BM>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cm, n_tiles, split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = W::kSmemBytes;
  cfg.stream = st;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cm;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = split;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ladder_mm_f32tc<kPasses, BM>, ta, tl, tb, c, M,
                           N, K, cm, nb, split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The instance of A's row tile `bm`: 104 (both passes) or 152 (three).
template <int kPasses>
int launch_bm(int device, const float* a, const float* b, float* c,
              float* scratch, int M, int N, int K, int lda, int ldb, int bm,
              int bn, int bk, int cm, int split, void* stream) {
  if (bm == 104)
    return launch<kPasses, 104>(device, a, b, c, scratch, M, N, K, lda, ldb,
                                bn, bk, cm, split, stream);
  if (kPasses == 3 && bm == 152)
    return launch<3, 152>(device, a, b, c, scratch, M, N, K, lda, ldb, bn,
                          bk, cm, split, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface for ctypes.  Each returns the cudaError_t of the launch
// (0 on success), or 10000 + the CUresult of a tensor map that could not
// be encoded.  The caller allocates c (M x N, contiguous) and the scratch
// of the split pass (two, for three passes, or one block of M rows of
// ceil4(K) floats, 16-byte aligned) and owns the stream; lda and ldb are
// the operands' row strides in elements; bm (A's rows per group), bn (B's
// rows per tile), bk, cm (the row groups of A) and split are the
// planner's, checked against this build's tile.
extern "C" int ecw_ladder_mm_f32_tc3(int device, const float* a,
                                     const float* b, float* c, float* scratch,
                                     int M, int N, int K, int lda, int ldb,
                                     int bm, int bn, int bk, int cm,
                                     int split, void* stream) {
  return launch_bm<3>(device, a, b, c, scratch, M, N, K, lda, ldb, bm, bn,
                      bk, cm, split, stream);
}

extern "C" int ecw_ladder_mm_tf32_tc1(int device, const float* a,
                                      const float* b, float* c,
                                      float* scratch, int M, int N, int K,
                                      int lda, int ldb, int bm, int bn,
                                      int bk, int cm, int split,
                                      void* stream) {
  return launch_bm<1>(device, a, b, c, scratch, M, N, K, lda, ldb, bm, bn,
                      bk, cm, split, stream);
}
