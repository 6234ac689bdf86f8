// Tensor-core variants of the ladder NT GEMM for Hopper (sm_90a):
//
//     C[m, n] = sum_k A[m, k] * B[n, k]
//
// A (M, K) and B (N, K) row-major, contiguous along K, with row strides
// (lda, ldb) that are multiples of 16 bytes; C (M, N) contiguous; f32
// accumulation:
//
// * TF32: f32 operands rounded to TF32 as cvt.rna.tf32.f32 rounds them,
//   wgmma.m64n128k8.f32.tf32.tf32, f32 out.  The solver's 'high' and
//   'default' precision modes.
// * BF16: bf16 operands, wgmma.m64n128k16.f32.bf16.bf16, the f32 sum
//   rounded once to bf16 on the way out, as the Pallas kernel writes its
//   f32 scratch tile in the operands' dtype.  The solver's 'bf16' mode.
//
// Replaces the TPU kernel ecw_cc_tpu/ops/ladder.py::_ladder_mm_pallas for
// the operands its reduced-precision modes give it: the JAX loop runs that
// kernel's dot on bf16 operands under iter_precision='bf16'
// (ecw_cc_tpu/solvers/gs.py:922-936) and at reduced matmul precision under
// 'high' and 'default' (:938-955).  The f32 (FFMA) and f64 (DMMA) kernels
// are in ladder_mm.cu.
//
// Where it runs: every ladder product of ecw_cc_torch/ops/ladder.py
// (_packed_mm, _sector_mm, dense_ladder) inside a Solver_CCSD iteration
// under those modes: M = 98-392 rows (tau and lambda row pairs) by
// N = K = 465-13041 (vvvv pairs).
//
// What bounds it.  At the packed cc-pVTZ shape 392 x 13041 x 13041 (133
// GFLOP) the tensor cores: 0.27 ms at TF32's 494 TFLOP/s and 0.135 ms at
// bf16's 989, against 0.20 (f32) and 0.10 ms (bf16) to read B (680 / 340
// MB) once at 3.35 TB/s.  So each B tile must come from device memory once
// and the tensor cores must be fed without the issue slots of per-element
// copies and conversions.  At the 98-row sector shapes, latency and the
// launch.  The design:
//
// * A 128 x 128 output tile per block: two consumer warpgroups, each 64
//   rows (wgmma m64n128, 64 f32 accumulators a thread), and one producer
//   warp.  K moves in chunks of one 128-byte swizzled row (32 f32 or 64
//   bf16) through a ring of kStages = 6 chunks (32 KB each: 16 KB of A, 16
//   KB of B), filled by TMA (cp.async.bulk.tensor.2d, SWIZZLE_128B) and
//   handed over by mbarriers: a full barrier per stage that the TMA bytes
//   complete, an empty barrier per stage that the consumer warps arrive
//   on once their wgmmas have read it.  96 KB of B in flight per block.
// * B from device memory once per launch: the blocks of one N tile that
//   differ in M (4 at M = 392, 2 at 196, 1 at 98) form a thread block
//   cluster.  Block r of that M group loads rows [r, r + 1) * 128 / cm of
//   the B tile and multicasts them into the same stage of every block of
//   the group, so each B byte leaves L2 once per launch; a stage is free
//   for the next load only when the consumers of every block of the group
//   have released it (remote mbarrier arrivals).  A (20 MB at 392 x 13041)
//   is read by each of the N / 128 N tiles: 2.0 GB of L2 traffic at
//   392 x 13041^2, where the 112 x 64 mma.sync tile read it 4.2 GB and B
//   4 times from device memory (2.7 GB).
// * Measured (tools/tc_kernel_variants.py, H100 SXM at 700 W): at
//   392 x 13041^2 the TMA pipeline alone (no wgmma) takes about 0.67 ms
//   (TF32) and 0.34 ms (BF16) with the 4-block multicast, 1.17 and 0.59
//   ms without it (cm = 1, split 4: B then leaves L2 once per row tile);
//   the full kernel 1.07 and 0.45 ms.  The consumers' remote arrivals
//   with a cluster-scope release made it 4.1-4.7x slower; TF32 A rounded
//   in shared memory (both operands by descriptor) was 10% slower, and a
//   wgmma pipeline one group deep was slower too (ptxas serialised it,
//   C7518).
// * K split across the blocks of the cluster (its z extent) where the
//   tiles alone do not fill the card (the 98-row sector shapes), summed in
//   f32 in the fixed order 0..split-1 through distributed shared memory:
//   no atomics, so a launch is bitwise repeatable and replays in a graph.
//   The planner (kernels/ladder_mm.py plan) keeps cm * split <= 8.
// * TF32 rounding.  wgmma reads raw f32 bits by dropping the low 13, so
//   the operands are rounded first: A in registers (its fragments loaded
//   from the swizzled ring, cvt.rna, then the register-A form of wgmma); B
//   once per solve by the caller (kernels/ladder_mm.py tf32_rows), or, for
//   a B the caller did not round (round_b = 1: the dense route's view of
//   the whole vvvv block, never copied), in shared memory as it arrives,
//   ordered before the wgmma by fence.proxy.async.
// * The tensor cores' f32 accumulation is not round-to-nearest: one
//   accumulator over K = 13041 drifted 3.1e-5 max|C| from the plain
//   version (measured, TF32, on the mma.sync design).  So each run of
//   kFlushK = 256 of K starts a fresh wgmma accumulator, and its sum is
//   added into a second set of f32 registers with ordinary
//   (round-to-nearest) adds.

#include <cooperative_groups.h>
#include <cuda.h>   // CUtensorMap and the encoder's types (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 128;              // output rows per block, 64 per warpgroup
constexpr int kBN = 128;              // output columns per block
constexpr int kRowBytes = 128;        // one ring row: a 128-byte swizzle span
constexpr int kStages = 6;
constexpr int kConsumers = 256;       // two warpgroups
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kMaxCluster = 8;        // cm * split, portable cluster size
constexpr int kMaxDevices = 64;
constexpr int kFlushK = 256;          // K per wgmma accumulator run
constexpr int kTileBytes = kBM * kRowBytes;   // A and B tiles alike
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kRingBytes = kStages * kStageBytes;
// the ring at a 1024-byte boundary (the swizzle's period), then the barriers
constexpr int kSmemBytes = kRingBytes + 1024 + 2 * kStages * 8;
constexpr int kSlots = kBN / 2;       // f32 accumulators a thread (m64n128)
static_assert(kBM == kBN, "one box size for the A and B tiles");
static_assert(kSlots * kConsumers == kBM * kBN, "every output has one slot");
static_assert(kRingBytes >= kBM * kBN * 4, "ring too small for the partial");

using bf16 = __nv_bfloat16;

template <typename T>
struct Tc;
template <>
struct Tc<float> {
  static constexpr int kBK = kRowBytes / 4;   // 32 of K per chunk
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Tc<bf16> {
  static constexpr int kBK = kRowBytes / 2;   // 64 of K per chunk
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

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

// Wait until the phase of parity `parity` of the barrier has completed.
// A wait that outlasts any launch (2^28 polls, seconds) traps: a launch
// fault that the next synchronisation reports, where a lost arrival would
// hang the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (unsigned n = 0; !mbar_try(bar, parity); ++n)
    if (n > (1u << 28)) __trap();
}

// Arrive on the barrier at the same offset in block `cta` of the cluster,
// with the default (CTA-scope) release: a cluster-scope release here made
// the 392 x 13041^2 launch 4.1-4.7x slower (measured).
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

// The same box into the same offset of every block in `mask`, completing
// bytes on the barrier at `bar`'s offset in each.
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
// SWIZZLE_128B: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the
// 128-byte swizzle (layout type 1).  The k-th 32-byte step along K adds
// 2 * k to the start address field.
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving register reads and writes across the
// asynchronous wgmma (its operands are written or read in the background).
__device__ __forceinline__ void pin(float (&d)[kSlots]) {
#pragma unroll
  for (int e = 0; e < kSlots; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// D (64 x 128) (+)= A (64 x 8, registers) B (128 x 8, shared)^T, TF32 in.
// Lane 4g + t of warp w holds A[16w + g][t], A[16w + g + 8][t],
// A[16w + g][t + 4], A[16w + g + 8][t + 4].
__device__ __forceinline__ void wgmma_tf32(float (&d)[kSlots],
                                           const unsigned (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate)
      : "memory");
}

// D (64 x 128) (+)= A (64 x 16, shared) B (128 x 16, shared)^T, bf16 in.
__device__ __forceinline__ void wgmma_bf16(float (&d)[kSlots], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// f32 -> TF32 as cvt.rna.tf32.f32 (to nearest, ties away from zero), the
// low 13 bits cleared.
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xFFFFE000u;
}

__device__ __forceinline__ float lds_f32(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// Round the staged B tile (kBN rows of 32 f32) to TF32 in place; the two
// consumer warpgroups take half each, then meet on named barrier 1.
__device__ __forceinline__ void round_b_tile(unsigned sb, int ctid) {
#pragma unroll
  for (int j = 0; j < kTileBytes / 16 / kConsumers; ++j) {
    const unsigned p = sb + 16 * (ctid + j * kConsumers);
    float x0, x1, x2, x3;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(x0), "=f"(x1), "=f"(x2), "=f"(x3)
                 : "r"(p));
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(p),
                 "r"(to_tf32(x0)), "r"(to_tf32(x1)), "r"(to_tf32(x2)),
                 "r"(to_tf32(x3))
                 : "memory");
  }
  // the generic-proxy writes before the async proxy's (wgmma's) reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// The wgmmas of one staged chunk for this warpgroup: sa its 64 rows of A,
// sb the B tile.  accumulate = 0 starts a fresh accumulator run.
__device__ __forceinline__ void mma_chunk(float (&acc)[kSlots], const float*,
                                          unsigned sa, unsigned sb,
                                          int accumulate, int warp, int g,
                                          int t) {
  // A fragments of the four k8 steps, rounded on the way: element (r, k)
  // of a swizzled row sits in 16-byte piece (k / 4) ^ (r % 8), and
  // r % 8 = g for all of this lane's rows.
  unsigned afr[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        afr[ks][h + 2 * q] = to_tf32(lds_f32(
            sa + r * kRowBytes + (((2 * ks + q) ^ g) << 4) + 4 * t));
      }
    }
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(afr[ks][i])::"memory");
  pin(acc);
  wgmma_fence();
  const uint64_t db = smem_desc(sb);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_tf32(acc, afr[ks], db + 2 * ks, ks > 0 || accumulate);
  wgmma_commit();
  wgmma_wait_all();
  pin(acc);
}

__device__ __forceinline__ void mma_chunk(float (&acc)[kSlots], const bf16*,
                                          unsigned sa, unsigned sb,
                                          int accumulate, int, int, int) {
  pin(acc);
  wgmma_fence();
  const uint64_t da = smem_desc(sa), db = smem_desc(sb);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_bf16(acc, da + 2 * ks, db + 2 * ks, ks > 0 || accumulate);
  wgmma_commit();
  wgmma_wait_all();
  pin(acc);
}

// Slot e of consumer thread ct (warpgroup ct / 128, warp w, lane 4g + t)
// is D[64 (ct / 128) + 16 w + g + 8 ((e % 4) / 2)][8 (e / 4) + 2 t + e % 2].
__device__ __forceinline__ int slot_row(int e, int ct) {
  return 64 * (ct / 128) + 16 * ((ct % 128) / 32) + (ct % 32) / 4 +
         8 * ((e % 4) / 2);
}
__device__ __forceinline__ int slot_col(int e, int ct) {
  return 8 * (e / 4) + 2 * (ct % 4) + e % 2;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// grid = (ceil(M / kBM), ceil(N / kBN), split), clusters of (cm, 1, split):
// the cm blocks of one M group share each B tile by multicast, and the
// split blocks of one output tile sum their partials.  Cluster rank
// x + cm z.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ladder_mm_tc(const __grid_constant__ CUtensorMap ta,
             const __grid_constant__ CUtensorMap tb, T* __restrict__ c, int M,
             int N, int K, int cm, int split, int round_b) {
  constexpr int kBK = Tc<T>::kBK;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_addr(smem_raw);
  const unsigned ring = (raw + 1023) & ~1023u;   // stage 0
  unsigned char* ring_p = smem_raw + (ring - raw);
  const unsigned full0 = ring + kRingBytes, empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN, s = blockIdx.z;
  const int chunks = (K + kBK - 1) / kBK;
  const int c0 = static_cast<int>(static_cast<long long>(s) * chunks / split);
  const int nch =
      static_cast<int>(static_cast<long long>(s + 1) * chunks / split) - c0;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned mx = rank % cm;        // place in the M group
  const unsigned group0 = rank - mx;    // the group's first rank

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
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    float acc[kSlots];
#pragma unroll
    for (int e = 0; e < kSlots; ++e) acc[e] = 0.f;
    constexpr int kFlushChunks = kFlushK / kBK;
    for (int i = 0; i < nch; ++i) {
      const int st = i % kStages;
      mbar_wait(full0 + 8 * st, (i / kStages) & 1);
      const unsigned sa = ring + st * kStageBytes + wg * 64 * kRowBytes;
      const unsigned sb = ring + st * kStageBytes + kTileBytes;
      if (sizeof(T) == 4 && round_b) round_b_tile(sb, tid);
      mma_chunk(acc, static_cast<const T*>(nullptr), sa, sb,
                i % kFlushChunks != 0, warp, lane / 4, lane % 4);
      // this warp has read the stage: release it in every block of the
      // M group (their producers multicast into it)
      __syncwarp();
      if (lane == 0)
        for (int j = 0; j < cm; ++j) mbar_arrive_cluster(empty0 + 8 * st,
                                                         group0 + j);
      if ((i + 1) % kFlushChunks == 0 || i + 1 == nch) {
#pragma unroll
        for (int e = 0; e < kSlots; ++e) tot[e] += acc[e];
      }
    }
    if (split == 1) {
#pragma unroll
      for (int e = 0; e < kSlots; ++e) {
        const int r = m0 + slot_row(e, tid), cl = n0 + slot_col(e, tid);
        if (r < M && cl < N) store(c + static_cast<size_t>(r) * N + cl, tot[e]);
      }
    }
  } else {
    // the producer warp (lane 0 issues): this block's A tile, and its
    // slice of the B tile for the whole M group
    const int slice = kBN / cm;
    const uint16_t mask = static_cast<uint16_t>(((1u << cm) - 1) << group0);
    for (int i = 0; i < nch; ++i) {
      const int st = i % kStages;
      if (i >= kStages) mbar_wait(empty0 + 8 * st, (i / kStages - 1) & 1);
      if (tid == kConsumers) {
        const unsigned full = full0 + 8 * st;
        mbar_expect_tx(full, kStageBytes);
        const int k = (c0 + i) * kBK;
        const unsigned sa = ring + st * kStageBytes;
        tma_load(sa, &ta, k, m0, full);
        const unsigned sb = sa + kTileBytes + mx * slice * kRowBytes;
        if (cm == 1)
          tma_load(sb, &tb, k, n0, full);
        else
          tma_load_multicast(sb, &tb, k, n0 + mx * slice, full, mask);
      }
      __syncwarp();
    }
  }

  if (split > 1) {
    // Each block leaves its f32 partial in its own ring (slot e of thread
    // t at e * kConsumers + t); block z of the output tile then sums
    // element slice z over the blocks 0..split-1 in that order, and rounds
    // once.
    __syncthreads();                  // every wgmma is done with the ring
    float* part = reinterpret_cast<float*>(ring_p);
    if (tid < kConsumers) {
#pragma unroll
      for (int e = 0; e < kSlots; ++e) part[e * kConsumers + tid] = tot[e];
    }
    cluster.sync();                   // every partial of the tile is in place
    constexpr int kTile = kBM * kBN;
    const int lo = static_cast<int>(static_cast<long long>(s) * kTile / split);
    const int hi =
        static_cast<int>(static_cast<long long>(s + 1) * kTile / split);
    for (int i = lo + tid; i < hi; i += kThreads) {
      const int e = i / kConsumers, t = i % kConsumers;
      const int r = m0 + slot_row(e, t), cl = n0 + slot_col(e, t);
      if (r >= M || cl >= N) continue;
      float v = 0.f;
      for (int ss = 0; ss < split; ++ss)
        v += cluster.map_shared_rank(part, mx + cm * ss)[i];
      store(c + static_cast<size_t>(r) * N + cl, v);
    }
  }
  // no block leaves while a peer may still arrive on its barriers or read
  // its partial
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

// The 2-D map of a (rows, K) operand with row stride ld elements, boxes of
// one 128-byte row by box_rows rows, SWIZZLE_128B; what lies past the rows
// or K reads as zero.
template <typename T>
CUresult encode(EncodeTiled fn, CUtensorMap* map, const T* p, int rows, int K,
                int ld, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(Tc<T>::kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, Tc<T>::kType, 2, const_cast<T*>(p), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int kEncodeError = 10000;   // + the CUresult of a failed encode

template <typename T>
int launch(int device, const T* a, const T* b, T* c, int M, int N, int K,
           int lda, int ldb, int bm, int bn, int bk, int cm, int split,
           int round_b, void* stream) {
  // The planner's tile must be this kernel's; cm must divide the M tiles
  // and cm * split fit a portable cluster; split must leave every block at
  // least one chunk (or be 1); TMA needs 16-byte aligned bases and row
  // strides.
  constexpr int kBK = Tc<T>::kBK;
  const int chunks = (K + kBK - 1) / kBK;
  const int m_tiles = (M + kBM - 1) / kBM, n_tiles = (N + kBN - 1) / kBN;
  const bool aligned =
      (static_cast<size_t>(lda) * sizeof(T)) % 16 == 0 &&
      (static_cast<size_t>(ldb) * sizeof(T)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (bm != kBM || bn != kBN || bk != kBK || M < 1 || N < 1 || K < 0 ||
      lda < K || ldb < K || (K > 0 && !aligned) || split < 1 || cm < 1 ||
      (cm & (cm - 1)) != 0 || m_tiles % cm != 0 ||
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
        cudaMemsetAsync(c, 0, static_cast<size_t>(M) * N * sizeof(T), st));
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap ta, tb;
  CUresult res = encode(fn, &ta, a, M, K, lda, kBM);
  if (res == CUDA_SUCCESS) res = encode(fn, &tb, b, N, K, ldb, kBN / cm);
  if (res != CUDA_SUCCESS) return kEncodeError + static_cast<int>(res);
  static bool configured[kMaxDevices] = {};   // per instantiation and device
  if (!configured[device]) {
    err = cudaFuncSetAttribute(ladder_mm_tc<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m_tiles, n_tiles, split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = st;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cm;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = split;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ladder_mm_tc<T>, ta, tb, c, M, N, K, cm,
                           split, round_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Each returns the cudaError_t of the launch
// (0 on success), or 10000 + the CUresult of a tensor map that could not
// be encoded.  The caller allocates c (M x N, contiguous) and owns the
// stream; lda and ldb are the operands' row strides in elements; bm/bn/bk,
// cm (blocks of an M group) and split are the planner's, checked against
// this build's tile.  round_b = 1: B is raw f32, rounded to TF32 in the
// kernel (TF32 only; a bf16 B is taken as it is).
extern "C" int ecw_ladder_mm_tf32(int device, const float* a, const float* b,
                                  float* c, int M, int N, int K, int lda,
                                  int ldb, int bm, int bn, int bk, int cm,
                                  int split, int round_b, void* stream) {
  return launch<float>(device, a, b, c, M, N, K, lda, ldb, bm, bn, bk, cm,
                       split, round_b, stream);
}

extern "C" int ecw_ladder_mm_bf16(int device, const void* a, const void* b,
                                  void* c, int M, int N, int K, int lda,
                                  int ldb, int bm, int bn, int bk, int cm,
                                  int split, int round_b, void* stream) {
  return launch<bf16>(device, static_cast<const bf16*>(a),
                      static_cast<const bf16*>(b), static_cast<bf16*>(c), M,
                      N, K, lda, ldb, bm, bn, bk, cm, split, 0, stream);
}
