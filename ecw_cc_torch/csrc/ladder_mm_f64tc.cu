// The f64 ladder NT GEMM on Hopper's FP64 tensor cores (sm_90a), fed by TMA:
//
//     C[m, n] = sum_k A[m, k] * B[n, k]
//
// A (M, K) and B (N, K) row-major, contiguous along K, with row strides lda
// and ldb that are multiples of 16 bytes (an even number of doubles); C
// (M, N) contiguous; f64 operands, products and sums.
//
// Computes what ecw_cc_tpu/ops/ladder.py::_ladder_mm_pallas computes, for
// the f64 products of ECW's default dtype: the packed route's stacked GEMM
// (392 x 1891^2 at C2H2/cc-pVDZ, 392 x 13041^2 at cc-pVTZ, 196 rows in the
// target builds), the dense ladder of refine=True's f64 polish (196 x
// 3844^2 at cc-pVDZ, 196 x 26244^2 at cc-pVTZ, two a polish iteration) and
// the f64 EOM sigmas, where the planner routes them (kernels/ladder_mm.py
// f64tc_rule).  csrc/ladder_mm.cu's 'dmma' kernel, built for the cc-pVDZ
// sector GEMMs (98 x {465, 961}^2), keeps the small shapes.
//
// What bounds it.  These products are the card's FP64 tensor-core work:
// 2MNK at 67 TFLOP/s is 1.99 ms at 392 x 13041^2 and 4.03 ms at 196 x
// 26244^2, against 0.41 and 1.65 ms to read B once at 3.35 TB/s.  The
// 112 x 32 tile of ladder_mm.cu carries 6.2 operations per byte it stages
// (A re-read from L2 by every 32-column tile, one 8-byte cp.async an
// element) and ran at about 3.8 TB/s of operand traffic, 34-35% of the
// operations bound.  So the operands must reach the SMs with far fewer
// bytes per operation and no per-element issue cost, and the DMMA pipes
// must be kept fed from registers.  The design, choice by choice:
//
// * A 104 x 128 output tile per block (104 rows of A, 128 of B): 2 * 104 *
//   128 / (232 * 8) = 14.3 operations per staged byte.  104 = 98 padded to
//   a multiple of 8, and C's rows (A's) are DMMA's n8 side, so M = 196 and
//   392 (two and four lambda-stacked groups of 98 rows) waste 6% of the
//   tensor work, where 16-row tiles (112) wasted 12.5% and 128 rows 23%.
// * Eight consumer warps, two per SM sub-partition, each owning 16 rows of
//   B (DMMA's m16 side) against all 104 rows of A: 13 independent 16 x 8
//   accumulators, 52 doubles a thread.  Per 16-deep chunk a warp reads 30
//   16-byte words a lane for 13 mma.sync.m16n8k16.f64.  Earlier versions
//   of this file, timed in turns by tools/f64tc_splits.py --variants on an
//   H100 SXM at 700 W, settled the rest: m16n8k16 ran 2-8% faster than
//   m16n8k8 and m16n8k4, in spite of ~100 bytes of spills at the 168
//   registers ptxas allows 9 warps (a third warp on one sub-partition); a
//   producer warpgroup giving its registers to the consumers (setmaxnreg)
//   spilled 1.3 KB and ran 3.8x slower; thread 0 issuing the loads between
//   its chunks (8 warps, 181 registers, no spills) ran 12-15% slower than
//   the producer warp.
// * Operands by TMA (cp.async.bulk.tensor.2d, SWIZZLE_128B: a chunk of 16
//   doubles is one 128-byte row, so the fragment loads, 16 bytes a lane,
//   hit 8 distinct bank groups per quarter warp) into a ring of kStages
//   stages with a full and an empty mbarrier each.  Within a chunk lane t
//   takes k = 4t..4t+3 of both operands (a permutation of K that A and B
//   share), so its fragments are two 16-byte loads per row.  The ragged
//   edges (M, N, K past the tensor) arrive as zeros.
// * B from device memory about once: the row tiles of one B tile are
//   neighbours in the grid's order and run together, and the second reads
//   hit L2.  Clustering them to multicast B (csrc/ladder_mm_tc.cu's
//   scheme) ran as fast or up to 6% slower in an earlier version, and its
//   clusters of 4 fit 120 blocks at once, not 132.
// * Waves.  One block an SM: 392 x 13041^2 is 408 tiles, 3.1 waves of 132,
//   so a fourth wave runs 12 blocks.  K is split (the cluster's z extent)
//   by the planner's wave model (kernels/ladder_mm.py _f64tc_split), which
//   named the fastest split at every path shape: split 2 there, 816
//   blocks, 2.83 against 3.16 ms.  Partials are summed in the fixed order
//   0..split-1 through distributed shared memory, as ladder_mm.cu does:
//   no atomics, no workspace, so a launch is bitwise repeatable and a
//   graph replay equals it.
// * TMA needs 16-byte row strides: the f64 ladder operands are built with
//   rows padded to 2 doubles (kernels/ladder_mm.py f64_rows, ops/ladder.py
//   _pack_pairs and pack_vvvv, models/eris.py), and the wrapper copies, and
//   counts, an operand that lacks them.
// * Measured (tools/f64tc_splits.py, H100 SXM at 700 W, us; 'dmma',
//   cuBLAS DGEMM): 392 x 13041^2 2828 (5300, 3349), 196 x 26244^2 5829
//   (11516, 8752), 196 x 3844^2 130 (237, 143), 392 x 1891^2 71 (125, 99),
//   14 x 1891^2 25 (32, 20); below K = 1024 'dmma' is faster.

#include <cooperative_groups.h>
#include <cuda.h>   // CUtensorMap and the encoder's types (no libcuda link)
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 104;              // rows of A per block: 13 n8 tiles
constexpr int kBN = 128;              // rows of B per block: 16 per warp
constexpr int kBK = 16;               // K per chunk: one 128-byte row
constexpr int kRowBytes = 128;
constexpr int kStages = 6;
constexpr int kConsumerWarps = kBN / 16;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kNT = kBM / 8;          // n8 tiles of a warp
constexpr int kSlots = 4 * kNT;       // f64 accumulators a thread
constexpr int kATile = kBM * kRowBytes;
constexpr int kBTile = kBN * kRowBytes;
constexpr int kStageBytes = kATile + kBTile;
constexpr int kRingBytes = kStages * kStageBytes;
// the ring at a 1024-byte boundary (the swizzle's period), then the full
// and empty barriers of each stage
constexpr int kSmemBytes = kRingBytes + 1024 + 2 * kStages * 8;
constexpr int kMaxSplit = 16;         // blocks per cluster (non-portable
                                      // above 8)
constexpr int kMaxDevices = 64;
static_assert(kATile % 1024 == 0 && kBTile % 1024 == 0, "swizzle period");
static_assert(kSlots * kConsumers == kBM * kBN, "every output has a slot");
static_assert(kRingBytes >= kBM * kBN * 8, "ring too small for the partial");
static_assert(kSmemBytes <= 232448, "over the block's shared memory");

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

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

// ---- DMMA ----------------------------------------------------------------

// D (16 x 8) += X (16 x 16) Y (16 x 8) in f64.  Lane 4g + t holds X[g][t +
// 4i] and X[g + 8][t + 4i] (x[2i], x[2i + 1]), Y[t + 4i][g] (y[i]), i < 4,
// and D[g][2t..2t+1], D[g + 8][2t..2t+1].
__device__ __forceinline__ void dmma(double (&d)[4], const double (&x)[8],
                                     const double (&y)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(x[0]), "d"(x[1]), "d"(x[2]), "d"(x[3]), "d"(x[4]), "d"(x[5]),
        "d"(x[6]), "d"(x[7]), "d"(y[0]), "d"(y[1]), "d"(y[2]), "d"(y[3]));
}

// The 16-byte word `piece` of a swizzled 128-byte row: element (r, k) of
// a row sits in piece (k / 2) ^ (r % 8), and r % 8 = g for every row a
// lane reads.
__device__ __forceinline__ double2 word(const unsigned char* row, int piece,
                                        int g) {
  return *reinterpret_cast<const double2*>(row + ((piece ^ g) << 4));
}

// One staged chunk of this warp: its 16 rows of the B tile from xb (rows g
// and g + 8 of them), all rows of the A tile from ya (row g of each n8
// tile), one mma.sync.m16n8k16 per n8 tile.  The chunk's 16 of K go to
// lane t as k = 4t..4t+3 (pieces 2t and 2t + 1), the DMMA's k slots t + 4i
// taking them in order, for X and Y alike: a permutation of K that both
// operands share.
__device__ __forceinline__ void chunk(double (&acc)[kNT][4],
                                      const unsigned char* xb,
                                      const unsigned char* ya, int g, int t) {
  const unsigned char* xb8 = xb + 8 * kRowBytes;
  const double2 p0 = word(xb, 2 * t, g), p1 = word(xb, 2 * t + 1, g);
  const double2 q0 = word(xb8, 2 * t, g), q1 = word(xb8, 2 * t + 1, g);
  const double x[8] = {p0.x, q0.x, p0.y, q0.y, p1.x, q1.x, p1.y, q1.y};
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const unsigned char* row = ya + 8 * j * kRowBytes;
    const double2 y0 = word(row, 2 * t, g), y1 = word(row, 2 * t + 1, g);
    const double y[4] = {y0.x, y0.y, y1.x, y1.y};
    dmma(acc[j], x, y);
  }
}

// Slot (j, e) of consumer thread ct (warp w, lane 4g + t) is D[g + 8 (e /
// 2)][2t + e % 2] of warp w's n8 tile j: C's row (A's) 8j + 2t + e % 2, its
// column (B's) 16w + g + 8 (e / 2).
__device__ __forceinline__ int slot_a(int j, int e, int ct) {
  return 8 * j + 2 * (ct % 4) + e % 2;
}
__device__ __forceinline__ int slot_b(int e, int ct) {
  return 16 * (ct / 32) + (ct % 32) / 4 + 8 * (e / 2);
}

// grid = (ceil(M / kBM), ceil(N / kBN), split), clusters of (1, 1,
// split): the row tiles of one B tile are neighbours in the grid's order,
// so they run together and B leaves device memory about once; the split
// blocks of one output tile sum their partials.
__global__ void __launch_bounds__(kThreads, 1)
ladder_mm_f64tc(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb,
                double* __restrict__ c, int M, int N, int K, int split) {
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

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // every barrier is set before any use

  double acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0;

  if (tid < kConsumers) {
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    for (int i = 0; i < nch; ++i) {
      const int st = i % kStages;
      mbar_wait(full0 + 8 * st, (i / kStages) & 1);
      const unsigned char* stage = ring_p + st * kStageBytes;
      chunk(acc, stage + kATile + (16 * warp + g) * kRowBytes,
            stage + g * kRowBytes, g, t);
      __syncwarp();   // this warp is done with the stage: release it
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }
    if (split == 1) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m0 + slot_a(j, e, tid), cl = n0 + slot_b(e, tid);
          if (r < M && cl < N) c[static_cast<size_t>(r) * N + cl] = acc[j][e];
        }
    }
  } else {
    // the producer warp (lane 0 issues): this block's rows of A and of B
    for (int i = 0; i < nch; ++i) {
      const int st = i % kStages;
      if (i >= kStages) mbar_wait(empty0 + 8 * st, (i / kStages - 1) & 1);
      if (tid == kConsumers) {
        const unsigned full = full0 + 8 * st;
        const unsigned sa = ring + st * kStageBytes;
        const int k = (c0 + i) * kBK;
        mbar_expect_tx(full, kStageBytes);
        tma_load(sa, &ta, k, m0, full);
        tma_load(sa + kATile, &tb, k, n0, full);
      }
      __syncwarp();
    }
  }

  if (split > 1) {
    // Each block leaves its partial in its own ring (slot (j, e) of thread
    // t at (4 j + e) * kConsumers + t); block z of the output tile then
    // sums element slice z over the blocks 0..split-1 in that order.
    cg::cluster_group cluster = cg::this_cluster();
    __syncthreads();                  // every consumer is done with the ring
    double* part = reinterpret_cast<double*>(ring_p);
    if (tid < kConsumers) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[(4 * j + e) * kConsumers + tid] = acc[j][e];
    }
    cluster.sync();                   // every partial of the tile is in place
    constexpr int kTile = kBN * kBM;
    const int lo = static_cast<int>(static_cast<long long>(s) * kTile / split);
    const int hi =
        static_cast<int>(static_cast<long long>(s + 1) * kTile / split);
    for (int i = lo + tid; i < hi; i += kThreads) {
      const int slot = i / kConsumers, ct = i % kConsumers;
      const int r = m0 + slot_a(slot / 4, slot % 4, ct);
      const int cl = n0 + slot_b(slot % 4, ct);
      if (r >= M || cl >= N) continue;
      double v = 0.0;
      for (int ss = 0; ss < split; ++ss)
        v += cluster.map_shared_rank(part, ss)[i];
      c[static_cast<size_t>(r) * N + cl] = v;
    }
    cluster.sync();                   // no block leaves while it is read
  }
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

// The 2-D map of a (rows, K) f64 operand with row stride ld elements, boxes
// of one 128-byte row of K by box_rows rows, SWIZZLE_128B; what lies past
// the rows or K reads as zero.
CUresult encode(EncodeTiled fn, CUtensorMap* map, const double* p, int rows,
                int K, int ld, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) *
                                 sizeof(double)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 2, const_cast<double*>(p),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int kEncodeError = 10000;   // + the CUresult of a failed encode

// The kernel's attributes, set once per device: its dynamic shared memory
// and clusters of up to kMaxSplit blocks.
cudaError_t configure(int device) {
  static bool configured[kMaxDevices] = {};
  if (configured[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      ladder_mm_f64tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ladder_mm_f64tc,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  configured[device] = err == cudaSuccess;
  return err;
}

// The launch configuration of a grid with clusters of (1, 1, split).
cudaLaunchConfig_t config(dim3 grid, int split, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

int launch(int device, const double* a, const double* b, double* c, int M,
           int N, int K, int lda, int ldb, int bm, int bn, int bk, int split,
           void* stream) {
  // The planner's tile must be this kernel's; split must fit a cluster and
  // leave every block at least one chunk (or be 1); TMA needs 16-byte
  // aligned bases and row strides.
  const int chunks = (K + kBK - 1) / kBK;
  const int n_tiles = (N + kBN - 1) / kBN;
  const bool aligned = (static_cast<size_t>(lda) * 8) % 16 == 0 &&
                       (static_cast<size_t>(ldb) * 8) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (bm != kBM || bn != kBN || bk != kBK || M < 1 || N < 1 || K < 0 ||
      lda < K || ldb < K || (K > 0 && !aligned) || split < 1 ||
      split > kMaxSplit || split > (chunks > 1 ? chunks : 1) ||
      n_tiles > 65535 || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 0)   // an empty sum: no operand row is read
    return static_cast<int>(cudaMemsetAsync(
        c, 0, static_cast<size_t>(M) * N * sizeof(double), st));
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap ta, tb;
  CUresult res = encode(fn, &ta, a, M, K, lda, kBM);
  if (res == CUDA_SUCCESS) res = encode(fn, &tb, b, N, K, ldb, kBN);
  if (res != CUDA_SUCCESS) return kEncodeError + static_cast<int>(res);
  err = configure(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(
      dim3((M + kBM - 1) / kBM, n_tiles, split), split, st, &attr);
  err = cudaLaunchKernelEx(&cfg, ladder_mm_f64tc, ta, tb, c, M, N, K, split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Returns the cudaError_t of the launch (0
// on success), or 10000 + the CUresult of a tensor map that could not be
// encoded.  The caller allocates c (M x N, contiguous) and owns the
// stream; lda and ldb are the operands' row strides in elements (even);
// bm, bn, bk and split are the planner's, checked against this build's
// tile.
extern "C" int ecw_ladder_mm_f64_tc(int device, const double* a,
                                    const double* b, double* c, int M, int N,
                                    int K, int lda, int ldb, int bm, int bn,
                                    int bk, int split, void* stream) {
  return launch(device, a, b, c, M, N, K, lda, ldb, bm, bn, bk, split,
                stream);
}

// How many clusters of `split` blocks of the kernel the card holds at once
// (cudaOccupancyMaxActiveClusters), or -(the cudaError_t): the planner's
// wave sizes (kernels/ladder_mm.py F64TC_SLOTS).
extern "C" int ecw_ladder_mm_f64_tc_clusters(int device, int split) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = configure(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(dim3(1, 1, split), split, nullptr,
                                        &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, ladder_mm_f64tc, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
