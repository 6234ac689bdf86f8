// Hand-written Hopper (sm_90a) NT GEMM for the vvvv ladder of the ECW-CCSD
// solver:
//
//     C[m, n] = sum_k A[m, k] * B[n, k]
//
// with A (M, K) and B (N, K) both row-major and contiguous along K, so the
// symmetric <ab||ef> ladder operand is contracted without a transpose.
//
// Replaces the TPU kernel ecw_cc_tpu/ops/ladder.py::_ladder_mm_pallas.  That
// kernel zero-padded M and N to 128 and K to 512 and walked K as the
// innermost, sequential grid axis with the sum in a VMEM scratch tile.  Here
// the ragged M/N/K edges are masked in the loads and the store, no padded
// copy of either operand is made, and K is cut across blocks (split-K).
//
// Where it runs: ecw_cc_torch/ops/ladder.py::_sector_mm, the sector GEMMs of
// balanced_stacked_sectored_contract -- two launches per solver iteration
// under the closed-shell mirror symmetry, three without.  At C2H2/cc-pVDZ
// they are A (98 x 465) x B (465 x 465) and A (98 x 961) x B (961 x 961),
// in f32 on the solver's main run and in f64 in the parity solve.
//
// What bounds it at these shapes: latency and fixed costs, not FLOPs or
// bytes.  At 98 x 961 x 961 the work is 0.18 GFLOP (2.7 us at the f32
// CUDA-core peak, 2.7 us at the f64 tensor-core peak) and B is 3.7 MB in f32
// (1.1 us at 3.35 TB/s).  A 64 x 64 output tiling gives a few dozen blocks
// for 132 SMs, each walking all of K with nothing to hide its load latency.
// On an H100 a launch costs about 2.5 us before any work, and a launch in
// clusters about 3.6 us more at these shapes (measured), so the design
// below spends the split on parallelism and keeps every block's work in
// shared memory and registers.  The design, choice by choice:
//
// * One 112-row tile covers M = 98, so B streams from device memory once
//   and A (0.4 MB) is re-read from L2 by each column tile; a smaller M tile
//   would re-read B instead.  112 = 7 x 16 wastes 14 rows where 128 wasted
//   30.  In f32 the tile is 64 columns wide where that still fills the card
//   (half the re-reads of A, more FMAs per shared-memory load), else 32; in
//   f64 it is 32.  K is split across blocks in whole 16-deep chunks so that
//   the grid holds at least one full wave.  The planner in
//   ecw_cc_torch/kernels/ladder_mm.py picks width and split (f32: 16 x 16 =
//   256 blocks at N = K = 961, 15 x 16 = 240 at 465; f64: 31 x 8 = 248 and
//   15 x 16 = 240), and the kernel checks the tile it is handed.
// * Deterministic split-K in the same launch, through a thread block
//   cluster: the S blocks of one output tile form a cluster (S <= 16), each
//   leaves its partial tile in its own shared memory, and after a cluster
//   barrier block r sums slice r of the tile over the S partials in the
//   fixed order 0..S-1, reading them through distributed shared memory, and
//   writes it to C.  No workspace, no counters, no atomics, no memset or
//   reduce launch: the same inputs give bitwise the same C, and a captured
//   launch replays as it ran.  A reduction through a device-memory
//   workspace with a ticket per tile (the last block to arrive sums) was
//   measured first: reading partials that other SMs had just written cost
//   about 1.2 us per split, 8.7 us of a 19 us launch at S = 8 in f32.
// * Copies run ahead of the math: a ring of K chunks in dynamic shared
//   memory, filled with cp.async and commit/wait groups, so chunk
//   k + stages - 1 loads while chunk k is multiplied.  The copies are one
//   element wide (4-byte f32, 8-byte f64): K = 465 and 961 are odd, so the
//   operands' rows (1860 and 3844 bytes in f32) are not 16-byte aligned, and
//   16-byte cp.async or TMA would need a padded row stride in the solver's
//   SectoredVVVV layout.  16-byte copies were measured at K = 960 and
//   gained nothing, so element copies keep that layout as it is.
// * f32 stays on the CUDA cores in full f32 (no TF32, the solver's
//   'highest' mode): each thread owns 7 x 8 outputs (7 x 4 in the narrow
//   tile) and reads its A rows and B columns as float4 along K, 15 LDS.128
//   per 224 FFMA, where the 64 x 64 kernel this replaces did 8 scalar LDS
//   per 16 FFMA.  Shared-memory bandwidth, not the FMA pipes, limits the
//   math at such ratios (measured with an 8 x 4 tile).
// * f64 runs on the FP64 tensor cores (DMMA) with mma.sync.m16n8k4, which
//   ran at 59 TFLOP/s against 29 for m8n8k4 with four warps per SM; B
//   stored (N, K) row-major is exactly the .col operand.  Each warp owns 8
//   columns and the seven 16-row subtiles, skipping those past M; within a
//   16-deep chunk lane t takes k = 4t..4t+3 for the four k4 steps, so its
//   operands come as double2 loads along K.
// * Rows of the shared-memory ring are padded (f32 +4, f64 +2 elements) so
//   the vector loads of a warp are free of bank conflicts.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 112;       // output rows per block (all of M = 98)
constexpr int kBK = 16;        // K chunk, the unit of the ring and the split
constexpr int kThreads = 128;  // four warps
constexpr int kMaxSplit = 16;  // blocks per cluster (non-portable on H100)
constexpr int kMaxDevices = 64;

template <typename T>
struct Ring;
template <>
struct Ring<float> {
  static constexpr int kLd = kBK + 4;   // row stride in elements
  static constexpr int kStages = 4;
};
template <>
struct Ring<double> {
  static constexpr int kLd = kBK + 2;
  static constexpr int kStages = 3;
};

template <typename T, int BN>
struct Tile {
  static constexpr int kStageElems = (kBM + BN) * Ring<T>::kLd;
  static constexpr int kSlots = kBM * BN / kThreads;   // outputs per thread
  static constexpr int kSmemBytes =
      Ring<T>::kStages * kStageElems * static_cast<int>(sizeof(T));
  // The ring, once drained, holds the block's partial tile.
  static_assert(Ring<T>::kStages * kStageElems >= kBM * BN, "ring too small");
};

// One element, global -> shared; src-size 0 writes a zero (masked edge).
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* smem, const T* gmem,
                                              bool ok) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(gmem), "n"(static_cast<int>(sizeof(T))),
               "r"(ok ? static_cast<int>(sizeof(T)) : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Stage one K chunk [k0, k0 + kBK) of the A tile (kBM rows) and the B tile
// (BN rows) into shared memory, row-major with stride Ring<T>::kLd; what
// lies past M, N or K is zero-filled.
template <typename T, int BN>
__device__ __forceinline__ void load_chunk(T* s, const T* __restrict__ a,
                                           const T* __restrict__ b, int M,
                                           int N, int K, int m0, int n0,
                                           int k0, int tid) {
  constexpr int kLd = Ring<T>::kLd;
  constexpr int kRowsPerPass = kThreads / kBK;   // 8
  const int kk = tid % kBK;
  const int gk = k0 + kk;
  const bool k_ok = gk < K;
#pragma unroll
  for (int p = 0; p < (kBM + BN) / kRowsPerPass; ++p) {
    const int r = p * kRowsPerPass + tid / kBK;
    if (p < kBM / kRowsPerPass) {
      const int gm = m0 + r;
      const bool ok = k_ok && gm < M;
      cp_async_elem(s + r * kLd + kk,
                    ok ? a + static_cast<size_t>(gm) * K + gk : a, ok);
    } else {
      const int gn = n0 + r - kBM;
      const bool ok = k_ok && gn < N;
      cp_async_elem(s + r * kLd + kk,
                    ok ? b + static_cast<size_t>(gn) * K + gk : b, ok);
    }
  }
}

// The per-thread math of one staged chunk, and where each of a thread's
// kSlots accumulators sits in the kBM x BN output tile.
template <typename T, int BN>
struct Math;

// f32: thread (ty, tx) = (tid / 8, tid % 8) owns rows ty + 16 i (i < 7) and
// columns tx + 8 j (j < BN / 8); slot i * kTN + j.
template <int BN>
struct Math<float, BN> {
  static constexpr int kTM = kBM / 16;
  static constexpr int kTN = BN / 8;
  static __device__ __forceinline__ int row(int e, int tid) {
    return tid / 8 + 16 * (e / kTN);
  }
  static __device__ __forceinline__ int col(int e, int tid) {
    return tid % 8 + 8 * (e % kTN);
  }
  static __device__ __forceinline__ void chunk(
      const float* s, float (&acc)[Tile<float, BN>::kSlots], int tid,
      int /*rows*/, int /*cols*/) {
    constexpr int kLd = Ring<float>::kLd;
    const float* sa = s + (tid / 8) * kLd;
    const float* sb = s + (kBM + tid % 8) * kLd;
#pragma unroll
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      float4 av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        av[i] = *reinterpret_cast<const float4*>(sa + 16 * i * kLd + k4);
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        bv[j] = *reinterpret_cast<const float4*>(sb + 8 * j * kLd + k4);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          float& c = acc[i * kTN + j];
          c = fmaf(av[i].x, bv[j].x, c);
          c = fmaf(av[i].y, bv[j].y, c);
          c = fmaf(av[i].z, bv[j].z, c);
          c = fmaf(av[i].w, bv[j].w, c);
        }
    }
  }
};

// D (16 x 8) += A (16 x 4) B (4 x 8) in f64 on the tensor cores.  Lane
// l = 4g + t holds A[g][t], A[g + 8][t], B[t][g] and D[g][2t..2t+1],
// D[g + 8][2t..2t+1].  This shape runs at twice the rate of m8n8k4 on H100
// (measured: 59 against 29 TFLOP/s with four warps per SM).
__device__ __forceinline__ void dmma(double* d, double a0, double a1,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// f64 (32-column tile only): warp w owns columns 8w..8w+7 and the 16-row
// subtiles i < kBM / 16; lane l = 4g + t holds D[16i + g + 8(c/2)]
// [8w + 2t + c%2] of subtile i in slot 4i + c.
template <>
struct Math<double, 32> {
  static constexpr int kMS = kBM / 16;
  static __device__ __forceinline__ int row(int e, int tid) {
    return 16 * (e / 4) + (tid % 32) / 4 + 8 * ((e % 4) / 2);
  }
  static __device__ __forceinline__ int col(int e, int tid) {
    return 8 * (tid / 32) + 2 * (tid % 4) + e % 2;
  }
  static __device__ __forceinline__ void chunk(
      const double* s, double (&acc)[Tile<double, 32>::kSlots], int tid,
      int rows, int cols) {
    constexpr int kLd = Ring<double>::kLd;
    const int warp = tid / 32, lane = tid % 32;
    if (8 * warp >= cols) return;   // warp-uniform: none of it is in C
    const int row_subtiles = (rows + 15) / 16;
    const int g = lane / 4, t = lane % 4;
    // Lane t carries k = 4t + j of the chunk in k4 step j (A and B alike),
    // so its operands of steps 2h and 2h + 1 are one double2 along K.
    const double* sb = s + (kBM + 8 * warp + g) * kLd + 4 * t;
    const double2 bv[2] = {*reinterpret_cast<const double2*>(sb),
                           *reinterpret_cast<const double2*>(sb + 2)};
    const double* sa = s + g * kLd + 4 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double2 lo[kMS], hi[kMS];
#pragma unroll
      for (int i = 0; i < kMS; ++i)
        if (i < row_subtiles) {
          lo[i] = *reinterpret_cast<const double2*>(sa + 16 * i * kLd + 2 * h);
          hi[i] = *reinterpret_cast<const double2*>(sa + (16 * i + 8) * kLd +
                                                     2 * h);
        }
#pragma unroll
      for (int i = 0; i < kMS; ++i)
        if (i < row_subtiles) dmma(acc + 4 * i, lo[i].x, hi[i].x, bv[h].x);
#pragma unroll
      for (int i = 0; i < kMS; ++i)
        if (i < row_subtiles) dmma(acc + 4 * i, lo[i].y, hi[i].y, bv[h].y);
    }
  }
};

// grid = (ceil(N / BN), ceil(M / kBM), split), clusters of (1, 1, split):
// the split blocks of one output tile are one cluster.
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
ladder_mm_nt(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ c, int M, int N, int K, int split) {
  using Tl = Tile<T, BN>;
  using Mt = Math<T, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  constexpr int kStages = Ring<T>::kStages;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kBM;
  const int s = blockIdx.z;
  const int chunks = (K + kBK - 1) / kBK;
  const int c0 = static_cast<int>(static_cast<long long>(s) * chunks / split);
  const int c1 =
      static_cast<int>(static_cast<long long>(s + 1) * chunks / split);
  const int nch = c1 - c0;
  const int rows = min(kBM, M - m0);   // of this tile that are in C
  const int cols = min(BN, N - n0);

  T acc[Tl::kSlots];
#pragma unroll
  for (int e = 0; e < Tl::kSlots; ++e) acc[e] = T(0);

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nch)
      load_chunk<T, BN>(ring + st * Tl::kStageElems, a, b, M, N, K, m0, n0,
                        (c0 + st) * kBK, tid);
    cp_async_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<kStages - 2>();   // chunk ch has landed (this thread's part)
    __syncthreads();                // ... everyone's; stage ch-1 is free
    const int next = ch + kStages - 1;
    if (next < nch)
      load_chunk<T, BN>(ring + (next % kStages) * Tl::kStageElems, a, b, M,
                        N, K, m0, n0, (c0 + next) * kBK, tid);
    cp_async_commit();
    Mt::chunk(ring + (ch % kStages) * Tl::kStageElems, acc, tid, rows, cols);
  }

  if (split == 1) {
#pragma unroll
    for (int e = 0; e < Tl::kSlots; ++e) {
      const int r = Mt::row(e, tid), cl = Mt::col(e, tid);
      if (r < rows && cl < cols)
        c[static_cast<size_t>(m0 + r) * N + n0 + cl] = acc[e];
    }
    return;
  }

  // Each block leaves its partial in its own shared memory (slot e of
  // thread t at e * kThreads + t); block r of the cluster then sums element
  // slice r over the blocks 0..split-1 in that order.
  cg::cluster_group cluster = cg::this_cluster();
  cp_async_wait<0>();
  __syncthreads();                  // the ring is drained and free
  T* part = ring;
#pragma unroll
  for (int e = 0; e < Tl::kSlots; ++e) part[e * kThreads + tid] = acc[e];
  cluster.sync();                   // every partial of the tile is in place
  constexpr int kElems = kBM * BN;
  const int rank = static_cast<int>(cluster.block_rank());
  const int lo = rank * kElems / split, hi = (rank + 1) * kElems / split;
  for (int i = lo + tid; i < hi; i += kThreads) {
    const int e = i / kThreads, t = i % kThreads;
    const int r = Mt::row(e, t), cl = Mt::col(e, t);
    if (r >= rows || cl >= cols) continue;
    T v = T(0);
    for (int ss = 0; ss < split; ++ss)
      v += cluster.map_shared_rank(part, ss)[i];
    c[static_cast<size_t>(m0 + r) * N + n0 + cl] = v;
  }
  cluster.sync();                   // no block leaves while its partial is read
}

template <typename T, int BN>
int launch_tile(const T* a, const T* b, T* c, int M, int N, int K, int split,
                int device, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};   // per instantiation and device
  cudaError_t err = cudaSuccess;
  if (!configured[device]) {
    err = cudaFuncSetAttribute(ladder_mm_nt<T, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile<T, BN>::kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ladder_mm_nt<T, BN>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (M + kBM - 1) / kBM, split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Tile<T, BN>::kSmemBytes;
  cfg.stream = stream;
  // Load-balanced placement of the clusters: 7% faster than the default
  // at 98 x 961 x 961 in f32, where 16 clusters of 16 blocks fill the card.
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = split;
  attrs[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attrs[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicyLoadBalancing;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, ladder_mm_nt<T, BN>, a, b, c, M, N, K,
                           split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int device, const T* a, const T* b, T* c, int M, int N, int K,
           int bm, int bn, int bk, int split, void* stream) {
  // The planner's tile must be one of this kernel's, and its split must
  // fit a cluster and leave every block at least one chunk (or be 1).
  const int chunks = (K + kBK - 1) / kBK;
  if (bm != kBM || (bn != 32 && (bn != 64 || sizeof(T) != 4)) || bk != kBK ||
      M < 1 || N < 1 || K < 0 || split < 1 || split > kMaxSplit ||
      split > (chunks > 1 ? chunks : 1) || (M + kBM - 1) / kBM > 65535 ||
      device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 4) {
    if (bn == 64) return launch_tile<T, 64>(a, b, c, M, N, K, split, device, st);
  }
  return launch_tile<T, 32>(a, b, c, M, N, K, split, device, st);
}

}  // namespace

// Plain C interface for ctypes.  Each returns the cudaError_t of the launch
// (0 on success).  The caller allocates c and owns the stream; bm/bn/bk and
// split are the planner's, checked against this build's tiles.
extern "C" int ecw_ladder_mm_f32(int device, const float* a, const float* b,
                                 float* c, int M, int N, int K, int bm,
                                 int bn, int bk, int split, void* stream) {
  return launch<float>(device, a, b, c, M, N, K, bm, bn, bk, split, stream);
}

extern "C" int ecw_ladder_mm_f64(int device, const double* a,
                                 const double* b, double* c, int M, int N,
                                 int K, int bm, int bn, int bk, int split,
                                 void* stream) {
  return launch<double>(device, a, b, c, M, N, K, bm, bn, bk, split, stream);
}
