// Tensor-core variants of the ladder NT GEMM for Hopper (sm_90a):
//
//     C[m, n] = sum_k A[m, k] * B[n, k]
//
// A (M, K) and B (N, K) row-major, contiguous along K (row strides lda and
// ldb), C (M, N) contiguous, f32 accumulation:
//
// * TF32: f32 operands, each rounded to TF32 with cvt.rna.tf32.f32 as it
//   leaves shared memory, mma.sync.m16n8k8 (TF32 in, f32 accumulate), f32
//   out.  The solver's 'high' and 'default' precision modes.
// * BF16: bf16 operands, ldmatrix fragments, mma.sync.m16n8k16 (bf16 in,
//   f32 accumulate), the f32 sum rounded once to bf16 on the way out, as
//   the Pallas kernel writes its f32 scratch tile in the operands' dtype.
//   The solver's 'bf16' mode, whose t/lambda updates read bf16 ERI blocks.
//
// Replaces the TPU kernel ecw_cc_tpu/ops/ladder.py::_ladder_mm_pallas for
// the operands its reduced-precision modes give it: the JAX loop runs that
// kernel's dot on bf16 operands under iter_precision='bf16'
// (ecw_cc_tpu/solvers/gs.py:922-936) and at reduced matmul precision under
// 'high' and 'default' (:938-955).  The f32 (full precision, FFMA) and f64
// (DMMA) kernels are in ladder_mm.cu.
//
// Where it runs: every ladder product of ecw_cc_torch/ops/ladder.py
// (_packed_mm, _sector_mm, dense_ladder) inside a Solver_CCSD iteration
// under those modes; the route shapes are M = 98-392 rows (tau and lambda
// row pairs) by N = K = 465-13041 (vvvv pairs).
//
// What bounds it: at the large packed shapes (392 x 13041 x 13041, 133
// GFLOP) the tensor cores, 0.13 ms at the dense bf16 peak and 0.27 ms at
// TF32's, against 0.34 (bf16) and 0.68 ms (f32) to read B once at
// 3.35 TB/s: so the bytes of B, and a kernel that streams B at the memory
// rate wins.  At the small sector shapes, latency and the launch.  The
// design is the simple one that is right first (a wgmma/TMA version is
// later work):
//
// * The tile and the split are those of ladder_mm.cu, so the same planner
//   (kernels/ladder_mm.py plan) drives both: one 112-row tile covers M = 98
//   (7 m16 fragments), 64 columns (four warps of 16), K in 16-deep chunks,
//   split across the blocks of one thread block cluster and summed in f32
//   in the fixed order 0..S-1 through distributed shared memory, so a
//   launch is deterministic and replays in a CUDA graph.
// * A ring of 4 K chunks in dynamic shared memory, filled with cp.async.
//   TF32: one 4-byte copy per element (the solver's K is odd, so rows are
//   not 16-byte aligned).  BF16: 16-byte copies, 8 elements, which needs
//   row strides that are multiples of 8 elements and 16-byte aligned bases:
//   the per-solve bf16 copy of the ladder operand is made with such a
//   stride (ops/ladder.py), and the wrapper copies an A that lacks it.  The
//   ragged K tail copies fewer bytes and zero-fills the rest.
// * Rows of the ring are padded (TF32 +4 floats, BF16 +8 elements) so the
//   fragment loads of a warp (scalar LDS for TF32, ldmatrix for BF16) hit
//   32 distinct banks.
// * The tensor cores' f32 accumulation is not round-to-nearest: one
//   accumulator over K = 13041 drifted 3.1e-5 max|C| from the plain
//   version (measured, TF32).  So the mma accumulators take kFlush chunks
//   (256 of K) at a time and are added into a second set of f32 registers
//   with ordinary (round-to-nearest) adds.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 112;       // output rows per block (all of M = 98)
constexpr int kBN = 64;        // output columns per block, 16 per warp
constexpr int kBK = 16;        // K chunk, the unit of the ring and the split
constexpr int kThreads = 128;  // four warps
constexpr int kStages = 4;
constexpr int kMaxSplit = 16;  // blocks per cluster (non-portable on H100)
constexpr int kMaxDevices = 64;
constexpr int kFlush = 16;     // chunks per flush of the mma accumulators
constexpr int kSubM = kBM / 16;        // m16 fragments per tile
constexpr int kSlots = kSubM * 2 * 4;  // f32 accumulators per thread
static_assert(kSlots * kThreads == kBM * kBN, "every output has one slot");

using bf16 = __nv_bfloat16;

template <typename T>
struct Ring;
template <>
struct Ring<float> {
  static constexpr int kLd = kBK + 4;   // row stride in elements
};
template <>
struct Ring<bf16> {
  static constexpr int kLd = kBK + 8;   // 48 bytes: 16-byte aligned rows
};

template <typename T>
struct Stage {
  static constexpr int kElems = (kBM + kBN) * Ring<T>::kLd;
  static constexpr int kSmemBytes =
      kStages * kElems * static_cast<int>(sizeof(T));
  // The ring, once drained, holds the block's f32 partial tile.
  static_assert(kSmemBytes >= kBM * kBN * static_cast<int>(sizeof(float)),
                "ring too small for the partial tile");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Stage one K chunk [k0, k0 + kBK) of the A tile (kBM rows) and the B tile
// (kBN rows), row-major with stride Ring<T>::kLd; what lies past M, N or K
// is zero-filled.
__device__ __forceinline__ void load_chunk(float* s, const float* a,
                                           const float* b, int M, int N,
                                           int K, int lda, int ldb, int m0,
                                           int n0, int k0, int tid) {
  constexpr int kLd = Ring<float>::kLd;
  constexpr int kRowsPerPass = kThreads / kBK;   // 8
  const int kk = tid % kBK;
  const int gk = k0 + kk;
  const bool k_ok = gk < K;
#pragma unroll
  for (int p = 0; p < (kBM + kBN) / kRowsPerPass; ++p) {
    const int r = p * kRowsPerPass + tid / kBK;
    const float* src;
    bool ok;
    if (p < kBM / kRowsPerPass) {
      const int gm = m0 + r;
      ok = k_ok && gm < M;
      src = ok ? a + static_cast<size_t>(gm) * lda + gk : a;
    } else {
      const int gn = n0 + r - kBM;
      ok = k_ok && gn < N;
      src = ok ? b + static_cast<size_t>(gn) * ldb + gk : b;
    }
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(s + r * kLd + kk)),
                 "l"(src), "r"(ok ? 4 : 0));
  }
}

// bf16: two 16-byte pieces (8 elements) per row and chunk; a piece that
// reaches past K copies only its valid bytes.
__device__ __forceinline__ void load_chunk(bf16* s, const bf16* a,
                                           const bf16* b, int M, int N,
                                           int K, int lda, int ldb, int m0,
                                           int n0, int k0, int tid) {
  constexpr int kLd = Ring<bf16>::kLd;
  constexpr int kPieces = (kBM + kBN) * 2;
  for (int piece = tid; piece < kPieces; piece += kThreads) {
    const int r = piece >> 1;
    const int gk = k0 + 8 * (piece & 1);
    const int nk = min(max(K - gk, 0), 8);
    const bf16* src;
    bool ok;
    if (r < kBM) {
      const int gm = m0 + r;
      ok = nk > 0 && gm < M;
      src = ok ? a + static_cast<size_t>(gm) * lda + gk : a;
    } else {
      const int gn = n0 + r - kBM;
      ok = nk > 0 && gn < N;
      src = ok ? b + static_cast<size_t>(gn) * ldb + gk : b;
    }
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(s + r * kLd + 8 * (piece & 1))),
                 "l"(src), "r"(ok ? 2 * nk : 0));
  }
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// D (16 x 8) += A (16 x 8) B (8 x 8), TF32 in, f32 accumulate.  Lane
// l = 4g + t holds A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4],
// B[t][g], B[t + 4][g], and D[g][2t..2t+1], D[g + 8][2t..2t+1].
__device__ __forceinline__ void mma_tf32(float* d, const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D (16 x 8) += A (16 x 16) B (16 x 8), bf16 in, f32 accumulate; the
// fragments as ldmatrix.x4 delivers them (see chunk below).
__device__ __forceinline__ void mma_bf16(float* d, const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Warp w owns columns 16w..16w+15 (two n8 fragments j) and every m16
// fragment i; slot (2i + j) * 4 + c of lane 4g + t is
// D[16i + g + 8(c/2)][16w + 8j + 2t + c%2].
__device__ __forceinline__ int slot_row(int e, int tid) {
  return 16 * (e / 8) + (tid % 32) / 4 + 8 * ((e % 4) / 2);
}
__device__ __forceinline__ int slot_col(int e, int tid) {
  return 16 * (tid / 32) + 8 * ((e / 4) % 2) + 2 * (tid % 4) + e % 2;
}

// The math of one staged chunk: two k8 steps (TF32) or one k16 step
// (BF16); m16 fragments past the tile's rows and warps past its columns
// are skipped (warp-uniform).
__device__ __forceinline__ void chunk(const float* s, float (&acc)[kSlots],
                                      int tid, int rows, int cols) {
  constexpr int kLd = Ring<float>::kLd;
  const int warp = tid / 32, lane = tid % 32;
  if (16 * warp >= cols) return;
  const int subs = (rows + 15) / 16;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 8) {
    unsigned bfr[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* sb = s + (kBM + 16 * warp + 8 * j + g) * kLd + ks + t;
      bfr[j][0] = to_tf32(sb[0]);
      bfr[j][1] = to_tf32(sb[4]);
    }
#pragma unroll
    for (int i = 0; i < kSubM; ++i) {
      if (i < subs) {
        const float* sa = s + (16 * i + g) * kLd + ks + t;
        const unsigned afr[4] = {to_tf32(sa[0]), to_tf32(sa[8 * kLd]),
                                 to_tf32(sa[4]), to_tf32(sa[8 * kLd + 4])};
        mma_tf32(acc + (2 * i) * 4, afr, bfr[0][0], bfr[0][1]);
        mma_tf32(acc + (2 * i + 1) * 4, afr, bfr[1][0], bfr[1][1]);
      }
    }
  }
}

__device__ __forceinline__ void chunk(const bf16* s, float (&acc)[kSlots],
                                      int tid, int rows, int cols) {
  constexpr int kLd = Ring<bf16>::kLd;
  const int warp = tid / 32, lane = tid % 32;
  if (16 * warp >= cols) return;
  const int subs = (rows + 15) / 16;
  // B: matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
  // (n 8-15, k 8-15) of the warp's 16 columns, stored (n, k): registers
  // 0-1 are fragment j = 0, 2-3 fragment j = 1.
  unsigned bfr[4];
  ldmatrix_x4(bfr, s + (kBM + 16 * warp + lane % 8 + 8 * (lane / 16)) * kLd +
                       8 * ((lane / 8) % 2));
#pragma unroll
  for (int i = 0; i < kSubM; ++i) {
    if (i < subs) {
      // A: matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7,
      // k 8-15), (rows 8-15, k 8-15) of fragment i.
      unsigned afr[4];
      ldmatrix_x4(afr, s + (16 * i + lane % 16) * kLd + 8 * (lane / 16));
      mma_bf16(acc + (2 * i) * 4, afr, bfr[0], bfr[1]);
      mma_bf16(acc + (2 * i + 1) * 4, afr, bfr[2], bfr[3]);
    }
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// grid = (ceil(N / kBN), ceil(M / kBM), split), clusters of (1, 1, split):
// the split blocks of one output tile are one cluster.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ladder_mm_tc(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ c, int M, int N, int K, int lda, int ldb,
             int split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  constexpr int kElems = Stage<T>::kElems;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int s = blockIdx.z;
  const int chunks = (K + kBK - 1) / kBK;
  const int c0 = static_cast<int>(static_cast<long long>(s) * chunks / split);
  const int c1 =
      static_cast<int>(static_cast<long long>(s + 1) * chunks / split);
  const int nch = c1 - c0;
  const int rows = min(kBM, M - m0);   // of this tile that are in C
  const int cols = min(kBN, N - n0);

  float acc[kSlots], tot[kSlots];   // the mma's sums, and their sum
#pragma unroll
  for (int e = 0; e < kSlots; ++e) acc[e] = tot[e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nch)
      load_chunk(ring + st * kElems, a, b, M, N, K, lda, ldb, m0, n0,
                 (c0 + st) * kBK, tid);
    cp_async_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<kStages - 2>();   // chunk ch has landed (this thread's part)
    __syncthreads();                // ... everyone's; stage ch-1 is free
    const int next = ch + kStages - 1;
    if (next < nch)
      load_chunk(ring + (next % kStages) * kElems, a, b, M, N, K, lda, ldb,
                 m0, n0, (c0 + next) * kBK, tid);
    cp_async_commit();
    chunk(ring + (ch % kStages) * kElems, acc, tid, rows, cols);
    if ((ch + 1) % kFlush == 0 || ch + 1 == nch) {
#pragma unroll
      for (int e = 0; e < kSlots; ++e) {
        tot[e] += acc[e];
        acc[e] = 0.f;
      }
    }
  }

  if (split == 1) {
#pragma unroll
    for (int e = 0; e < kSlots; ++e) {
      const int r = slot_row(e, tid), cl = slot_col(e, tid);
      if (r < rows && cl < cols)
        store(c + static_cast<size_t>(m0 + r) * N + n0 + cl, tot[e]);
    }
    return;
  }

  // Each block leaves its f32 partial in its own shared memory (slot e of
  // thread t at e * kThreads + t); block r of the cluster then sums element
  // slice r over the blocks 0..split-1 in that order, and rounds once.
  cg::cluster_group cluster = cg::this_cluster();
  cp_async_wait<0>();
  __syncthreads();                  // the ring is drained and free
  float* part = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int e = 0; e < kSlots; ++e) part[e * kThreads + tid] = tot[e];
  cluster.sync();                   // every partial of the tile is in place
  constexpr int kTile = kBM * kBN;
  const int rank = static_cast<int>(cluster.block_rank());
  const int lo = rank * kTile / split, hi = (rank + 1) * kTile / split;
  for (int i = lo + tid; i < hi; i += kThreads) {
    const int e = i / kThreads, t = i % kThreads;
    const int r = slot_row(e, t), cl = slot_col(e, t);
    if (r >= rows || cl >= cols) continue;
    float v = 0.f;
    for (int ss = 0; ss < split; ++ss)
      v += cluster.map_shared_rank(part, ss)[i];
    store(c + static_cast<size_t>(m0 + r) * N + n0 + cl, v);
  }
  cluster.sync();                   // no block leaves while its partial is read
}

template <typename T>
int launch(int device, const T* a, const T* b, T* c, int M, int N, int K,
           int lda, int ldb, int bm, int bn, int bk, int split,
           void* stream) {
  // The planner's tile must be this kernel's, its split must fit a cluster
  // and leave every block at least one chunk (or be 1); bf16 rows must be
  // 16-byte aligned for the 16-byte copies.
  const int chunks = (K + kBK - 1) / kBK;
  const bool aligned =
      sizeof(T) != 2 ||
      (lda % 8 == 0 && ldb % 8 == 0 &&
       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
       reinterpret_cast<uintptr_t>(b) % 16 == 0);
  if (bm != kBM || bn != kBN || bk != kBK || M < 1 || N < 1 || K < 0 ||
      lda < K || ldb < K || !aligned || split < 1 || split > kMaxSplit ||
      split > (chunks > 1 ? chunks : 1) || (M + kBM - 1) / kBM > 65535 ||
      device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool configured[kMaxDevices] = {};   // per instantiation and device
  if (!configured[device]) {
    err = cudaFuncSetAttribute(ladder_mm_tc<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Stage<T>::kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ladder_mm_tc<T>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Stage<T>::kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
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
  err = cudaLaunchKernelEx(&cfg, ladder_mm_tc<T>, a, b, c, M, N, K, lda, ldb,
                           split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Each returns the cudaError_t of the launch
// (0 on success).  The caller allocates c (M x N, contiguous) and owns the
// stream; lda and ldb are the operands' row strides in elements; bm/bn/bk
// and split are the planner's, checked against this build's tile.
extern "C" int ecw_ladder_mm_tf32(int device, const float* a, const float* b,
                                  float* c, int M, int N, int K, int lda,
                                  int ldb, int bm, int bn, int bk, int split,
                                  void* stream) {
  return launch<float>(device, a, b, c, M, N, K, lda, ldb, bm, bn, bk, split,
                       stream);
}

extern "C" int ecw_ladder_mm_bf16(int device, const void* a, const void* b,
                                  void* c, int M, int N, int K, int lda,
                                  int ldb, int bm, int bn, int bk, int split,
                                  void* stream) {
  return launch<bf16>(device, static_cast<const bf16*>(a),
                      static_cast<const bf16*>(b), static_cast<bf16*>(c), M,
                      N, K, lda, ldb, bm, bn, bk, split, stream);
}
