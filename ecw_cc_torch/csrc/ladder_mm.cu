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
// the K walk is a loop inside each block, the ragged M/N/K edges are masked
// in the loads and the store, and no padded copy of either operand is made.
//
// Where it runs: ecw_cc_torch/ops/ladder.py::_sector_mm, the sector GEMMs of
// balanced_stacked_sectored_contract -- two launches per solver iteration
// under the closed-shell mirror symmetry, three without.  At C2H2/cc-pVDZ
// they are A (98 x 465) x B (465 x 465) and A (98 x 961) x B (961 x 961).
//
// What bounds it: bytes first.  B is the only large operand (3.7 MB in f32
// at 961^2) and the design streams it from device memory once per launch:
// each 64-row band of B is read by ceil(M / 64) = 2 blocks, the second read
// hitting the 50 MB L2.  A is small and stays in L2.  Against B the kernel
// does 2 * M / sizeof(T) = 49 FLOP per byte in f32 at M = 98, above the
// card's f32 CUDA-core balance (about 20 FLOP/B), so a kernel that filled
// the card would be FMA-bound; at these shapes it is bound by parallelism
// instead: a 64 x 64 output tiling gives only 16-32 blocks for 132 SMs.
//
// Known next steps, in order: fuse the _pack_pairs row pack into the A load
// and the unpack + antisymmetrisation into the epilogue; split K across
// blocks (or a skinnier M tile) so M = 98 fills the SMs; then wgmma/TMA.
// f32 runs on the CUDA cores in full f32 (no TF32), matching the solver's
// 'highest' precision mode.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBM = 64;   // output rows per block
constexpr int kBN = 64;   // output columns per block
constexpr int kBK = 16;   // K chunk staged in shared memory
constexpr int kTM = 4;    // output rows per thread
constexpr int kTN = 4;    // output columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256

template <typename T>
__global__ void __launch_bounds__(kThreads)
ladder_mm_nt(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ c, int M, int N, int K) {
  // K-major staging: As[k][m], Bs[k][n].  The +1 pad keeps the transposing
  // stores free of bank conflicts for f32.
  __shared__ T As[kBK][kBM + 1];
  __shared__ T Bs[kBK][kBN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);   // owns columns tx + 16 j
  const int ty = tid / (kBN / kTN);   // owns rows ty + 16 i
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  T acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // Neighbouring threads read neighbouring k of one row: coalesced.
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      const int gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < M && gk < K)
                      ? a[static_cast<size_t>(gm) * K + gk] : T(0);
    }
    for (int e = tid; e < kBN * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      const int gn = n0 + r, gk = k0 + kk;
      Bs[kk][r] = (gn < N && gk < K)
                      ? b[static_cast<size_t>(gn) * K + gk] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      T av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = As[kk][ty + i * (kBM / kTM)];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = Bs[kk][tx + j * (kBN / kTN)];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + i * (kBM / kTM);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + j * (kBN / kTN);
      if (gn < N) c[static_cast<size_t>(gm) * N + gn] = acc[i][j];
    }
  }
}

template <typename T>
int launch(int device, const T* a, const T* b, T* c, int M, int N, int K,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  ladder_mm_nt<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Each returns the cudaError_t of the launch
// (0 on success); the caller allocates c and owns the stream.
extern "C" int ecw_ladder_mm_f32(int device, const float* a, const float* b,
                                 float* c, int M, int N, int K,
                                 void* stream) {
  return launch<float>(device, a, b, c, M, N, K, stream);
}

extern "C" int ecw_ladder_mm_f64(int device, const double* a,
                                 const double* b, double* c, int M, int N,
                                 int K, void* stream) {
  return launch<double>(device, a, b, c, M, N, K, stream);
}
