"""Time variants of the tensor-core ladder kernel side by side on one card.

    python3 tools/tc_kernel_variants.py [variant ...]

Each variant is ecw_cc_torch/csrc/ladder_mm_tc.cu with a few lines
replaced (VARIANTS below), built by its own nvcc (all started together)
into a scratch directory and called through its C entry point with the
planner's tile, at the planner's cluster of row tiles and at smaller
clusters (cm 4, 2, 1; the split then takes the cluster's room).  B is
cycled over copies that exceed twice the L2, as chip_smoke.py phase 3
times it; device µs per launch are the median of 5 runs of 30 launches.
Prints one line per (variant, dtype, shape, cm) and the card's name and
power limit.  Needs a CUDA card and nvcc.
"""

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ecw_cc_torch.kernels import build  # noqa: E402
from ecw_cc_torch.kernels import ladder_mm as lmm  # noqa: E402

SOURCE = os.path.join(build.CSRC, "ladder_mm_tc.cu")
MMA_CALL = ("      mma_chunk(acc, static_cast<const T*>(nullptr), sa, sb,\n"
            "                i % kFlushChunks != 0, warp, lane / 4, "
            "lane % 4);")
SS_TF32 = '''__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[kSlots],
                                              uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {''' + ", ".join(
    f"%{i}" for i in range(64)) + '''}, "
      "%64, %65, p, 1, 1;\\n}\\n"
      : ''' + ", ".join(f'"+f"(d[{i}])' for i in range(64)) + '''
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// TF32 A rounded in shared memory (this warpgroup's 64 rows), then both
// operands by descriptor
__device__ __forceinline__ void mma_chunk(float (&acc)[kSlots], const float*,
                                          unsigned sa, unsigned sb,
                                          int accumulate, int, int, int) {
  const int wt = threadIdx.x % 128;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned p = sa + 16 * (wt + j * 128);
    float x0, x1, x2, x3;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\\n"
                 : "=f"(x0), "=f"(x1), "=f"(x2), "=f"(x3) : "r"(p));
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\\n" ::"r"(p),
                 "r"(to_tf32(x0)), "r"(to_tf32(x1)), "r"(to_tf32(x2)),
                 "r"(to_tf32(x3)) : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\\n" ::"r"(2 + threadIdx.x / 128)
               : "memory");
  pin(acc);
  wgmma_fence();
  const uint64_t da = smem_desc(sa), db = smem_desc(sb);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_tf32_ss(acc, da + 2 * ks, db + 2 * ks, ks > 0 || accumulate);
  wgmma_commit();
  wgmma_wait_all();
  pin(acc);
}

__device__ __forceinline__ void mma_chunk_registers('''
# name -> [(text, replacement), ...] applied to the kernel's source
VARIANTS = {
    "kernel": [],
    # the consumers only release the stages: the TMA pipeline alone
    "no_wgmma": [(MMA_CALL, "      (void)sa;")],
    # the remote arrivals with a cluster-scope release
    "release_cluster": [("mbarrier.arrive.shared::cluster.b64",
                         "mbarrier.arrive.release.cluster.shared::cluster"
                         ".b64")],
    # TF32 A rounded in shared memory, wgmma with both operands in it
    "a_in_smem": [("__device__ __forceinline__ void mma_chunk(float "
                   "(&acc)[kSlots], const float*,",
                   SS_TF32 + "float (&acc)[kSlots], const float*,")],
    "stages4": [("constexpr int kStages = 6;", "constexpr int kStages = 4;")],
}
SHAPES = [(196, 3844, 3844), (392, 1891, 1891), (392, 13041, 13041)]
L2_BYTES = 50 * 2 ** 20


def build_variants(names, out):
    src = open(SOURCE).read()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise ValueError(f"{name}: the source has no {old[:60]!r}")
            text = text.replace(old, new)
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             os.path.join(out, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name} does not build:\n{log}")
        print(name, [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "C7518" in ln], flush=True)
        lib = ctypes.CDLL(os.path.join(out, f"{name}.so"))
        for fn in ("ecw_ladder_mm_tf32", "ecw_ladder_mm_bf16"):
            getattr(lib, fn).argtypes = build._LADDER_MM_LD
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_ms(fn, n=30):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)   # the enqueue ends before the sleep
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def main(names):
    if not torch.cuda.is_available():
        print("tc_kernel_variants: needs a CUDA card", file=sys.stderr)
        return 2
    names = names or list(VARIANTS)
    with tempfile.TemporaryDirectory() as out:
        libs = build_variants(names, out)
        stream = torch.cuda.current_stream().cuda_stream
        for var in ("tf32", "bf16"):
            dt = torch.bfloat16 if var == "bf16" else torch.float32
            rows = lmm.bf16_rows if var == "bf16" else lmm.tf32_rows
            for M, N, K in SHAPES:
                g = torch.Generator("cuda").manual_seed(M + N)
                a = rows(torch.randn(M, K, device="cuda", generator=g))
                n_b = max(1, -(-2 * L2_BYTES // (N * K * a.element_size())))
                bs = [rows(torch.randn(N, K, device="cuda", generator=g))
                      for _ in range(n_b)]
                c = torch.empty(M, N, dtype=dt, device="cuda")
                p = lmm.plan(M, N, K, var, 132)
                for cm in sorted({p.cluster_m, 4, 2, 1}, reverse=True):
                    if p.m_tiles % cm:
                        continue
                    split = max(1, p.split * p.cluster_m // cm)
                    split = min(split, 8 // cm, -(-K // p.bk))
                    line = {}
                    for name, lib in libs.items():
                        fn = getattr(lib, f"ecw_ladder_mm_{var}")
                        turn = [0]

                        def call():
                            turn[0] += 1
                            b = bs[turn[0] % n_b]
                            return fn(0, a.data_ptr(), b.data_ptr(),
                                      c.data_ptr(), M, N, K, a.stride(0),
                                      b.stride(0), p.bm, p.bn, p.bk, cm,
                                      split, 0, stream)

                        if call():
                            raise RuntimeError(f"{name} {var} refused "
                                               f"{(M, N, K)} cm {cm}")
                        torch.cuda.synchronize()
                        for _ in range(3):
                            call()
                        line[name] = statistics.median(
                            device_ms(call) * 1e3 for _ in range(5))
                    print(var, (M, N, K), "cm", cm, "split", split,
                          "planned" if cm == p.cluster_m else "",
                          {k: round(v, 1) for k, v in line.items()},
                          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
