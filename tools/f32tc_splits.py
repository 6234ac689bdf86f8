"""Check and time csrc/ladder_mm_f32tc.cu against the FFMA kernel and cuBLAS
on one card, at each split of K it can take.

    python3 tools/f32tc_splits.py [--quick]
    python3 tools/f32tc_splits.py --variants

Builds the port's kernels (kernels/build.py), prints the three-pass and
one-pass instances' ptxas lines and SASS counts (HGMMA, UTMALDG), checks
both instances against their plain versions (ladder_mm_plain_split) and
the three-pass one against a @ b.T and an f64 product at the shapes
below, then, per shape, times in turns: the three-pass kernel at every
split it takes (called through its C entry point with the plan's tile
and cluster of row groups), the FFMA kernel at its plan, cuBLAS SGEMM
(TF32 off) and, at the sector shapes, the one-pass instance against
ladder_mm_tc.cu's TF32 kernel and cuBLAS with TF32 on.  Times are
chip_smoke.py's: device µs per launch of 50 back-to-back launches behind
a sleep kernel, the median of the runs, B cycled over copies that exceed
twice the L2.  --quick: the checks and the cc-pVTZ shapes only.
--variants: source variants of the kernel (VARIANTS: a few lines
replaced, each built by its own nvcc into a temporary directory and
called through its C entry point) side by side at the cc-pVTZ and 3-lane
shapes, beside cuBLAS's TF32 and SGEMM rates at 8192^3 (the card's
attainable rates).  Prints one JSON line per check and per time, then
the card's name and power limit.  Needs a CUDA card and nvcc.
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from ecw_cc_torch.config import matmul_precision  # noqa: E402
from ecw_cc_torch.kernels import build  # noqa: E402
from ecw_cc_torch.kernels import ladder_mm as lmm  # noqa: E402

SECTOR = [(98, 465, 465), (98, 961, 961), (98, 2211, 2211),
          (98, 3240, 3240), (98, 4489, 4489), (98, 6561, 6561)]
LANES = [(294, 465, 465), (294, 961, 961), (294, 3240, 3240),
         (294, 6561, 6561), (196, 465, 465), (196, 961, 961),
         (784, 465, 465), (784, 961, 961)]
OTHER = [(98, 810, 3240), (98, 1641, 6561), (196, 3844, 3844),
         (392, 1891, 1891), (196, 1891, 1891), (392, 465, 465),
         (392, 961, 961)]
CHECK = SECTOR + LANES + OTHER + [(1, 1, 1), (37, 513, 129), (100, 130, 1001),
                                  (105, 129, 8191), (211, 300, 8193),
                                  (98, 465, 31), (98, 465, 257)]
RUNS = 7
SOURCE = os.path.join(build.CSRC, "ladder_mm_f32tc.cu")
# name -> [(text, replacement), ...] applied to the kernel's source
VARIANTS = {
    "kernel": [],
    "stages3": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    # one wgmma per k8 step (hi hi): what the two lo passes cost
    "one_pass_mma": [("      wgmma_tf32(acc, f.lo[kk], dh + 2 * ks, first);\n"
                      "      wgmma_tf32(acc, f.hi[kk], dl + 2 * ks, 1);\n"
                      "      wgmma_tf32(acc, f.hi[kk], dh + 2 * ks, 1);",
                      "      wgmma_tf32(acc, f.hi[kk], dh + 2 * ks, first);")],
}
VARIANT_RUNS = [((98, 6561, 6561), 2), ((98, 3240, 3240), 4),
                ((294, 6561, 6561), 1), ((294, 6561, 6561), 2)]


_SCRATCH = {}


def scratch(M, K):
    """The split pass's scratch of an (M, K) A, kept per shape."""
    if (M, K) not in _SCRATCH:
        _SCRATCH[(M, K)] = torch.empty((2, M, -(-K // 4) * 4), device="cuda")
    return _SCRATCH[(M, K)]


def launch_tc3(a, b, c, split, passes=3):
    """One launch of the f32tc instance at `split`, the plan's tile."""
    M, K = a.shape
    N = b.shape[0]
    name = "ecw_ladder_mm_f32_tc3" if passes == 3 else "ecw_ladder_mm_tf32_tc1"
    p = tile((M, N, K), "tc3" if passes == 3 else "tc1")
    fn = getattr(build.library().cdll, name)
    err = fn(a.device.index, a.data_ptr(), b.data_ptr(), c.data_ptr(),
             scratch(M, K).data_ptr(), M, N, K, a.stride(0), b.stride(0),
             p.bm, p.bn, p.bk, p.cluster_m, split,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"f32tc launch at {M}x{N}x{K} split {split}: {err}")
    return c


def build_variants(out):
    src = open(SOURCE).read()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
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
        lib = ctypes.CDLL(os.path.join(out, f"{name}.so"))
        fn = lib.ecw_ladder_mm_f32_tc3
        fn.argtypes, fn.restype = build._LADDER_MM_TC, ctypes.c_int
        libs[name] = fn
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "C75" in ln]}), flush=True)
    return libs


def variants():
    with tempfile.TemporaryDirectory() as out:
        fns = build_variants(out)
        for shape, split in VARIANT_RUNS:
            M, N, K = shape
            args, n = cycled(shape)
            c = torch.empty((M, N), device="cuda")
            p = tile(shape)

            def call(fn):
                a, b = args()
                err = fn(0, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                         scratch(M, K).data_ptr(), M, N, K, a.stride(0),
                         b.stride(0), p.bm, p.bn, p.bk, p.cluster_m, split,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant launch: {err}")
            t = timed({k: (lambda f=f: call(f)) for k, f in fns.items()})
            print(json.dumps({"variants_us": shape, "split": split, **t}),
                  flush=True)
    for prec in ("high", "highest"):
        a = torch.randn(8192, 8192, device="cuda")
        torch.set_float32_matmul_precision(prec)
        try:
            t = timed({"mm": lambda: a @ a.T}, runs=3)["mm"]
        finally:
            torch.set_float32_matmul_precision("highest")
        print(json.dumps({"cublas_8192": prec, "us": t,
                          "tflops": 2 * 8192 ** 3 / t / 1e6}), flush=True)


def tile(shape, kernel="tc3"):
    """The plan of the kernel at `shape` (its tile and row groups)."""
    return lmm.plan(*shape, "f32" if kernel == "tc3" else "tf32",
                    torch.cuda.get_device_properties(0).multi_processor_count,
                    kernel)


def splits_of(shape, kernel="tc3"):
    p = tile(shape, kernel)
    chunks = -(-shape[2] // p.bk)
    return [s for s in (1, 2, 4, 8, 16)
            if p.cluster_m * s <= lmm.F32TC_MAX_CLUSTER and s <= max(1, chunks)]


def checks():
    for i, shape in enumerate(CHECK):
        a, b = cs.operands(shape, torch.float32, seed=100 + i)
        a, b = lmm.f32_rows(a), lmm.f32_rows(b)
        c3 = lmm.launch_kernel(a, b, "tc3")
        c3b = lmm.launch_kernel(a, b, "tc3")
        c1 = lmm.launch_kernel(a, b, "tc1", precision="tf32")
        cf = lmm.launch_kernel(a, b, "ffma")
        torch.cuda.synchronize()
        with matmul_precision("highest"):
            ref = a @ b.T
            ref64 = (a.double() @ b.double().T)
            p3 = lmm.ladder_mm_plain_split(a, b, 3)
            p1 = lmm.ladder_mm_plain_split(a, b, 1)
        scale = float(ref.abs().max())
        row = {"check": "f32tc", "shape": shape, "max_abs_ref": scale,
               "tc3_vs_mm": float((c3 - ref).abs().max()),
               "tc3_vs_f64": float((c3.double() - ref64).abs().max()),
               "ffma_vs_f64": float((cf.double() - ref64).abs().max()),
               "cublas_vs_f64": float((ref.double() - ref64).abs().max()),
               "tc3_vs_plain_split": float((c3 - p3).abs().max()),
               "tc1_vs_plain": float((c1 - p1).abs().max()),
               "tc1_scale": float(p1.abs().max()),
               "bitwise": bool(torch.equal(c3, c3b)),
               "plan": cs.plan_fields(lmm.device_plan(*shape, "f32", a.device,
                                                      "tc3"))}
        row["ok"] = (row["tc3_vs_mm"] <= cs.TOL[torch.float32] * scale
                     and row["tc1_vs_plain"] <= 1e-5 * row["tc1_scale"]
                     and row["bitwise"] and bool(torch.isfinite(c3).all()))
        print(json.dumps(row), flush=True)


def timed(fns, runs=RUNS):
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    out = {k: [] for k in fns}
    order = list(fns)
    for i in range(runs):
        for k in (order if i % 2 == 0 else order[::-1]):
            out[k].append(cs.device_run_ms(fns[k], cs.TIMING_LAUNCHES) * 1e3)
    return {k: statistics.median(v) for k, v in out.items()}


def cycled(shape, var="f32"):
    a, b = cs.operands(shape, torch.float32, seed=0)
    rows = lmm.tf32_rows if var == "tf32" else lmm.f32_rows
    a, b = lmm.f32_rows(a), rows(b)
    b_bytes = b.shape[0] * b.stride(0) * 4
    n = -(-2 * cs.L2_BYTES // b_bytes) if b_bytes >= cs.COLD_B_BYTES else 1
    ops = [(a, b)] + [(a.clone(), rows(b.clone())) for _ in range(n - 1)]
    turn = [0]

    def args():
        turn[0] += 1
        return ops[turn[0] % n]
    return args, n


def times(shapes):
    for shape in shapes:
        M, N, _ = shape
        args, n = cycled(shape)
        c = torch.empty((M, N), device="cuda")
        fns = {f"tc3_split{s}": (lambda s=s: launch_tc3(*args(), c, s))
               for s in splits_of(shape)}
        fns["ffma"] = lambda: lmm.launch_kernel(*args(), "ffma")
        fns["cublas"] = lambda: torch.mm(*(lambda x, y: (x, y.T))(*args()))
        t = timed(fns)
        ffma_plan = lmm.device_plan(*shape, "f32", torch.device("cuda", 0),
                                    "ffma")
        tc3_plan = lmm.device_plan(*shape, "f32", torch.device("cuda", 0),
                                   "tc3")
        print(json.dumps({"time_us": "f32", "shape": shape, "copies": n,
                          **t, "ffma_blocks": ffma_plan.blocks,
                          "ffma_split": ffma_plan.split,
                          "tc3_plan_split": tc3_plan.split,
                          "tc3_plan_blocks": tc3_plan.blocks}), flush=True)


def times_tf32(shapes):
    for shape in shapes:
        M, N, _ = shape
        args, n = cycled(shape, "tf32")
        c = torch.empty((M, N), device="cuda")
        fns = {f"tc1_split{s}": (lambda s=s: launch_tc3(*args(), c, s, 1))
               for s in splits_of(shape, "tc1")}
        fns["tc"] = lambda: lmm.launch_kernel(*args(), "tc",
                                              precision="tf32")

        def cublas_tf32():
            torch.set_float32_matmul_precision("high")
            try:
                x, y = args()
                return x @ y.T
            finally:
                torch.set_float32_matmul_precision("highest")
        fns["cublas_tf32"] = cublas_tf32
        print(json.dumps({"time_us": "tf32", "shape": shape, "copies": n,
                          **timed(fns)}), flush=True)


def main(argv):
    if not torch.cuda.is_available():
        print("f32tc_splits: needs a CUDA card", file=sys.stderr)
        return 2
    lib = build.library()
    print(json.dumps({"build_seconds": lib.build_seconds, "ptxas": [
        ln.strip() for ln in lib.log.splitlines()
        if any(w in ln for w in ("f32tc", "registers", "spill",
                                 "warning", "C75"))]}))
    print(json.dumps({"sass": {n: dict(c) for n, c in
                               cs.sass_counts(lib.path).items()
                               if "f32tc" in n}}), flush=True)
    if "--variants" in argv:
        variants()
        print(cs.nvidia_smi())
        return 0
    checks()
    quick = "--quick" in argv
    times(SECTOR[3:4] + SECTOR[5:] + LANES[3:4] if quick
          else SECTOR + LANES + OTHER)
    times_tf32(SECTOR[3:4] + SECTOR[5:] if quick else SECTOR)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
