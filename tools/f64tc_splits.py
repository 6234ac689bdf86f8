"""Check and time csrc/ladder_mm_f64tc.cu against ladder_mm.cu's DMMA kernel
and cuBLAS DGEMM on one card, at each split of K it can take.

    python3 tools/f64tc_splits.py [--quick] [--variants]

Builds the port's kernels (kernels/build.py), prints the f64 kernels'
ptxas lines and SASS counts (DMMA, UTMALDG), checks the kernel against
a @ b.T (to 1e-12 max|C|) at the f64 path shapes and the edges of its tile,
split and K, two launches bitwise equal, then, per f64 path shape, times
in turns: the kernel at every split it takes (called through its C entry
point with the plan's tile and row tiles), the 'dmma' kernel at its plan
and cuBLAS (a @ b.T).  Times are chip_smoke.py's: device µs per launch of
back-to-back launches behind a sleep kernel, the median of the runs, B
cycled over copies that exceed twice the L2.  --quick: the checks and the
cc-pVTZ shapes only.  --variants: source variants of the kernel
(VARIANTS: a constant replaced, each built by its own nvcc into a
temporary directory and called through its C entry point) checked at a
few shapes and timed side by side at the plan's split.  Prints one JSON
line per check and per time, then the card's name and power limit.
Needs a CUDA card and nvcc.
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
from ecw_cc_torch.kernels import build  # noqa: E402
from ecw_cc_torch.kernels import ladder_mm as lmm  # noqa: E402

F64 = torch.float64
# the f64 path shapes (chip_smoke.py F64_PATH_SHAPES) and the EOM's
PATH = [(392, 13041, 13041), (196, 26244, 26244), (196, 3844, 3844),
        (392, 1891, 1891), (196, 13041, 13041), (196, 1891, 1891),
        (14, 1891, 1891), (196, 900, 900), (98, 465, 465), (98, 961, 961)]
CHECK = PATH + [(1, 1, 1), (1, 961, 961), (37, 513, 129), (100, 130, 1001),
                (98, 465, 15), (98, 465, 17), (105, 129, 1891),
                (832, 300, 257), (392, 1891, 1889), (196, 1000, 999),
                (98, 465, 0), (209, 257, 33)]
RUNS = 7
SOURCE = os.path.join(build.CSRC, "ladder_mm_f64tc.cu")
# name -> [(text, replacement), ...] applied to the kernel's source
VARIANTS = {
    "kernel": [],
    "stages4": [("constexpr int kStages = 6;", "constexpr int kStages = 4;")],
    "stages7": [("constexpr int kStages = 6;", "constexpr int kStages = 7;")],
}
VARIANT_CHECK = [(392, 1891, 1889), (196, 3844, 3844), (37, 513, 129)]
VARIANT_TIMES = [(392, 13041, 13041), (196, 26244, 26244),
                 (196, 3844, 3844), (392, 1891, 1891)]


def n_sm():
    return torch.cuda.get_device_properties(0).multi_processor_count


def tile(shape):
    """The kernel's plan at `shape` (its tile, row tiles and split)."""
    return lmm.plan(*shape, "f64", n_sm(), "f64tc")


def launch(fn, a, b, c, split):
    """One launch of the kernel's C entry point `fn` at `split`."""
    M, K = a.shape
    N = b.shape[0]
    p = tile((M, N, K))
    err = fn(a.device.index, a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N,
             K, a.stride(0), b.stride(0), p.bm, p.bn, p.bk, split,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"f64tc launch at {M}x{N}x{K} split {split}: "
                           f"{err}")
    return c


def splits_of(shape):
    """Every split the kernel takes at `shape`."""
    chunks = -(-shape[2] // tile(shape).bk)
    return [s for s in (1, 2, 4, 8, 16) if s <= max(1, chunks)]


def operands(shape, seed):
    a, b = cs.operands(shape, F64, seed)
    return lmm.f64_rows(a), lmm.f64_rows(b)


def check(fn, shape, seed, name="kernel"):
    """Row of the kernel at `shape` (the plan's split) against a @ b.T."""
    M, N, K = shape
    a, b = operands(shape, seed)
    split = tile(shape).split
    c1 = launch(fn, a, b, torch.empty((M, N), dtype=F64, device="cuda"),
                split)
    c2 = launch(fn, a, b, torch.empty((M, N), dtype=F64, device="cuda"),
                split)
    torch.cuda.synchronize()
    ref = a @ b.T
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    err = float((c1 - ref).abs().max()) if ref.numel() else 0.0
    row = {"check": name, "shape": shape, "split": split,
           "max_abs_err": err, "max_abs_ref": scale,
           "rel": err / scale if scale else 0.0,
           "bitwise": bool(torch.equal(c1, c2))}
    row["ok"] = (bool(torch.isfinite(c1).all()) and row["bitwise"]
                 and err <= cs.TOL[F64] * scale)
    print(json.dumps(row), flush=True)
    return row["ok"]


def checks(fn):
    ok = True
    for i, shape in enumerate(CHECK):
        ok &= check(fn, shape, 100 + i)
        if shape[2] > 16 * 8:   # every split it takes
            for s in splits_of(shape):
                M, N, _ = shape
                a, b = operands(shape, 200 + i)
                c = launch(fn, a, b, torch.empty((M, N), dtype=F64,
                                                 device="cuda"), s)
                err = float((c - a @ b.T).abs().max())
                scale = float((a @ b.T).abs().max())
                good = err <= cs.TOL[F64] * scale
                ok &= good
                if not good:
                    print(json.dumps({"check": "split", "shape": shape,
                                      "split": s, "max_abs_err": err,
                                      "max_abs_ref": scale}), flush=True)
    print(json.dumps({"checks_ok": ok}), flush=True)
    return ok


def timed(fns, runs=RUNS, launches=cs.TIMING_LAUNCHES):
    for fn in fns.values():
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    out = {k: [] for k in fns}
    order = list(fns)
    for i in range(runs):
        for k in (order if i % 2 == 0 else order[::-1]):
            out[k].append(cs.device_run_ms(fns[k], launches) * 1e3)
    return {k: statistics.median(v) for k, v in out.items()}


def cycled(shape):
    a, b = operands(shape, 0)
    b_bytes = b.shape[0] * b.stride(0) * 8
    n = -(-2 * cs.L2_BYTES // b_bytes) if b_bytes >= cs.COLD_B_BYTES else 1
    ops = [(a, b)] + [(lmm.f64_rows(a.clone()), lmm.f64_rows(b.clone()))
                      for _ in range(n - 1)]
    turn = [0]

    def args():
        turn[0] += 1
        return ops[turn[0] % n]
    return args, n


def launches_for(shape):
    """Back-to-back launches per timed run: fewer for the long products."""
    M, N, K = shape
    return 10 if M * N * K > 2e10 else cs.TIMING_LAUNCHES


def times(fn, shapes):
    for shape in shapes:
        M, N, _ = shape
        args, n = cycled(shape)
        c = torch.empty((M, N), dtype=F64, device="cuda")
        fns = {f"f64tc_split{s}": (lambda s=s: launch(fn, *args(), c, s))
               for s in splits_of(shape)}
        fns["dmma"] = lambda: lmm.launch_kernel(*args(), "dmma")
        fns["cublas"] = lambda: (lambda x, y: x @ y.T)(*args())
        t = timed(fns, launches=launches_for(shape))
        p = tile(shape)
        print(json.dumps({"time_us": "f64", "shape": shape, "copies": n,
                          **t, "plan_split": p.split,
                          "plan_blocks": p.blocks,
                          "routed": lmm.plan(*shape, "f64", n_sm()).kernel,
                          "bound_us": cs.bound(shape, F64)[0] * 1e3}),
              flush=True)


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
        print(json.dumps({"variant": name, "built": p.returncode == 0,
                          "ptxas": [ln.strip() for ln in log.splitlines()
                                    if "registers" in ln or "spill" in ln
                                    or "error" in ln]}), flush=True)
        if p.returncode:
            continue
        lib = ctypes.CDLL(os.path.join(out, f"{name}.so"))
        fn = lib.ecw_ladder_mm_f64_tc
        fn.argtypes, fn.restype = build._LADDER_MM, ctypes.c_int
        libs[name] = fn
    return libs


def variants():
    with tempfile.TemporaryDirectory() as out:
        fns = build_variants(out)
        good = {}
        for name, fn in fns.items():
            good[name] = all(check(fn, sh, 300 + i, name)
                             for i, sh in enumerate(VARIANT_CHECK))
        fns = {k: f for k, f in fns.items() if good[k]}
        for shape in VARIANT_TIMES:
            M, N, _ = shape
            args, n = cycled(shape)
            c = torch.empty((M, N), dtype=F64, device="cuda")
            t = timed({f"{k}_split{s}": (lambda f=f, s=s: launch(
                f, *args(), c, s)) for k, f in fns.items()
                for s in splits_of(shape)}, launches=launches_for(shape))
            print(json.dumps({"variants_us": shape, **t}), flush=True)


def load_counts(path):
    """Shared- and global-memory load opcodes in the kernel's SASS (LDS
    where the fragment loads stayed in shared memory)."""
    tool = cs.shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, on = {}, False
    for line in out.splitlines():
        if "Function : " in line:
            on = "f64tc" in line
        elif on:
            for op in cs.re.findall(r"\b(LDS(?:\.\w+)*|LD\.E(?:\.\w+)*|"
                                    r"DMMA(?:\.\w+)*)\b", line):
                counts[op] = counts.get(op, 0) + 1
    return counts


def main(argv):
    if not torch.cuda.is_available():
        print("f64tc_splits: needs a CUDA card", file=sys.stderr)
        return 2
    lib = build.library()
    print(json.dumps({"build_seconds": lib.build_seconds, "ptxas": [
        ln.strip() for ln in lib.log.splitlines()
        if any(w in ln for w in ("f64tc", "ntId", "registers", "spill",
                                 "warning", "error"))]}))
    print(json.dumps({"sass": {n: dict(c) for n, c in
                               cs.sass_counts(lib.path).items()
                               if "f64tc" in n or "ntId" in n},
                      "f64tc_loads": load_counts(lib.path)}), flush=True)
    fn = build.library().cdll.ecw_ladder_mm_f64_tc
    clusters = build.library().cdll.ecw_ladder_mm_f64_tc_clusters
    print(json.dumps({"max_active_clusters": {
        s: clusters(0, s) for s in (1, 2, 4, 8, 16)}}), flush=True)
    if not checks(fn):
        print(cs.nvidia_smi())
        return 1
    if "--variants" in argv:
        variants()
    times(fn, PATH[:2] if "--quick" in argv else PATH)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
