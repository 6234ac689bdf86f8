#!/usr/bin/env python3
"""Drive the PyTorch port (ecw_cc_torch) once on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --kernel-times   # phase 1 and the kernel timing only
    python3 chip_smoke.py --profile        # phase 1 and a profiler trace of
                                           # the f32 chain, cc-pVDZ and cc-pVTZ

Phases, one output line each (and one "phase_seconds" line at the end of
each); any failure raises and exits nonzero:
  1. device: the card's name and power limit (nvidia-smi), TF32 off;
  2. build: the hand-written kernels compiled from ecw_cc_torch/csrc, with
     ptxas's registers and spills per kernel, and the SASS check that the
     f64 ladder_mm runs DMMA and the f32 one no HMMA;
  3. kernel vs plain: ladder_mm against ladder_mm_ref (a @ b.T) in f32 and
     f64 at the solver's sector-GEMM shapes of C2H2/cc-pVDZ and cc-pVTZ,
     ragged shapes and shapes at the edges of the split-K plan (printed
     per shape, with its plan); two launches bitwise equal; one launch
     captured in a CUDA graph and replayed twice, equal to the eager
     result; then both timed at the solver's shapes;
  4. main path, f32: ECW('c2h2', 'cc-pvdz') (ERIs transformed on the card)
     -> HF target with a field -> CCSD_GS over lambda = 0, 0.25, 0.5 (diis
     'tl', conv_thres 1e-6); every lambda must converge and every
     iteration must launch the ladder kernel; then a fixed 41-iteration
     chain (conv_thres 0) for ms/iter;
  5. main path, f64: lambda = 0.25 on the card (through the kernel) and on
     the CPU (plain versions) must take the same iterations and agree in Ep
     to 1e-9 Ha; the f32 card solve must agree to 1e-5 Ha, iterations +-1;
  6. ERI build at cc-pVDZ on the card: build_eris_device (sorted, sectored)
     at f64 and at f32 against the host f64 build_eris + sorted_from_host,
     block by block, to 1e-10 and 3e-6;
  7. main path at full width, C2H2/cc-pVTZ f32: ECW -> HF target ->
     CCSD_GS([0.25]) must converge with 2 ladder launches per iteration,
     and agree with the same solve on f64 ERIs built on the card to 1e-5
     Ha, iterations +-1; prints the set-up seconds, peak device memory
     of the build and the solve, and ms/iter of a 20-iteration chain;
  8. neither JAX nor the JAX package ecw_cc_tpu was imported.
Before the last line it prints the kernel report as one JSON object and
the card's `nvidia-smi` name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Kernel times are device times: a sleep kernel holds the stream while the
host enqueues a run of TIMING_LAUNCHES back-to-back launches between two
CUDA events, so the run's time over its count excludes the host's enqueue;
the median of TIMING_RUNS runs, kernel and plain in turns.  Where B is
large enough to matter against the 50 MB L2 (the cc-pVTZ shapes), the
launches cycle through copies of the operands that together exceed twice
the L2, so B comes from device memory as it does in the solve.  The host's
own cost per call (no sync between calls) is printed beside it.  Each
shape's bound is the larger of 2MNK over the published 67 TFLOP/s (FP32,
and FP64 on the tensor cores, H100 SXM) and one pass over A, B and C over
3.35 TB/s.
"""

import collections
import contextlib
import copy
import json
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

MOLECULE, BASIS = "c2h2", "cc-pvdz"
BASIS_TZ = "cc-pvtz"
FIELD = [0.05, 0.01, 0.0]
LAMBDAS = [0.0, 0.25, 0.5]
CONV_THRES = 1e-6
CHAIN_ITERS = 40
CHAIN_ITERS_TZ = 19          # maxiter 19: a 20-iteration chain
PROFILE_ITERS = 10
DTYPES = (torch.float32, torch.float64)
MAIN_SHAPES = [(98, 465, 465), (98, 961, 961)]          # (M, N, K), pVDZ
TZ_SHAPES = [(98, 3240, 3240), (98, 6561, 6561)]        # cc-pVTZ
TIMED_SHAPES = MAIN_SHAPES + TZ_SHAPES
RAGGED_SHAPES = [(1, 1, 1), (37, 513, 129), (100, 130, 1001)]
# The split-K plan's edges: K across 16 chunks (split 8 -> 16 at N = 465)
# and 17, K across a chunk boundary at N = 961, K below one chunk, one row,
# and M = 129 (two row tiles).
EDGE_SHAPES = [(98, 465, 240), (98, 465, 241), (98, 465, 256), (98, 465, 257),
               (98, 961, 959), (98, 961, 960), (98, 465, 15), (98, 465, 17),
               (1, 961, 961), (129, 465, 465), (129, 961, 961)]
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}       # x max|C_ref|
ERI_TOL = {torch.float64: 1e-10, torch.float32: 3e-6}   # max abs vs host f64
TIMING_RUNS = 10
TIMING_LAUNCHES = 50
HOST_CALLS = 200
SLEEP_CYCLES = 20_000_000   # ~11 ms at 1.8 GHz: longer than any enqueue run
L2_BYTES = 50 * 2 ** 20
COLD_B_BYTES = 8 * 2 ** 20  # a B this large is timed cold (cycled copies)
PEAK_FLOPS = 67e12          # H100 SXM: FP32 (CUDA cores) and FP64 tensor
PEAK_BYTES = 3.35e12        # H100 SXM HBM3, bytes/s


def phase(n, name, **fields):
    print(json.dumps({"phase": n, "name": name, **fields}, default=float),
          flush=True)


@contextlib.contextmanager
def timed(n, seconds):
    """Record phase n's host seconds into `seconds` and print them."""
    t0 = time.perf_counter()
    yield
    seconds[n] = time.perf_counter() - t0
    phase(n, "phase_seconds", seconds=seconds[n])


def bound(shape, dtype):
    """(ms, 'operations' or 'bytes'): the least time the card could take
    for C = A @ B.T at `shape`, one pass over A, B and C."""
    M, N, K = shape
    size = torch.finfo(dtype).bits // 8
    t_ops = 2 * M * N * K / PEAK_FLOPS
    t_bytes = (M * K + N * K + M * N) * size / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def operands(shape, dtype, seed):
    M, N, K = shape
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.standard_normal((M, K)), dtype=dtype).cuda()
    b = torch.as_tensor(rng.standard_normal((N, K)), dtype=dtype).cuda()
    return a, b


def tag(shape):
    return "x".join(map(str, shape))


def sass_counts(path):
    """{kernel name: Counter of DMMA/HMMA/FFMA} from cuobjdump -sass."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
        elif fn is not None:
            for op in re.findall(r"\b(DMMA|HMMA|FFMA)\b", line):
                counts[fn][op] += 1
    return counts


def check_sass(path):
    """Every f64 ladder_mm instance runs DMMA; no f32 one touches the
    tensor cores (no TF32, no HMMA)."""
    counts = sass_counts(path)
    f32 = {n: dict(c) for n, c in counts.items() if "ladder_mm_ntIf" in n}
    f64 = {n: dict(c) for n, c in counts.items() if "ladder_mm_ntId" in n}
    if not f32 or not f64:
        raise AssertionError(f"ladder_mm kernels not found in SASS: "
                             f"{sorted(counts)}")
    if not all(c.get("DMMA", 0) for c in f64.values()):
        raise AssertionError(f"an f64 ladder_mm runs no DMMA: {f64}")
    if any(c.get("HMMA", 0) or c.get("DMMA", 0) for c in f32.values()):
        raise AssertionError(f"an f32 ladder_mm uses tensor cores: {f32}")
    return {"float32": list(f32.values()), "float64": list(f64.values())}


def plan_fields(p):
    return {"tile": [p.bm, p.bn, p.bk], "tiles": [p.m_tiles, p.n_tiles],
            "split_k": p.split, "blocks": p.blocks}


def check_kernel(ladder_mm, ladder_mm_ref, device_plan, n_sm):
    """Kernel against plain at every shape; the cc-pVDZ shapes' plans fill
    the card (the cc-pVTZ ones run about 1.5 waves and are only printed).
    Returns {(dtype, shape): (max_abs_err, plan)}."""
    out = {}
    for dtype in DTYPES:
        for i, shape in enumerate(MAIN_SHAPES + TZ_SHAPES + RAGGED_SHAPES
                                  + EDGE_SHAPES):
            a, b = operands(shape, dtype, seed=i)
            c = ladder_mm(a, b)
            torch.cuda.synchronize()
            ref = ladder_mm_ref(a, b)
            torch.cuda.synchronize()
            err = float((c - ref).abs().max())
            scale = float(ref.abs().max())
            ok = bool(torch.isfinite(c).all()) and err <= TOL[dtype] * scale
            p = device_plan(*shape, dtype, a.device)
            phase(3, "kernel_vs_plain", dtype=str(dtype), shape=shape,
                  max_abs_err=err, max_abs_ref=scale, ok=ok,
                  waves=p.blocks / n_sm, **plan_fields(p))
            if not ok:
                raise AssertionError(f"ladder_mm disagrees at {shape} "
                                     f"{dtype}: {err} > {TOL[dtype]} * "
                                     f"{scale}")
            if shape in MAIN_SHAPES and p.blocks < n_sm:
                raise AssertionError(f"plan at {shape} {dtype} launches "
                                     f"{p.blocks} blocks on {n_sm} SMs")
            out[(dtype, shape)] = (err, p)
    return out


def check_deterministic(ladder_mm):
    """Two launches on the same inputs give the same bits; so does a launch
    captured in a CUDA graph on a side stream, replayed twice."""
    for dtype in DTYPES:
        for shape in MAIN_SHAPES + TZ_SHAPES:
            a, b = operands(shape, dtype, seed=11)
            c1, c2 = ladder_mm(a, b), ladder_mm(a, b)
            s = torch.cuda.Stream()
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                ladder_mm(a, b)   # warm-up on the capture stream
            s.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=s):
                cg = ladder_mm(a, b)
            replays = []
            for _ in range(2):
                cg.fill_(float("nan"))
                g.replay()
                torch.cuda.synchronize()
                replays.append(bool(torch.equal(cg, c1)))
            bitwise = bool(torch.equal(c1, c2))
            phase(3, "kernel_deterministic", dtype=str(dtype), shape=shape,
                  bitwise=bitwise, graph_replays_equal=replays)
            if not (bitwise and all(replays)):
                raise AssertionError(f"ladder_mm is not deterministic at "
                                     f"{shape} {dtype}: {bitwise}, "
                                     f"{replays}")


def device_run_ms(fn, n):
    """Device ms per launch of n back-to-back launches of fn."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)   # the enqueue below ends before it does
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def host_us(fn, n):
    """Host µs per call, n calls with no sync in between."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def time_kernel(ladder_mm, ladder_mm_ref):
    """{(dtype, shape): times} for the kernel and a @ b.T at TIMED_SHAPES.
    The plain version is one library call (cuBLAS), so its time is also
    the report's library_ms."""
    times = {}
    for dtype in DTYPES:
        for shape in TIMED_SHAPES:
            a, b = operands(shape, dtype, seed=0)
            b_bytes = b.numel() * b.element_size()
            n_copies = (-(-2 * L2_BYTES // b_bytes)
                        if b_bytes >= COLD_B_BYTES else 1)
            ops = [(a, b)] + [(a.clone(), b.clone())
                              for _ in range(n_copies - 1)]
            turn = [0]

            def args():
                turn[0] += 1
                return ops[turn[0] % n_copies]

            def kern():
                return ladder_mm(*args())

            def plain():
                return ladder_mm_ref(*args())

            for _ in range(5):
                kern()
                plain()
            torch.cuda.synchronize()
            runs = {kern: [], plain: []}
            for i in range(TIMING_RUNS):   # plain, kernel, kernel, plain, ...
                for fn in ((plain, kern) if i % 2 == 0 else (kern, plain)):
                    runs[fn].append(device_run_ms(fn, TIMING_LAUNCHES))
            bound_ms, bound_by = bound(shape, dtype)
            t = {"ms": statistics.median(runs[kern]),
                 "plain_ms": statistics.median(runs[plain]),
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "operand_copies": n_copies,
                 "ms_runs": runs[kern], "plain_ms_runs": runs[plain],
                 "host_us": host_us(kern, HOST_CALLS),
                 "plain_host_us": host_us(plain, HOST_CALLS)}
            times[(dtype, shape)] = t
            phase(3, "kernel_time", dtype=str(dtype), shape=shape,
                  runs=TIMING_RUNS, launches_per_run=TIMING_LAUNCHES, **t)
    return times


def build_ecw(device, dtype, basis=BASIS):
    from ecw_cc_torch import ECW

    ecw = ECW(MOLECULE, basis, device=device, dtype=dtype)
    ecw.Build_GS_exp("mat", "HF", field=FIELD)
    return ecw


def solve(ecw, lambdas, **kw):
    res = ecw.CCSD_GS(lambdas, diis=kw.pop("diis", "tl"), conv="tl", **kw)
    return res, ecw.solve_log


def with_eris(ecw, eris, vvvv_op):
    """A shallow copy of a built ECW that solves on other device ERIs (the
    same molecule, SCF and targets)."""
    out = copy.copy(ecw)
    out.eris, out.vvvv_op, out.myccsd = eris, vvvv_op, None
    out.dtype = eris.oovv.dtype
    return out


def max_abs_diff(a, b):
    if a.numel() == 0 and b.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def check_eri_build(ecw):
    """Phase 6: build_eris_device (sorted, sectored) at f64 and f32 on the
    card against the host f64 build_eris + sorted_from_host, block by
    block.  Returns {dtype name: max abs error}."""
    from ecw_cc_torch.models.eris import (GEris, build_eris_device,
                                          sorted_from_host)

    ref, ref_sect = sorted_from_host(ecw.eris_host, ecw.mo_perm,
                                     dtype=torch.float64, device="cuda")
    out = {}
    for dtype in (torch.float64, torch.float32):
        timings = {}
        er, sect = build_eris_device(ecw.mol, ecw.mf, dtype=dtype,
                                     device="cuda", pack_ladder=True,
                                     sort_spin=True, timings=timings)
        errs = {f: max_abs_diff(getattr(er, f), getattr(ref, f))
                for f in GEris._fields}
        errs.update({f"sect.{f}": max_abs_diff(x, y) for f, x, y in
                     zip(sect._fields, sect, ref_sect)})
        worst = max(errs.values())
        shapes_ok = all(getattr(er, f).shape == getattr(ref, f).shape
                        for f in GEris._fields) and all(
            x.shape == y.shape for x, y in zip(sect, ref_sect))
        name = str(dtype).split(".")[-1]
        phase(6, "eri_build_vs_host", dtype=name, max_abs_err=worst,
              tol=ERI_TOL[dtype], worst_block=max(errs, key=errs.get),
              shapes_ok=shapes_ok, **timings)
        if not shapes_ok or worst > ERI_TOL[dtype]:
            raise AssertionError(f"device ERI build at {name} differs from "
                                 f"the host build: {errs}")
        out[name] = worst
    return out


def run_tz(ladder_mm):
    """Phase 7: the full-width C2H2/cc-pVTZ solve at f32 on device-built
    ERIs, and its f64 reference on ERIs built on the card.  Returns the
    ladder launches of the f32 solve."""
    from ecw_cc_torch.models.eris import build_eris_device

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ecw = build_ecw("cuda", torch.float32, basis=BASIS_TZ)
    torch.cuda.synchronize()
    phase(7, "build_tz_f32", seconds=time.perf_counter() - t0,
          **ecw.timings, peak_bytes=torch.cuda.max_memory_allocated(),
          host_eris_built=ecw._eris_host is not None, nao=ecw.aosize,
          nmo=ecw.dim, nocc=ecw.nocc, nvir=ecw.nvir)
    if ecw._eris_host is not None:
        raise AssertionError("the f32 build made host G-format ERIs")

    torch.cuda.reset_peak_memory_stats()
    ladder_mm.launches = 0
    res, log = solve(ecw, [0.25], conv_thres=CONV_THRES)
    launches = ladder_mm.launches
    s32, ep32 = log[0], float(res[1][-1])
    phase(7, "solve_tz_f32", iterations=s32["iterations"],
          converged=s32["status"] == 1, Ep=ep32, Ep_total=ep32 + ecw.EHF,
          ms=s32["ms"], ladder_launches=launches,
          peak_bytes=torch.cuda.max_memory_allocated(), sym=s32["sym"])
    if s32["status"] != 1:
        raise AssertionError("the cc-pVTZ f32 solve did not converge")
    if launches != 2 * s32["iterations"]:
        raise AssertionError(f"ladder kernel launched {launches} times in "
                             f"{s32['iterations']} cc-pVTZ iterations "
                             "(expected 2 each)")
    if not np.all(np.isfinite(res[4])) or res[4].shape != (ecw.dim,) * 2:
        raise AssertionError("cc-pVTZ rdm1 is not finite or has the wrong "
                             "shape")
    _, chain = solve(ecw, [0.25], diis="", conv_thres=0.0,
                     maxiter=CHAIN_ITERS_TZ)
    chain = chain[0]
    phase(7, "chain_tz_f32", iterations=chain["iterations"], ms=chain["ms"],
          ms_per_iteration=chain["ms"] / chain["iterations"])

    # the f64 reference: the same molecule, SCF and target, on f64 ERIs
    # built on the card (the host route would hold 176^4 f64 on the host)
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    er64, sect64 = build_eris_device(ecw.mol, ecw.mf, dtype=torch.float64,
                                     device="cuda", pack_ladder=True,
                                     sort_spin=True, timings=timings)
    build64_peak = torch.cuda.max_memory_allocated()
    ecw64 = with_eris(ecw, er64, sect64)
    del ecw
    torch.cuda.reset_peak_memory_stats()
    res64, log64 = solve(ecw64, [0.25], conv_thres=CONV_THRES)
    s64, ep64 = log64[0], float(res64[1][-1])
    dep = abs(ep32 - ep64)
    phase(7, "solve_tz_f64_vs_f32", iterations_f64=s64["iterations"],
          iterations_f32=s32["iterations"], converged=s64["status"] == 1,
          Ep_f64=ep64, dEp=dep, ms_f64=s64["ms"], build_f64=timings,
          build_f64_peak_bytes=build64_peak,
          solve_f64_peak_bytes=torch.cuda.max_memory_allocated())
    if s64["status"] != 1:
        raise AssertionError("the cc-pVTZ f64 solve did not converge")
    if abs(s64["iterations"] - s32["iterations"]) > 1 or dep > 1e-5:
        raise AssertionError(f"cc-pVTZ f32 solve differs from f64: "
                             f"{s32['iterations']} vs {s64['iterations']} "
                             f"iterations, |dEp| = {dep}")
    return launches


def kernel_kind(name):
    """The §5 breakdown's class of a kernel, from its name."""
    low = name.lower()
    for kind, keys in (("ladder_mm", ("ladder_mm",)),
                       ("gemm", ("gemm", "gemv", "splitk")),
                       ("elementwise", ("elementwise", "vectorized")),
                       ("reduce", ("reduce",)),
                       ("cat_index", ("cat", "index", "gather", "scatter"))):
        if any(k in low for k in keys):
            return kind
    return "other"


def profile_chain(basis):
    """--profile: a torch.profiler trace of a fixed PROFILE_ITERS-iteration
    f32 chain at lambda = 0.25 (after a warm-up solve), beside the same
    chain run without the profiler.  Prints kernels and launch calls per
    iteration, device ms per iteration by kernel class, the ten costliest
    kernels, and the busy share (device time over the unprofiled wall)."""
    from torch.profiler import ProfilerActivity, profile

    ecw = build_ecw("cuda", torch.float32, basis=basis)
    solve(ecw, [0.25], conv_thres=CONV_THRES)
    chain = dict(diis="", conv_thres=0.0, maxiter=PROFILE_ITERS - 1)
    _, plain = solve(ecw, [0.25], **chain)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, log = solve(ecw, [0.25], **chain)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = log[0]["iterations"]
    by_kind, kernels = collections.Counter(), []
    n_kernels = launch_calls = 0
    for e in prof.key_averages():
        if e.key.startswith("cudaLaunchKernel"):
            launch_calls += e.count
        if str(e.device_type).endswith("CUDA"):
            us = e.self_device_time_total
            n_kernels += e.count
            by_kind[kernel_kind(e.key)] += us / 1e3 / n
            kernels.append((us, e.count, e.key[:100]))
    device_ms = sum(by_kind.values())
    plain_ms = plain[0]["ms"] / plain[0]["iterations"]
    phase("P", "profile", basis=basis, iterations=n,
          kernels_per_iteration=n_kernels / n,
          launch_calls_per_iteration=launch_calls / n,
          device_ms_per_iteration=device_ms,
          device_ms_by_kind=dict(by_kind),
          profiled_ms_per_iteration=wall_ms / n,
          ms_per_iteration=plain_ms, busy_share=device_ms / plain_ms,
          top_kernels=[{"name": k, "launches": c, "ms": us / 1e3}
                       for us, c, k in sorted(kernels, reverse=True)[:10]])


def kernel_report(launches, checks, times):
    """The kernel line: the headline numbers are f32 at the largest main
    path shape (98x6561x6561, cc-pVTZ alpha-beta); every timed shape is
    under by_dtype.  launches: {main path: ladder launches in its run}."""
    by_dtype = {}
    for dtype in DTYPES:
        by_dtype[str(dtype).split(".")[-1]] = {tag(shape): {
            "ms": times[(dtype, shape)]["ms"],
            "plain_ms": times[(dtype, shape)]["plain_ms"],
            "library_ms": times[(dtype, shape)]["plain_ms"],
            "bound_ms": times[(dtype, shape)]["bound_ms"],
            "bound_by": times[(dtype, shape)]["bound_by"],
            "host_us": times[(dtype, shape)]["host_us"],
            "plain_host_us": times[(dtype, shape)]["plain_host_us"],
            "max_abs_err": checks[(dtype, shape)][0],
            "blocks": checks[(dtype, shape)][1].blocks,
            "split_k": checks[(dtype, shape)][1].split}
            for shape in TIMED_SHAPES}
    main = (torch.float32, TZ_SHAPES[-1])
    return {"kernels": [{
        "name": "ladder_mm", "route": "cuda",
        "source": "ecw_cc_torch/csrc/ladder_mm.cu",
        "replaces": "ecw_cc_tpu/ops/ladder.py:54",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(checks[(torch.float32, s)][0]
                           for s in TIMED_SHAPES),
        "ms": times[main]["ms"], "plain_ms": times[main]["plain_ms"],
        "bound_ms": times[main]["bound_ms"],
        "bound_by": times[main]["bound_by"],
        "library_ms": times[main]["plain_ms"],
        "shape": tag(main[1]), "dtype": "float32",
        "blocks": checks[main][1].blocks, "split_k": checks[main][1].split,
        "deterministic": True, "by_dtype": by_dtype}]}


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a GPU",
              file=sys.stderr)
        return 2
    import ecw_cc_torch.config  # noqa: F401  (sets the TF32 switches)
    from ecw_cc_torch.kernels import build
    from ecw_cc_torch.kernels import ladder_mm as lmm

    ladder_mm, ladder_mm_ref = lmm.ladder_mm, lmm.ladder_mm_ref
    t_start = time.perf_counter()
    seconds = {}

    # 1. device
    with timed(1, seconds):
        smi = nvidia_smi()
        kind = torch.cuda.get_device_name(0)
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        assert tf32 == (False, False), f"TF32 is on: {tf32}"
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        phase(1, "device", nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, count=torch.cuda.device_count(),
              sms=n_sm)

    if "--kernel-times" in argv:
        # Timing only, through whatever ecw_cc_torch is importable: the
        # same method can time an older checkout's kernel.
        times = time_kernel(ladder_mm, ladder_mm_ref)
        print(json.dumps({"kernel_times": {
            f"{str(d).split('.')[-1]} {tag(s)}": t
            for (d, s), t in times.items()}}))
        print(smi)
        return 0
    if "--profile" in argv:
        for basis in (BASIS, BASIS_TZ):
            profile_chain(basis)
        print(smi)
        return 0

    # 2. build
    with timed(2, seconds):
        t0 = time.perf_counter()
        lib = build.library()
        phase(2, "build", seconds=time.perf_counter() - t0,
              nvcc_seconds=lib.build_seconds, library=lib.path,
              ptxas=[ln.strip() for ln in lib.log.splitlines()
                     if re.search(r"registers|spill|entry function", ln)],
              sass=check_sass(lib.path))

    # 3. kernel vs plain
    with timed(3, seconds):
        checks = check_kernel(ladder_mm, ladder_mm_ref, lmm.device_plan,
                              n_sm)
        check_deterministic(ladder_mm)
        times = time_kernel(ladder_mm, ladder_mm_ref)

    # 4. main path, f32 (ERIs transformed on the card)
    with timed(4, seconds):
        ecw32 = build_ecw("cuda", torch.float32)
        phase(4, "build_f32", **ecw32.timings,
              host_eris_built=ecw32._eris_host is not None)
        ladder_mm.launches = 0
        t0 = time.perf_counter()
        res, log = solve(ecw32, LAMBDAS, conv_thres=CONV_THRES)
        sweep_ms = (time.perf_counter() - t0) * 1e3
        launches = ladder_mm.launches
        iters = sum(s["iterations"] for s in log)
        per_iter = 2 if all(s["sym"] for s in log) else 3
        for s, ep, delta in zip(log, ecw32.Ep_lamb, ecw32.Delta_lamb):
            phase(4, "solve_f32", L=s["L"], iterations=s["iterations"],
                  converged=s["status"] == 1, Ep=ecw32.EHF - ep, Delta=delta,
                  ms=s["ms"], sym=s["sym"])
        phase(4, "sweep_f32", ms=sweep_ms, iterations=iters,
              ladder_launches=launches, launches_per_iteration=per_iter)
        if not all(s["status"] == 1 for s in log):
            raise AssertionError("an f32 lambda did not converge")
        if launches != per_iter * iters:
            raise AssertionError(f"ladder kernel launched {launches} times "
                                 f"in {iters} iterations (expected "
                                 f"{per_iter} each)")
        if not np.all(np.isfinite(res[4])) or res[4].shape != (ecw32.dim,) * 2:
            raise AssertionError("rdm1 is not finite or has the wrong shape")
        _, chain = solve(ecw32, [0.25], diis="", conv_thres=0.0,
                         maxiter=CHAIN_ITERS)
        chain = chain[0]
        phase(4, "chain_f32", iterations=chain["iterations"], ms=chain["ms"],
              ms_per_iteration=chain["ms"] / chain["iterations"])

    # 5. main path, f64, card against CPU; f32 (device ERIs) against both
    with timed(5, seconds):
        res64, log64 = solve(build_ecw("cuda", torch.float64), [0.25],
                             conv_thres=CONV_THRES)
        resc, logc = solve(build_ecw("cpu", torch.float64), [0.25],
                           conv_thres=CONV_THRES)
        res32, log32 = solve(ecw32, [0.25], conv_thres=CONV_THRES)
        d64 = abs(float(res64[1][-1]) - float(resc[1][-1]))
        d32 = abs(float(res32[1][-1]) - float(resc[1][-1]))
        it = {k: v[0]["iterations"] for k, v in
              (("cuda_f64", log64), ("cpu_f64", logc), ("cuda_f32", log32))}
        phase(5, "f64_card_vs_cpu", iterations=it,
              Ep_cpu_f64=float(resc[1][-1]), dEp_cuda_f64=d64,
              dEp_cuda_f32=d32, ms_cuda_f64=log64[0]["ms"],
              ms_cpu_f64=logc[0]["ms"], ms_cuda_f32=log32[0]["ms"])
        if not all(s[0]["status"] == 1 for s in (log64, logc, log32)):
            raise AssertionError("a lambda = 0.25 solve did not converge")
        if it["cuda_f64"] != it["cpu_f64"] or d64 > 1e-9:
            raise AssertionError(f"f64 card solve differs from CPU: {it}, "
                                 f"{d64}")
        if abs(it["cuda_f32"] - it["cpu_f64"]) > 1 or d32 > 1e-5:
            raise AssertionError(f"f32 card solve differs from CPU f64: "
                                 f"{it}, {d32}")

    # 6. ERI build at cc-pVDZ on the card against the host build
    with timed(6, seconds):
        check_eri_build(ecw32)
        del ecw32

    # 7. main path at full width: C2H2/cc-pVTZ
    with timed(7, seconds):
        launches_tz = run_tz(ladder_mm)

    # 8. neither JAX nor the JAX package
    with timed(8, seconds):
        bad = sorted(m for m in sys.modules if m in ("jax", "ecw_cc_tpu")
                     or m.startswith(("jax.", "jaxlib", "ecw_cc_tpu.")))
        if bad:
            raise AssertionError(f"imported: {bad}")
        phase(8, "no_jax", ok=True)

    phase(0, "seconds", total=time.perf_counter() - t_start,
          by_phase=seconds)
    print(json.dumps(kernel_report(
        {"c2h2_ccpvdz_f32_sweep": launches,
         "c2h2_ccpvtz_f32_solve": launches_tz}, checks, times)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
