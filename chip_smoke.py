#!/usr/bin/env python3
"""Drive the PyTorch port (ecw_cc_torch) once on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, one output line each; any failure raises and exits nonzero:
  1. device: the card's name and power limit (nvidia-smi), TF32 off;
  2. build: the hand-written kernels compiled from ecw_cc_torch/csrc;
  3. kernel vs plain: ladder_mm against ladder_mm_ref (a @ b.T) in f32 and
     f64 at the solver's two sector-GEMM shapes and at ragged shapes, and
     both timed with CUDA events at the solver's shapes;
  4. main path, f32: ECW('c2h2', 'cc-pvdz') -> HF target with a field ->
     CCSD_GS over lambda = 0, 0.25, 0.5 (diis 'tl', conv_thres 1e-6); every
     lambda must converge and every iteration must launch the ladder
     kernel; then a fixed 41-iteration chain (conv_thres 0) for ms/iter;
  5. main path, f64: lambda = 0.25 on the card (through the kernel) and on
     the CPU (plain versions) must take the same iterations and agree in Ep
     to 1e-9 Ha; the f32 card solve must agree to 1e-5 Ha, iterations +-1;
  6. no JAX was imported.
Before the last line it prints the kernel report as one JSON object and
the card's `nvidia-smi` name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

MOLECULE, BASIS = "c2h2", "cc-pvdz"
FIELD = [0.05, 0.01, 0.0]
LAMBDAS = [0.0, 0.25, 0.5]
CONV_THRES = 1e-6
CHAIN_ITERS = 40
MAIN_SHAPES = [(98, 465, 465), (98, 961, 961)]          # (M, N, K)
RAGGED_SHAPES = [(1, 1, 1), (37, 513, 129), (100, 130, 1001)]
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}       # x max|C_ref|
TIMING_REPEATS = 30


def phase(n, name, **fields):
    print(json.dumps({"phase": n, "name": name, **fields}, default=float),
          flush=True)


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


def event_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def check_kernel(ladder_mm, ladder_mm_ref):
    worst_main = 0.0
    for dtype in (torch.float32, torch.float64):
        for i, shape in enumerate(MAIN_SHAPES + RAGGED_SHAPES):
            a, b = operands(shape, dtype, seed=i)
            c = ladder_mm(a, b)
            torch.cuda.synchronize()
            ref = ladder_mm_ref(a, b)
            torch.cuda.synchronize()
            err = float((c - ref).abs().max())
            scale = float(ref.abs().max())
            ok = err <= TOL[dtype] * scale
            phase(3, "kernel_vs_plain", dtype=str(dtype), shape=shape,
                  max_abs_err=err, max_abs_ref=scale, ok=ok)
            if not ok:
                raise AssertionError(f"ladder_mm disagrees at {shape} "
                                     f"{dtype}: {err} > {TOL[dtype]} * "
                                     f"{scale}")
            if dtype == torch.float32 and shape in MAIN_SHAPES:
                worst_main = max(worst_main, err)
    times = {}
    for shape in MAIN_SHAPES:
        a, b = operands(shape, torch.float32, seed=0)
        for _ in range(5):
            ladder_mm(a, b)
            ladder_mm_ref(a, b)
        torch.cuda.synchronize()
        t_k, t_r = [], []
        for _ in range(TIMING_REPEATS):     # in turns: plain, kernel
            t_r.append(event_ms(lambda: ladder_mm_ref(a, b)))
            t_k.append(event_ms(lambda: ladder_mm(a, b)))
        times[shape] = (statistics.median(t_k), statistics.median(t_r))
        phase(3, "kernel_time_f32", shape=shape, ms=times[shape][0],
              plain_ms=times[shape][1], repeats=TIMING_REPEATS)
    return worst_main, times


def build_ecw(device, dtype):
    from ecw_cc_torch import ECW

    ecw = ECW(MOLECULE, BASIS, device=device, dtype=dtype)
    ecw.Build_GS_exp("mat", "HF", field=FIELD)
    return ecw


def solve(ecw, lambdas, **kw):
    res = ecw.CCSD_GS(lambdas, diis=kw.pop("diis", "tl"), conv="tl", **kw)
    return res, ecw.solve_log


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a GPU",
              file=sys.stderr)
        return 2
    import ecw_cc_torch.config  # noqa: F401  (sets the TF32 switches)
    from ecw_cc_torch.kernels import build
    from ecw_cc_torch.kernels.ladder_mm import ladder_mm, ladder_mm_ref

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    assert tf32 == (False, False), f"TF32 is on: {tf32}"
    phase(1, "device", nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())

    # 2. build
    t0 = time.perf_counter()
    lib = build.library()
    phase(2, "build", seconds=time.perf_counter() - t0,
          nvcc_seconds=lib.build_seconds, library=lib.path,
          ptxas=[ln for ln in lib.log.splitlines() if "registers" in ln])

    # 3. kernel vs plain
    worst_main, times = check_kernel(ladder_mm, ladder_mm_ref)

    # 4. main path, f32
    ecw32 = build_ecw("cuda", torch.float32)
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
        raise AssertionError(f"ladder kernel launched {launches} times in "
                             f"{iters} iterations (expected {per_iter} each)")
    if not np.all(np.isfinite(res[4])) or res[4].shape != (ecw32.dim,) * 2:
        raise AssertionError("rdm1 is not finite or has the wrong shape")
    _, chain = solve(ecw32, [0.25], diis="", conv_thres=0.0,
                     maxiter=CHAIN_ITERS)
    chain = chain[0]
    phase(4, "chain_f32", iterations=chain["iterations"], ms=chain["ms"],
          ms_per_iteration=chain["ms"] / chain["iterations"])

    # 5. main path, f64, card against CPU
    res64, log64 = solve(build_ecw("cuda", torch.float64), [0.25],
                         conv_thres=CONV_THRES)
    resc, logc = solve(build_ecw("cpu", torch.float64), [0.25],
                       conv_thres=CONV_THRES)
    res32, log32 = solve(ecw32, [0.25], conv_thres=CONV_THRES)
    d64 = abs(float(res64[1][-1]) - float(resc[1][-1]))
    d32 = abs(float(res32[1][-1]) - float(resc[1][-1]))
    it = {k: v[0]["iterations"] for k, v in
          (("cuda_f64", log64), ("cpu_f64", logc), ("cuda_f32", log32))}
    phase(5, "f64_card_vs_cpu", iterations=it, Ep_cpu_f64=float(resc[1][-1]),
          dEp_cuda_f64=d64, dEp_cuda_f32=d32, ms_cuda_f64=log64[0]["ms"],
          ms_cpu_f64=logc[0]["ms"], ms_cuda_f32=log32[0]["ms"])
    if not all(s[0]["status"] == 1 for s in (log64, logc, log32)):
        raise AssertionError("a lambda = 0.25 solve did not converge")
    if it["cuda_f64"] != it["cpu_f64"] or d64 > 1e-9:
        raise AssertionError(f"f64 card solve differs from CPU: {it}, {d64}")
    if abs(it["cuda_f32"] - it["cpu_f64"]) > 1 or d32 > 1e-5:
        raise AssertionError(f"f32 card solve differs from CPU f64: {it}, "
                             f"{d32}")

    # 6. no JAX
    assert "jax" not in sys.modules, "jax was imported"
    phase(6, "no_jax", ok=True)

    ms, plain_ms = times[MAIN_SHAPES[-1]]
    print(json.dumps({"kernels": [{
        "name": "ladder_mm", "route": "cuda",
        "source": "ecw_cc_torch/csrc/ladder_mm.cu",
        "replaces": "ecw_cc_tpu/ops/ladder.py:54",
        "launches": launches, "max_abs_err": worst_main,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
