"""One run of one cell: set-up and warm-up, the measured window, the
per-layer metrics of a traced run, the check against the reference, and
the result line.

    python3 ecwbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of stdout is one JSON object (correct, attempted, failed,
metrics, device, with --trace 1 breakdown, and last the compared numbers
beside their limits); the last lines of stderr are those numbers too.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import types

from ecwbench import spec

# modules that must not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "ecw_cc_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs(root):
    """Fixed build and kernel-cache directories inside the checkout, so
    that only a checkout's first run builds (the port builds its own
    kernels into ecw_cc_torch/_build/)."""
    base = os.path.join(root, ".ecwbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(base, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def err(*a):
    print(*a, file=sys.stderr, flush=True)


class Ctx(types.SimpleNamespace):
    """What a per-layer metric reader reads: the window's job records
    (`jobs`, each with `traced`), the traced jobs' device and host
    operations ((name, start us, end us) in `dev`, `host`) and their
    seconds (`window_s`), the configuration `cfg`, the `traffic`, the
    kernel `families`, and sum_keys."""

    def records(self, kind, traced=False):
        return [r for r in self.jobs
                if r["kind"] == kind and r["traced"] == traced]


def sum_keys(obj, keys):
    """The sum of every value under one of `keys` in nested dicts and
    lists (the program's loop logs)."""
    if isinstance(obj, dict):
        return sum(v if k in keys and isinstance(v, (int, float))
                   else sum_keys(v, keys) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return sum(sum_keys(v, keys) for v in obj)
    return 0.0


def job_line(r):
    """What a job's wall time went to, for the run's stderr."""
    caps = ("capture_ms", "empty_cache_ms")
    if r["kind"] == "sweep":
        log = r["solve_log"]
        return (f"wall {r['wall_ms']:.1f} ms, solves "
                f"{sum(s['ms'] for s in log):.1f} ms, iterations "
                f"{[s['iterations'] for s in log]}, captures "
                f"{sum_keys([s['loops'] for s in log], caps):.1f} ms")
    from ecwbench.jobs import stages

    return (f"wall {r['wall_ms']:.1f} ms, stages "
            f"{json.dumps(stages(r['target_log']))}, captures "
            f"{sum_keys(r['target_log'], caps):.1f} ms")


def run_window(work, seconds, traced_jobs, trace_on):
    """The closed loop: whole jobs back to back until `seconds` have
    passed, then with a trace the traced jobs under the profiler.
    Returns (records, window seconds of the untraced jobs, trace)."""
    from ecwbench import trace

    records = []
    t0 = time.perf_counter()
    while True:
        records.append({**work.run(), "traced": False})
        window = time.perf_counter() - t0
        if window >= seconds:
            break
    tr = None
    if trace_on:
        with trace.profiled() as holder:
            for _ in range(traced_jobs):
                records.append({**work.run(), "traced": True})
        tr = holder.events
    return records, window, tr


def main(argv, t_start):
    """The command: refuses without the cards the cell asks for, runs it,
    prints the result line.  Returns the exit code."""
    args = parse(argv)
    sp = spec.Spec()
    chips = sp.cell(args.workload).work["chips"]
    cache_dirs(sp.root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        err(f"no result: the cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"device_count = {torch.cuda.device_count()}")
        return 2
    result = run_cell(sp, args, t_start, device="cuda")
    found = forbidden_loaded()
    if found:
        err(f"no result: the process loaded {found}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


def run_cell(sp, args, t_start, device):
    """Set-up, window, per-layer metrics, check: the result as a dict.
    On the CPU (the harness's tests) the device fields say so."""
    import torch

    from ecwbench import check, jobs, trace
    from ecwbench.reference.aoints import load_basis
    from ecwbench.reference.solve import solve

    c = sp.cell(args.workload)
    cfg, traffic = c.cfg, c.traffic
    cuda = device == "cuda"
    atoms = jobs.geometry(cfg, args.seed)
    t_imports = time.perf_counter() - t_start
    work = jobs.Work(cfg, traffic, atoms, device=device)
    warm = [work.run()["wall_ms"]
            for _ in range(traffic.get("warmup_jobs", 1))]
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    err(f"setup: {setup_s:.3f} s: imports {t_imports:.3f} s, "
        f"{json.dumps(work.setup_log)}, warm-up jobs ms {warm}")

    records, window, tr = run_window(work, args.seconds,
                                     traffic.get("traced_jobs", 1),
                                     args.trace == 1)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_loaded()
    if found:
        raise SystemExit(f"no result: the process loaded {found}")
    for i, r in enumerate(records):
        if "memory" in r:
            err(f"memory after job {i} ({r['kind']}, traced={r['traced']}):"
                f" allocated {r['memory'][0]} B, peak {r['memory'][1]} B")
        err(f"job {i}: {job_line(r)}")

    metrics = {}
    if args.trace == 0:
        n = sum(not r["traced"] for r in records)
        values = {"setup_s": setup_s, f"{work.kind}_ms": window * 1e3 / n}
        for m in c.e2e:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        dev, host, window_s = tr
        ctx = Ctx(jobs=records, dev=dev, host=host, window_s=window_s,
                  cfg=cfg, traffic=traffic, families=sp.kernel_families(),
                  sum_keys=sum_keys)
        for m in c.layer:
            v = sp.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    got = check.answers(work.kind, work.setup_answers(), records)
    del work, records
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = solve(atoms, load_basis(sp.path(cfg["basis_file"])),
                jobs.lambdas(traffic) if traffic["job"] == "sweep" else None,
                device=device)
    nums, per_job = check.numbers(traffic["job"], got, ref)
    correct, failed, rows = check.judge(nums, per_job, c.limits)
    err(f"reference: {time.perf_counter() - t_ref:.3f} s")

    result = {"correct": correct, "attempted": len(per_job),
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if cuda
                                  else "cpu"),
                         "count": c.work["chips"] if cuda else 0,
                         "memory_peak_bytes": peak}}
    if tr is not None:
        dev, host, window_s = tr
        busy = trace.union_us([(s, e) for _, s, e in dev]) / 1e6
        result["device"].update(busy_s=busy, window_s=window_s)
        result["breakdown"] = trace.breakdown(dev, host)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for k, v, lim in rows:
        err(f"check {k} {v!r} limit {lim!r}")
    return result
