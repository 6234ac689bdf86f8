"""The replayed iteration's device-event time split into the graph's
launch and its execution, and a sweep's host spans: what
solvers/device_loop.Loop's 'replay_dev_ms' and ECW.CCSD_GS's 'driver'
ms hold.

    python3 tools/replay_split.py [--basis 6-311++g(2d,2p)]
                                  [--sleep-cycles 4000000]

Builds the benchmark's C2H2 ECW (f32) with a CCSD(T) 'mat' target and
runs the benchmark's sweep (lambda = linspace(0, 0.7, 8), diis 'tl',
conv_thres 1e-6, maxiter 80) three times.  The first warms up.  The
second runs as it is: one JSON line with its loops' replays and
replay_dev_ms and the sum over its lambdas of each 'driver' ms and of
each solve's host and loop stages.  In the third every CUDAGraph.replay
gets a pair of CUDA events of its own, in turns

  - 'idle': recorded on the idle stream just before the replay, as
    Loop's first event is, so the interval holds the host's launch of
    the graph and its execution;
  - 'busy': recorded after a spin kernel (torch.cuda._sleep) that holds
    the stream until the host has launched the graph, so the interval
    holds the execution alone (the kernels and the gaps between them);

with the host's time inside replay() and the spin's device time.  One
JSON line of their means; 'launch_ms' = idle - busy.  A busy replay
whose spin ended before the host's replay() returned is counted in
'short_spins' (raise --sleep-cycles until it reads 0).  Then the card's
name and power limit.  Needs a CUDA card (on the CPU the sweeps run and
no graph is replayed).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ecw_cc_torch import ECW  # noqa: E402

DRIVER = ("prepare_ms", "enter_ms", "exit_ms", "record_ms", "release_ms",
          "fetch_ms")
SOLVE = ("ms", "setup_ms", "lanes_ms", "finish_ms")
LOOP = ("warm_up_ms", "empty_cache_ms", "capture_ms", "replay_ms",
        "replay_dev_ms", "replays")


def sweep_line(solve_log, wall_ms):
    """{key: sum over the sweep} of the driver, solve and loop keys."""
    out = {"wall_ms": wall_ms}
    for key in DRIVER:
        out[key] = sum(e["driver"].get(key, 0.0) for e in solve_log)
    for key in SOLVE:
        out[key] = sum(e.get(key, 0.0) for e in solve_log)
    loops = [lp for e in solve_log for lp in e.get("loops", [])]
    for key in LOOP:
        out[key] = sum(lp.get(key, 0) for lp in loops)
    out["iterations"] = sum(e["iterations"] for e in solve_log)
    return out


def split_line(rows):
    """Means over the replays of each kind; rows: (kind, event ms, host
    ms, spin ms)."""
    out = {}
    for kind in ("idle", "busy"):
        sel = [r for r in rows if r[0] == kind]
        out[kind] = {"replays": len(sel),
                     "event_ms": float(np.mean([r[1] for r in sel]))
                     if sel else None,
                     "host_replay_ms": float(np.mean([r[2] for r in sel]))
                     if sel else None}
    busy = [r for r in rows if r[0] == "busy"]
    out["spin_ms"] = float(np.mean([r[3] for r in busy])) if busy else None
    out["short_spins"] = sum(r[3] <= r[2] for r in busy)
    if busy and len(busy) < len(rows):
        out["launch_ms"] = out["idle"]["event_ms"] - out["busy"]["event_ms"]
    return out


class SplitReplays:
    """Within the context, CUDAGraph.replay is timed in turns on an idle
    and on a busy stream; `rows()` reads the events (after a sync)."""

    def __init__(self, sleep_cycles):
        self.sleep_cycles, self.raw = sleep_cycles, []

    def __enter__(self):
        self.orig = torch.cuda.CUDAGraph.replay
        split = self

        def replay(graph):
            busy = len(split.raw) % 2 == 1
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            if busy:
                torch.cuda._sleep(split.sleep_cycles)
            ev[1].record()
            t0 = time.perf_counter()
            split.orig(graph)
            host_ms = (time.perf_counter() - t0) * 1e3
            ev[2].record()
            split.raw.append(("busy" if busy else "idle", ev, host_ms))

        torch.cuda.CUDAGraph.replay = replay
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph.replay = self.orig

    def rows(self):
        torch.cuda.synchronize()
        return [(kind, ev[1].elapsed_time(ev[2]), host_ms,
                 ev[0].elapsed_time(ev[1]))
                for kind, ev, host_ms in self.raw]


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--basis", default="6-311++g(2d,2p)")
    ap.add_argument("--sleep-cycles", type=int, default=4_000_000)
    args = ap.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    ecw = ECW("c2h2", args.basis, device=device, dtype=torch.float32)
    ecw.Build_GS_exp("mat", "CCSD(T)")
    lambdas = np.linspace(0.0, 0.7, 8)

    def sweep():
        ecw.solve_log = []
        t0 = time.perf_counter()
        ecw.CCSD_GS(lambdas, diis="tl", conv_thres=1e-6, maxiter=80)
        return sweep_line(ecw.solve_log, (time.perf_counter() - t0) * 1e3)

    sweep()
    print(json.dumps({"basis": args.basis, "sweep": sweep()}))
    if device == "cuda":
        with SplitReplays(args.sleep_cycles) as split:
            sweep()
        print(json.dumps({"basis": args.basis,
                          "split": split_line(split.rows())}))
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())


if __name__ == "__main__":
    main(sys.argv[1:])
