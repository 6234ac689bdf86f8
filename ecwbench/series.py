"""Runs cells one after another, each run its own process, as the check
runs them, and keeps every result line.

    python3 ecwbench/series.py --out chiprun_out/NAME.jsonl \
        WORKLOAD:SEED:SECONDS:TRACE [...]

Each line of --out is one run: its spec, exit code, seconds, the result
(the run's last stdout line, parsed) and the end of its stderr.  The
card's name and power limit head the file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def run_one(spec, extra_env=None):
    workload, seed, seconds, trace = spec.split(":")
    cmd = [sys.executable, os.path.join(ROOT, "ecwbench", "run.py"),
           "--workload", workload, "--seed", seed, "--seconds", seconds,
           "--trace", trace]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       env={**os.environ, **(extra_env or {})})
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"spec": spec, "rc": p.returncode,
            "seconds": time.perf_counter() - t0, "result": result,
            "stderr_tail": p.stderr[-6000:]}


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps({"card": card()}) + "\n")
        for spec in args.runs:
            rec = run_one(spec)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            r = rec["result"] or {}
            print(json.dumps({"spec": spec, "rc": rec["rc"],
                              "s": round(rec["seconds"], 1),
                              "correct": r.get("correct"),
                              "metrics": {k: v["value"] for k, v in
                                          r.get("metrics", {}).items()},
                              "checks": {k: v["value"] for k, v in
                                         r.get("checks", {}).items()},
                              "mem": r.get("device", {}).get(
                                  "memory_peak_bytes")}), flush=True)
            if rec["rc"] != 0:
                print(rec["stderr_tail"][-3000:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
