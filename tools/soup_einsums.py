"""The sweep's soup by einsum: the device time and the kernels of the
eager warm-up iteration of ECW's CCSD loop, grouped by the
ops/spinsect.sector_einsum spec whose span launched them.

    python3 tools/soup_einsums.py [--basis 6-311++g(2d,2p)] [--top 10]

Builds the benchmark's C2H2 ECW (f32) with an HF 'mat' target, runs one
untraced lambda solve (its loop captured and released), then a second
under utils/metrics.profile_trace (trace files under --logdir).  The
warm-up iteration of that solve runs eagerly, its sector_einsum calls
each inside a span that the profiler records
('ops.sector_einsum.<spec>.<spins>'); its capture runs nothing on the
device and its replays run no Python, so the kernels under the spans are
the warm-up's.  Prints one JSON line per spec, the --top specs by device
ms: the spin assignments' spans, device ms, the kernels launched, and the
copy kernels among them (their count, ms and names); then the warm-up's
device ms in and out of the spans, and the card's name and power limit.
Needs a CUDA card (on the CPU it runs and finds no device time).
"""

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ecw_cc_torch import ECW  # noqa: E402
from ecw_cc_torch.utils.metrics import profile_trace  # noqa: E402

PREFIX = "ops.sector_einsum."
COPY_WORDS = ("copy", "Memcpy", "CatArrayBatchedCopy")


def kernels_under(evt):
    """[(name, us)] of the device kernels of evt and its descendants."""
    out = [(k.name, k.duration) for k in evt.kernels]
    for c in evt.cpu_children:
        out += kernels_under(c)
    return out


def descendants(evt):
    for c in evt.cpu_children:
        yield c
        yield from descendants(c)


def table(events):
    """({spec: row}, warm-up device us, of which under einsum spans)."""
    warm = [e for e in events if e.name == "loop.warm_up"]
    rows, total_us, spans_us = {}, 0.0, 0.0
    for w in warm:
        total_us += sum(us for _, us in kernels_under(w))
        for e in descendants(w):
            if not e.name.startswith(PREFIX):
                continue
            spec = e.name[len(PREFIX):].rsplit(".", 1)[0]
            ks = kernels_under(e)
            copies = [(n, us) for n, us in ks
                      if any(word in n for word in COPY_WORDS)]
            r = rows.setdefault(spec, {"spec": spec, "spans": 0,
                                       "device_ms": 0.0, "kernels": 0,
                                       "copies": 0, "copy_ms": 0.0,
                                       "copy_kernels": set()})
            r["spans"] += 1
            r["device_ms"] += sum(us for _, us in ks) / 1e3
            r["kernels"] += len(ks)
            r["copies"] += len(copies)
            r["copy_ms"] += sum(us for _, us in copies) / 1e3
            r["copy_kernels"].update(n[:60] for n, _ in copies)
            spans_us += sum(us for _, us in ks)
    return rows, total_us, spans_us


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--basis", default="6-311++g(2d,2p)")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--logdir",
                    default=os.path.join(ROOT, "chiprun_out", "soup_trace"))
    args = ap.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    ecw = ECW("c2h2", args.basis, device=device, dtype=torch.float32)
    ecw.Build_GS_exp("mat", "HF")
    ecw.CCSD_GS([0.2], diis="tl", conv_thres=1e-6, maxiter=80)
    with profile_trace(args.logdir) as prof:
        ecw.CCSD_GS([0.2], diis="tl", conv_thres=1e-6, maxiter=80)
    rows, total_us, spans_us = table(prof.events())
    for r in sorted(rows.values(), key=lambda r: -r["device_ms"])[:args.top]:
        r["copy_kernels"] = sorted(r["copy_kernels"])
        print(json.dumps(r))
    print(json.dumps({"route": ecw.solve_log[0]["route"],
                      "sym": ecw.solve_log[0]["sym"],
                      "specs": len(rows),
                      "spans": sum(r["spans"] for r in rows.values()),
                      "warm_up_device_ms": total_us / 1e3,
                      "under_einsum_spans_ms": spans_us / 1e3}))
    if device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())


if __name__ == "__main__":
    main(sys.argv[1:])
