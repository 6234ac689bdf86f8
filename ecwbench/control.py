"""The readings that the limits of limits/<workload>.json are set from.

    python3 ecwbench/control.py --workload W --seeds S1,S2,S3 \
        [--out chiprun_out/control.jsonl]

For each seed, on the card: the reference (f64) and the control, which is
the reference put in the program's place at the precision below the one
the configuration states (float32 with TF32 matmuls, with the program's
own thresholds), both worked out from the seed's geometry; then the
numbers check.py compares, of the control against the reference.  The
control's numbers are the upper readings; the program's, from the
harness's own runs over a dozen seeds, the lower ones.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ecwbench import check, jobs, spec  # noqa: E402
from ecwbench.reference.aoints import load_basis  # noqa: E402
from ecwbench.reference.solve import solve  # noqa: E402


def control_numbers(sp, workload, seed, device="cuda"):
    """The control's numbers against the reference for one seed, and the
    seconds each took."""
    c = sp.cell(workload)
    atoms = jobs.geometry(c.cfg, seed)
    basis = load_basis(sp.path(c.cfg["basis_file"]))
    lams = jobs.lambdas(c.traffic) if c.traffic["job"] == "sweep" else None
    t0 = time.perf_counter()
    ref = solve(atoms, basis, lams, device=device)
    t1 = time.perf_counter()
    ctl = solve(atoms, basis, lams, device=device, precision="tf32")
    t2 = time.perf_counter()
    got = {"jobs": []}
    if lams is None:
        got["jobs"].append({"eexp": ctl.eexp, "target_ao": ctl.target_ao})
    else:
        got.update(eexp=ctl.eexp, target_ao=ctl.target_ao)
        # the control has no solver status: its solves count as converged
        got["jobs"].append({"ep": ctl.ep, "delta": ctl.delta,
                            "rdm1_ao": ctl.rdm1_ao,
                            "status": [1] * len(lams)})
    nums, _ = check.numbers(c.traffic["job"], got, ref)
    return nums, t1 - t0, t2 - t1


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sp = spec.Spec()
    for seed in (int(s) for s in args.seeds.split(",")):
        nums, t_ref, t_ctl = control_numbers(sp, args.workload, seed)
        rec = {"workload": args.workload, "seed": seed, "control": nums,
               "reference_s": t_ref, "control_s": t_ctl}
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
