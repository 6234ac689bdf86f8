"""GS ECW-CCSD lambda sweep on C2H2 against a CCSD(T) 'mat' target, cube
files, checkpoints and the result table (the port's examples/
gs_ccsd_sweep.py; reference test/Test_ECW_GS.py).

Run:  python -m ecw_cc_torch.examples.gs_ccsd_sweep [basis] [out_dir] [--cpu]

The reference's largest configuration is the basis "6-311++g(2d,2p)".
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ecw_cc_torch.examples import parse, save_plot

# lambda array: 0 -> 0.7, 8 points (reference Test_ECW_GS.py:8-12)
LAMBDAS = np.linspace(0, 0.7, 8)


def main(basis="6-31+g**", out_dir="c2h2_results", lambdas=LAMBDAS,
         device="cuda", dtype=torch.float32):
    """Build C2H2 in `basis`, its CCSD(T) density as the target, and sweep
    `lambdas`.  Returns the sweep's numbers: EHF, Eexp, per lambda Ep_lamb
    (ECW.Ep_lamb), Delta, iterations and convergence, the target's log,
    seconds by stage, ms per iteration, the files written under out_dir
    and the plot (None without matplotlib), and the ECW itself."""
    from ecw_cc_torch import ECW

    t0 = time.perf_counter()
    ecw = ECW("c2h2", basis, out_dir=out_dir, device=device, dtype=dtype)
    t1 = time.perf_counter()
    # target = CCSD(T) rdm1 (reference uses 'CCSDt')
    ecw.Build_GS_exp("mat", "CCSD(T)")
    t2 = time.perf_counter()
    ecw.CCSD_GS(lambdas, print_ite_info=True, conv_thres=1e-6, maxiter=80,
                diis="tl", checkpoint_dir=out_dir + "/ckpt")
    t3 = time.perf_counter()
    ecw.print_results()
    plot = save_plot(ecw.plot_results, out_dir + "/sweep.png")
    print(f"results written to {out_dir}/")
    log = ecw.solve_log
    # ECW's layout rule: sectored on the spin-sorted f32 ERIs at nvir >= 48
    # (the flagship basis), packed with spin_sorted=False, dense below
    print("route:", ", ".join(sorted({s["route"] for s in log})))
    iterations = [s["iterations"] for s in log]
    return {
        "EHF": float(ecw.EHF), "Eexp": float(ecw.Eexp_GS),
        "lambdas": [float(x) for x in lambdas],
        "Ep_lamb": [float(x) for x in ecw.Ep_lamb],
        "Delta": [float(x) for x in ecw.Delta_lamb],
        "iterations": iterations,
        "converged": [s["status"] == 1 for s in log],
        "routes": [s["route"] for s in log],
        "target_log": ecw.target_log,
        "seconds": {"ecw": t1 - t0, **ecw.timings, "target": t2 - t1,
                    "sweep": t3 - t2},
        "ms_per_iteration": sum(s["ms"] for s in log) / sum(iterations),
        "files": sorted(os.path.relpath(os.path.join(d, f), out_dir)
                        for d, _, fs in os.walk(out_dir) for f in fs),
        "plot": plot, "ecw": ecw}


if __name__ == "__main__":
    args, device, dtype = parse(
        sys.argv[1:], __doc__.splitlines()[0],
        (("basis", "6-31+g**"), ("out_dir", "c2h2_results")))
    main(args.basis, args.out_dir, device=device, dtype=dtype)
