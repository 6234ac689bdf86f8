"""Headless experiment runner: `python -m ecw_cc_torch spec.json` (port of
ecw_cc_tpu/__main__.py).

One JSON spec per experiment, so that sweeps run unattended with the
results table on stdout.

Spec format (all keys but molecule/basis optional):

{
  "molecule": "h2o",            // catalog name or raw geometry string
  "basis": "6-31g",
  "out_dir": "results",         // cube files / plots / output.txt
  "dtype": "float32",           // precision of ERIs, targets and solves
  "device": "cuda",             // "cuda" (the default) or "cpu"
  "config": {"iter_precision": "hybrid",     // config.set_config fields
             "hybrid_fast": "bf16"},
  "target": {"prop": "mat", "posthf": "HF",  // Build_GS_exp args
             "field": [0.05, 0.01, 0.0]},
  "es_targets": {"mom": [1, 0]} |
                {"eom": 2, "eom_prop": "trdip"} |   // EOM-EE-CCSD targets
                {"input": [[["trdip", [0.54, 0.0, 0.0]]]]},
  "run": {
    "solver": "CCSD_GS",        // CCS_GS | CCSD_GS | CCS_ES
    "Larray": [0.0, 0.7, 8],    // np.linspace(start, stop, n); or a list
    "refine": true,             // CCSD_GS: an f64 polish after each solve
    "mode": "parallel",         // CCSD_GS: every lambda in one batched
                                // solve (cold starts; default "sweep")
    ...                         // remaining keys passed to the solver
  }
}

"eom_prop" is 'trmat' (the default), 'trdip' or 'mat' (ECW.Build_ES_exp_EOM).
"""

from __future__ import annotations

import json
import sys

import numpy as np


def _larray(spec):
    arr = spec.get("Larray", [0.5, 0.5, 1])
    if len(arr) == 3 and isinstance(arr[2], int) and arr[2] > 0:
        return np.linspace(arr[0], arr[1], arr[2])
    return np.asarray(arr, dtype=float)


def run_spec(spec):
    """Execute one experiment spec; returns the solver results."""
    from ecw_cc_torch import ECW, set_config

    if spec.get("config"):
        set_config(**spec["config"])
    run = dict(spec.get("run", {"solver": "CCSD_GS"}))
    solver = run.pop("solver", "CCSD_GS")
    if solver not in ("CCS_GS", "CCSD_GS", "CCS_ES"):
        raise ValueError(f"unknown solver {solver!r} "
                         "(use CCS_GS, CCSD_GS or CCS_ES)")
    es = spec.get("es_targets")
    if es and not ("mom" in es or "eom" in es or "input" in es):
        raise ValueError(f"unknown es_targets spec: {es}")

    ecw = ECW(spec["molecule"], spec["basis"], out_dir=spec.get("out_dir"),
              device=spec.get("device", "cuda"), dtype=spec.get("dtype"))
    ecw.Build_GS_exp(**spec.get("target", {"prop": "mat", "posthf": "HF"}))
    if es:
        if "mom" in es:
            ecw.Build_ES_exp_MOM(tuple(es["mom"]))
        elif "eom" in es:
            ecw.Build_ES_exp_EOM(int(es["eom"]),
                                 prop=es.get("eom_prop", "trmat"))
        else:
            ecw.Build_ES_exp_input(es["input"])

    if solver == "CCS_ES":
        L = run.pop("L", run.pop("Larray", [0.1])[0])
        results = ecw.CCS_ES(L, **run)
        ecw.print_results_ES()
        return results
    L = _larray(run)
    run.pop("Larray", None)
    results = getattr(ecw, solver)(L, **run)
    ecw.print_results()
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__)
        print("usage: python -m ecw_cc_torch spec.json", file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        spec = json.load(f)
    run_spec(spec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
