"""The comparison that decides `correct`: what the window's jobs produced,
and what set-up derived for them, against the plain reference
(ecwbench/reference) worked out again from the seed's geometry.

Every number is a widest gap over the window's jobs; a cell compares
those that limits/<workload>.json gives a limit (PERF.md gives the
readings each was set from):

  eexp_gap    |E_HF + E_CCSD + E_(T)| of the target (Ha), which holds the
              SCF's energy too
  target_gap  max |gamma| of the target's spin-summed density
  ep_gap      max over lambda of |Ep| (Ha), every sweep
  delta_gap   max over lambda of |Delta|, every sweep
  rdm1_gap    max |gamma| of the last lambda's spin-summed rdm1
  unconverged the sweeps' lambda solves that stopped unconverged

Densities are taken to the AO basis, where they do not depend on the
signs or the order the two SCFs give their orbitals, and compared in the
reference's orthonormal MO basis, C^T S D S C: the AO elements themselves
are ill-conditioned (the diffuse functions make S nearly singular, and an
AO element of a density can be in the hundreds).
"""

from __future__ import annotations

import numpy as np
import torch

from ecwbench.reference.solve import ao_r


def to_ao(gamma_mo, C):
    """A program's spin-orbital MO rdm1 as the spin-summed AO density."""
    return ao_r(torch.as_tensor(gamma_mo, dtype=torch.float64),
                torch.as_tensor(C, dtype=torch.float64)).numpy()


def answers(kind, setup, records):
    """The program's answers as numbers() reads them: set-up's, and per
    job its own, densities in the AO basis."""
    C = setup["mo_coeff"]
    got = {"jobs": []}
    if kind == "sweep":
        got.update(eexp=setup["eexp"], target_ao=to_ao(setup["target"], C))
        for r in records:
            got["jobs"].append({"ep": r["ep"], "delta": r["delta"],
                                "rdm1_ao": to_ao(r["rdm1"], C),
                                "status": r["status"]})
    else:
        for r in records:
            got["jobs"].append({"eexp": r["eexp"],
                                "target_ao": to_ao(r["target"], C)})
    return got


def numbers(kind, got, ref):
    """{name: widest gap} of the cell's kind, and the per-job gaps
    [{name: gap}] (the jobs' own answers only)."""
    host = lambda x: np.asarray(x.double().cpu() if hasattr(x, "cpu")
                                else x, dtype=np.float64)
    gap = lambda a, b: float(np.max(np.abs(host(a) - host(b))))
    CS = host(ref.S) @ host(ref.C)
    mo = lambda d: CS.T @ host(d) @ CS
    dgap = lambda a, b: gap(mo(a), mo(b))
    out = {}
    per_job = []
    if kind == "sweep":
        out["eexp_gap"] = abs(got["eexp"] - ref.eexp)
        out["target_gap"] = dgap(got["target_ao"], ref.target_ao)
        for j in got["jobs"]:
            per_job.append({"ep_gap": gap(j["ep"], ref.ep),
                            "delta_gap": gap(j["delta"], ref.delta),
                            "rdm1_gap": dgap(j["rdm1_ao"], ref.rdm1_ao),
                            "unconverged": sum(st != 1
                                               for st in j["status"])})
    else:
        for j in got["jobs"]:
            per_job.append({"eexp_gap": abs(j["eexp"] - ref.eexp),
                            "target_gap": dgap(j["target_ao"],
                                               ref.target_ao)})
    # a NaN gap is an infinite one: it must fail, and max() would drop it
    nan_inf = lambda v: float("inf") if v != v else v
    out = {k: nan_inf(v) for k, v in out.items()}
    per_job = [{k: nan_inf(v) for k, v in g.items()} for g in per_job]
    for gaps in per_job:
        for k, v in gaps.items():
            out[k] = max(out.get(k, 0), v)
    return out, per_job


def judge(nums, per_job, limits):
    """(correct, failed jobs, [(name, number, limit)]): the numbers that
    the limits name are compared, and correct when each is within its
    limit; a job failed when one of its own numbers, or one of set-up's,
    is not.  Without limits every number is shown and nothing is
    correct."""
    if not limits:
        return False, len(per_job), [(k, v, None) for k, v in nums.items()]
    within = lambda k, v: v <= limits[k]
    # a limit on a number the cell does not make fails, as a NaN would
    rows = [(k, nums.get(k, float("inf")), limits[k]) for k in limits]
    ok = all(within(k, v) for k, v, _ in rows)
    job_keys = {k for g in per_job for k in g}
    setup_ok = all(within(k, v) for k, v, _ in rows if k not in job_keys)
    failed = sum(not (setup_ok and all(within(k, v) for k, v in g.items()
                                       if k in limits))
                 for g in per_job)
    return ok, failed, rows
