"""The one general generator of work: a traffic file names a job and its
arguments, and this module sets the program up for it and runs it.

  "sweep":  ECW.CCSD_GS(lambdas, **ccsd_gs) on an ECW whose target
            ECW.Build_GS_exp(**target) built in set-up;
  "target": ECW.Build_GS_exp(**target) on the set-up's ECW.

Jobs run closed loop, one after the other.  The seed moves every nucleus
by a vector drawn uniformly from [-a, a]^3 Angstrom, a the configuration's
`displacement_angstrom`: every seed sends the same molecule, basis and
shapes.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np


def geometry(cfg, seed):
    """The configuration's atoms, each displaced by the seed's vector."""
    rng = np.random.default_rng(seed)
    a = cfg["displacement_angstrom"]
    return [(s, tuple(float(x) for x in np.asarray(c, float)
                      + rng.uniform(-a, a, 3)))
            for s, c in cfg["atoms"]]


def lambdas(traffic):
    spec = traffic["lambdas"]
    return [float(x) for x in np.linspace(spec["start"], spec["stop"],
                                          spec["num"])]


@contextlib.contextmanager
def quiet():
    """The program's prints go nowhere: the run's last stdout line is the
    result."""
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield


def stages(log):
    """The seconds of a target build's stages (its log's top-level *_s
    entries and the adjoint's)."""
    out = {k: v for k, v in log.items() if k.endswith("_s")}
    out.update({"adjoint." + k: v for k, v in log.get("adjoint", {}).items()
                if k.endswith("_s")})
    return out


class Work:
    """The set-up's program state and one job of the traffic."""

    def __init__(self, cfg, traffic, atoms, device="cuda"):
        import torch
        from ecw_cc_torch import ECW, set_config

        self.torch = torch
        self.kind = traffic["job"]
        if self.kind not in ("sweep", "target"):
            raise ValueError(f"unknown job {self.kind!r}")
        self.traffic = traffic
        set_config(**traffic.get("config", {}))
        # seconds of set-up's stages, for the run's stderr
        self.setup_log = {}
        t0 = time.perf_counter()
        with quiet():
            self.ecw = ECW(atoms, cfg["basis"], device=device,
                           dtype=getattr(torch, cfg["dtype"]))
            t1 = time.perf_counter()
            self.setup_log.update(ecw_s=t1 - t0, **self.ecw.timings)
            if self.kind == "sweep":
                self.ecw.Build_GS_exp(**traffic["target"])
                self.setup_log.update(target_s=time.perf_counter() - t1,
                                      target=stages(self.ecw.target_log))
        self.lambdas = lambdas(traffic) if self.kind == "sweep" else None

    def run(self):
        """One job; returns its record: the wall ms and what it produced."""
        ecw, torch = self.ecw, self.torch
        t0 = time.perf_counter()
        with quiet():
            if self.kind == "sweep":
                res = ecw.CCSD_GS(self.lambdas, **self.traffic["ccsd_gs"])
            else:
                ecw.Build_GS_exp(**self.traffic["target"])
        if ecw.device.type == "cuda":
            torch.cuda.synchronize()
        rec = {"kind": self.kind, "wall_ms": (time.perf_counter() - t0) * 1e3}
        if self.kind == "sweep":
            rec.update(solve_log=ecw.solve_log,
                       status=[s["status"] for s in ecw.solve_log],
                       ep=[ecw.EHF - x for x in ecw.Ep_lamb],
                       delta=[float(x) for x in ecw.Delta_lamb],
                       rdm1=np.asarray(res[4], dtype=np.float64))
        else:
            rec.update(target_log=ecw.target_log, eexp=float(ecw.Eexp_GS),
                       target=np.asarray(ecw.exp_data[0][-1][1], np.float64))
        if ecw.device.type == "cuda":
            rec["memory"] = (torch.cuda.memory_allocated(),
                             torch.cuda.max_memory_allocated())
        return rec

    def setup_answers(self):
        """What set-up derived that the check reads: the MO coefficients
        and, for a sweep, the target and its energy."""
        ecw = self.ecw
        out = {"mo_coeff": np.asarray(ecw.mo_coeff)}
        if self.kind == "sweep":
            out.update(eexp=float(ecw.Eexp_GS),
                       target=np.asarray(ecw.exp_data[0][-1][1], np.float64))
        return out
