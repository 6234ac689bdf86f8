"""Observability: iteration metrics and stage seconds.

Replaces the reference's print-based convergence tables (SURVEY.md section 5)
with a structured collector that can also emit JSON lines.

Copy of ecw_cc_tpu/utils/metrics.py (the PyTorch port imports
nothing of the JAX package) without its jax.profiler wrappers
`profile_trace` and `annotate`: on the card, torch.profiler is used
directly.  `StageClock` is the port's own.
"""

from __future__ import annotations

import json
import time


class IterationMetrics:
    """Collects per-iteration scalars for one solve; renders a table or JSONL."""

    def __init__(self, solver="", L=None):
        self.solver = solver
        self.L = L
        self.rows = []
        self._t0 = time.perf_counter()

    def record(self, ite, **scalars):
        self.rows.append({"ite": int(ite),
                          "t_wall_s": round(time.perf_counter() - self._t0, 6),
                          **{k: float(v) for k, v in scalars.items()}})

    def table(self, tablefmt="rst"):
        try:
            from tabulate import tabulate
        except ImportError:
            return "\n".join(json.dumps(r) for r in self.rows)
        if not self.rows:
            return ""
        headers = list(self.rows[0])
        return tabulate([[r.get(h) for h in headers] for r in self.rows],
                        headers, tablefmt=tablefmt)

    def jsonl(self):
        head = {"solver": self.solver, "L": self.L}
        return "\n".join(json.dumps({**head, **r}) for r in self.rows)

    def write(self, path):
        with open(path, "a") as f:
            f.write(self.jsonl() + "\n")


class StageClock:
    """Host-clock seconds of the stages of a computation on `device`,
    written into the dict `log`: done(name) stores the seconds since the
    last reading (the device is synchronized before each).  With log=None
    it does nothing, and costs no synchronization."""

    def __init__(self, device, log):
        self.device, self.log = device, log
        self.t0 = self._now()

    def _now(self):
        if self.log is None:
            return 0.0
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def sub(self, name):
        """The dict log[name] for a callee's own log (None without a log)."""
        return None if self.log is None else self.log.setdefault(name, {})

    def done(self, name):
        if self.log is not None:
            t1 = self._now()
            self.log[name] = t1 - self.t0
            self.t0 = t1
