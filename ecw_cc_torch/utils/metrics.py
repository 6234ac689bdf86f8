"""Observability: iteration metrics.

Replaces the reference's print-based convergence tables (SURVEY.md section 5)
with a structured collector that can also emit JSON lines.

Copy of ecw_cc_tpu/utils/metrics.py (the PyTorch port imports
nothing of the JAX package) without its jax.profiler wrappers
`profile_trace` and `annotate`: on the card, torch.profiler is used
directly.
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

