"""solve_host_ms.sweep: per sweep, the host work of its solves around
their loops: Σ setup_ms + lanes_ms + finish_ms of the solve_log entries
(Solver_CCSD._solve's spans: the set-up where it is rebuilt, the lanes'
state and each leg's DIIS ring and step, the copies and host reads at
the end).  Mean over the window's sweeps; None where the program has no
such spans."""

KEYS = ("setup_ms", "lanes_ms", "finish_ms")


def read(ctx):
    recs = ctx.records("sweep")
    if not recs or not all("lanes_ms" in s for r in recs
                           for s in r["solve_log"]):
        return None
    return sum(sum(s.get(k, 0.0) for s in r["solve_log"] for k in KEYS)
               for r in recs) / len(recs)
