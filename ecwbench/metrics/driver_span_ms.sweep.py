"""driver_span_ms.sweep: per sweep, its host spans around the solves:
every ms under each solve_log entry's 'driver' (ECW.CCSD_GS's
prepare, record, release and fetch spans, Solver_CCSD.SCF's enter and
exit).
Mean over the window's sweeps; None where the program has no such
spans."""


def read(ctx):
    recs = ctx.records("sweep")
    if not recs or not all("driver" in s for r in recs
                           for s in r["solve_log"]):
        return None
    return sum(sum(sum(s["driver"].values()) for s in r["solve_log"])
               for r in recs) / len(recs)
