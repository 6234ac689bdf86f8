"""driver_ms.sweep: per sweep, the host clock around ECW.CCSD_GS less the
sum of its lambda solves' Solver_CCSD.last_solve["ms"] (ECW.solve_log):
the driver's own time (Vexp set-up, the solver's construction, the host
work between lambda).  Both clocks end in a device-to-host copy.  Mean
over the window's sweeps."""


def read(ctx):
    recs = ctx.records("sweep")
    if not recs:
        return None
    return sum(r["wall_ms"] - sum(s["ms"] for s in r["solve_log"])
               for r in recs) / len(recs)
