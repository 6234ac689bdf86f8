"""iters.sweep: CCSD iterations per sweep, the sum of its lambda solves'
last_solve["iterations"].  A count; mean over the window's sweeps."""


def read(ctx):
    recs = ctx.records("sweep")
    if not recs:
        return None
    return sum(sum(s["iterations"] for s in r["solve_log"])
               for r in recs) / len(recs)
