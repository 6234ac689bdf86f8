"""ladder_roofline.sweep: the ladder products' least time on the card
over the device time of the ladder kernels, in the traced sweeps.  The
work is what the sweep needs, whatever kernel does it: the products of
kernels/ladder.py per iteration, times the traced sweeps' iterations,
each bounded by max(operations / peak, bytes / bandwidth).  The time is
every kernel a ladder product launches, split pass included.  None where
no ladder kernel ran or the route is not the sectored `sym` one whose
products kernels/ladder.py counts."""

import re


def read(ctx):
    fam = ctx.families["ladder"]
    recs = ctx.records("sweep", traced=True)
    solves = [s for r in recs for s in r["solve_log"]]
    if not solves or any(s["route"] != "sectored" or not s["sym"]
                         for s in solves):
        return None
    pat = re.compile(fam.PATTERN)
    us = sum(e - s for name, s, e in ctx.dev if pat.search(name))
    if us <= 0:
        return None
    iters = sum(s["iterations"] for s in solves)
    bound = iters * sum(fam.bound_s(*p, ctx.cfg["dtype"])
                        for p in fam.products(ctx.cfg))
    return 100.0 * bound * 1e6 / us
