"""soup_dev_ms.sweep: device milliseconds per CCSD iteration of every
device operation that is not a ladder kernel (the o^3 v^3 soup, DIIS,
copies), over the traced sweeps: the profiler's device records, divided by
the traced sweeps' iterations."""

import re


def read(ctx):
    recs = ctx.records("sweep", traced=True)
    iters = sum(s["iterations"] for r in recs for s in r["solve_log"])
    if not iters or not ctx.dev:
        return None
    pat = re.compile(ctx.families["ladder"].PATTERN)
    us = sum(e - s for name, s, e in ctx.dev if not pat.search(name))
    return us / 1e3 / iters
