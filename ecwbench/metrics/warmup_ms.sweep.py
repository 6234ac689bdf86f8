"""warmup_ms.sweep: per sweep, the eager first iterations of its solver
loops before their capture: Σ warm_up_ms of the loop logs
(device_loop.Loop's 'loop.warm_up' span, its flag read included).  Mean
over the window's sweeps; None where the program has no such span."""


def read(ctx):
    recs = ctx.records("sweep")
    loops = [lp for r in recs for s in r["solve_log"] for lp in s["loops"]]
    if not any("warm_up_ms" in lp for lp in loops):
        return None
    return sum(lp.get("warm_up_ms", 0.0) for lp in loops) / len(recs)
