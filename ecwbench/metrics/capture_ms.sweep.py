"""capture_ms.sweep: per sweep, the CUDA-graph captures of its solver
loops: every capture_ms + empty_cache_ms in last_solve["loops"]
(device_loop._capture's host clock; empty_cache synchronizes).  Mean over
the window's sweeps."""


def read(ctx):
    recs = ctx.records("sweep")
    if not recs:
        return None
    keys = ("capture_ms", "empty_cache_ms")
    return sum(ctx.sum_keys([s["loops"] for s in r["solve_log"]], keys)
               for r in recs) / len(recs)
