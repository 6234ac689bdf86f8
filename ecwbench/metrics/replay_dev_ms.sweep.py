"""replay_dev_ms.sweep: per sweep, the device time of its replayed loop
iterations: Σ replay_dev_ms of the loop logs (device_loop.Loop's pair of
CUDA events around each graph replay, read after the iteration's flag
read), from untraced sweeps, which the profiler does not stretch.  Mean
over the window's sweeps; None where the program has no such counter."""


def read(ctx):
    recs = ctx.records("sweep")
    loops = [lp for r in recs for s in r["solve_log"] for lp in s["loops"]]
    if not any("replay_dev_ms" in lp for lp in loops):
        return None
    return sum(lp.get("replay_dev_ms", 0.0) for lp in loops) / len(recs)
