"""idle_pct.target: the share of the traced window of whole target builds in
which no operation runs on the card: the union of the profiler's device
records against the window."""


def read(ctx):
    if not ctx.records("target", traced=True) or not ctx.dev:
        return None
    from ecwbench.trace import union_us

    busy = union_us([(s, e) for _, s, e in ctx.dev]) / 1e6
    return 100.0 * (ctx.window_s - busy) / ctx.window_s
