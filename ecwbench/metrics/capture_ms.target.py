"""capture_ms.target: per target build, the CUDA-graph captures of every
loop and pair scan in ECW.target_log: each capture_ms + empty_cache_ms.
Mean over the window's builds."""


def read(ctx):
    recs = ctx.records("target")
    if not recs:
        return None
    keys = ("capture_ms", "empty_cache_ms")
    return sum(ctx.sum_keys(r["target_log"], keys)
               for r in recs) / len(recs)
