"""t_pairs_s.target: per target build, the seconds of the (T) pair scans:
energy_t_s + the adjoint's energy_grad_s in ECW.target_log (StageClock
stages; the device is synchronized before each reading).  Mean over the
window's builds."""


def read(ctx):
    recs = ctx.records("target")
    if not recs:
        return None
    return sum(r["target_log"]["energy_t_s"]
               + r["target_log"]["adjoint"]["energy_grad_s"]
               for r in recs) / len(recs)
