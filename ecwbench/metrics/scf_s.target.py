"""scf_s.target: per target build, the seconds of its host RHF:
target_log["scf_s"] (Gexp.build's 'gexp.scf' span around the SCF's
kernel).  Mean over the window's builds; None where the program has no
such span."""


def read(ctx):
    recs = ctx.records("target")
    if not recs or not all("scf_s" in r["target_log"] for r in recs):
        return None
    return sum(r["target_log"]["scf_s"] for r in recs) / len(recs)
