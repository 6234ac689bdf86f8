"""graph_nodes.sweep: kernel nodes per replayed iteration of the sweeps'
loops, the launches one replay makes: Σ nodes × replays over Σ replays
of the loop logs (device_loop counts a captured graph's kernel nodes
once, cuGraphGetNodes).  Over the window's sweeps; None where the
program has no such count or nothing replayed."""


def read(ctx):
    loops = [lp for r in ctx.records("sweep") for s in r["solve_log"]
             for lp in s["loops"] if "nodes" in lp and lp.get("replays")]
    replays = sum(lp["replays"] for lp in loops)
    if not replays:
        return None
    return sum(lp["nodes"] * lp["replays"] for lp in loops) / replays
