"""``host_syncs_per_bracket.sweep``: the ``sweep.host_syncs`` gauge each
sweep publishes (buffers moved across the host link), over its brackets,
averaged over the window's sweeps."""


def read(ctx):
    rows = [s for s in ctx.get("sweeps", ()) if s.get("host_syncs") is not None]
    if ctx.get("tier") != "fused" or not rows:
        return None
    return sum(s["host_syncs"] / s["brackets"] for s in rows) / len(rows)
