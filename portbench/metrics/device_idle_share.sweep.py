"""``device_idle_share.sweep``: 1 minus the union of the device's busy
intervals over the traced stretch (one whole sweep), in %."""


def read(ctx):
    if ctx.get("tier") != "fused" or "trace" not in ctx:
        return None
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
