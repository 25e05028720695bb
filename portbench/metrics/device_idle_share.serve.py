"""``device_idle_share.serve``: 1 minus the union of the device's busy
intervals over the traced stretch of the serving window, in %."""


def read(ctx):
    if ctx.get("tier") != "serve" or "trace" not in ctx:
        return None
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
