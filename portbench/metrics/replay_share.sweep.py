"""``replay_share.sweep``: the share of the window the host spends
replaying finished chunks into the ``Result`` (``FusedBOHB._replay_bracket``,
timed by the benchmark's span around each call), in %."""


def read(ctx):
    if ctx.get("tier") != "fused" or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["replay_s"] / ctx["window_s"]
