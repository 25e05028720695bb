"""``decode_us_per_config.co16``: the bulk decode's microseconds a
configuration over the window: the change in the port's
``space.decode_s`` counter over the change in ``space.decode_rows``
(``ConfigurationSpace.from_vectors``). Nothing where the program keeps
no such counters or decoded nothing."""


def read(ctx):
    counters = ctx.get("counters") or {}
    rows = counters.get("space.decode_rows", 0)
    if ctx.get("tier") != "fused" or rows <= 0 or "space.decode_s" not in counters:
        return None
    return 1e6 * counters["space.decode_s"] / rows
