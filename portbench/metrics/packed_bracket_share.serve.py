"""``packed_bracket_share.serve``: brackets the pool dispatched packed
with others' (``ServePool.dispatches``: ``packed_brackets``) over packed
and solo ones, over the window, in %."""


def read(ctx):
    d = ctx.get("dispatches")
    if ctx.get("tier") != "serve" or not d:
        return None
    total = d.get("packed_brackets", 0) + d.get("solo_brackets", 0)
    return None if total <= 0 else 100.0 * d["packed_brackets"] / total
