"""``queue_wait_p95_ms.serve``: the 95th percentile of the pool's queue
wait over every admission of the window, from the change in the
``serve.queue_wait_s`` histogram's counts, interpolated linearly inside
its bucket; in ms. The serving driver registers the histogram with 0.1 ms
buckets up to 1 s (``serve.WAIT_BUCKETS``) and hands nothing where another
caller registered it first with coarser ones. Nothing where the
percentile falls in the open last bucket."""


def read(ctx):
    buckets = ctx.get("queue_wait_buckets")
    if ctx.get("tier") != "serve" or not buckets:
        return None
    edges = sorted((float(k), v) for k, v in buckets.items() if k != "+inf")
    total = sum(buckets.values())
    if total <= 0:
        return None
    target, cum, lo = 0.95 * total, 0.0, 0.0
    for hi, n in edges:
        if n and cum + n >= target:
            return 1000.0 * (lo + (hi - lo) * (target - cum) / n)
        cum, lo = cum + n, hi
    return None
