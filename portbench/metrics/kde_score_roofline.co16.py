"""``kde_score_roofline.co16``: ``kde_score_roofline`` on the mixed
32-dim space, where every launch runs the kernel's 32-wide instance: the
traced sweep's ``kde_score_kernel<32>`` launches, the least time their
work needs (``harness/roofline.py``, rows live as the sweep's own Result
says) over their device time in the trace, in %. Nothing where the trace
does not hold exactly those launches."""

from portbench.harness.roofline import kde_score_least_seconds
from portbench.harness.trace import kernel_seconds


def read(ctx):
    launches = ctx.get("kde_launches")
    if not launches or "trace" not in ctx:
        return None
    n, seconds = kernel_seconds(ctx["trace"], "kde_score_kernel<32>")
    if n != len(launches) or seconds <= 0:
        return None
    return 100.0 * kde_score_least_seconds(launches) / seconds
