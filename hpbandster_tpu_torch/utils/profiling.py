"""Tracing hooks on ``torch.profiler``.

Ported from ``hpbandster_tpu/utils/profiling.py``, where the same hooks
wrap ``jax.profiler``: :func:`trace` captures a profiler trace around the
device path (``FusedBOHB.run(profile_dir=)``), :func:`annotate` names a
region inside it, and :func:`attach_profiler` traces every wave a batched
executor flushes.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable, Iterator, Optional

logger = logging.getLogger("hpbandster_tpu_torch.profiling")

__all__ = ["trace", "annotate", "attach_profiler"]

#: marker attribute on wrapped flush callables, holding the unwrapped
#: original — the idempotence/detach contract of attach_profiler
_ORIGINAL_ATTR = "_hpb_profiler_original_flush"


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host and, on a card, device
    activity) and write it into ``log_dir`` as a Chrome trace JSON file;
    a no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch

    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)


def annotate(name: str):
    """Named region inside a trace (``torch.profiler.record_function``)."""
    import torch

    return torch.profiler.record_function(name)


def attach_profiler(executor, log_dir: str) -> Callable[[], None]:
    """Wrap a ``BatchedExecutor``'s flush so every device wave is traced.

    Idempotent: calling it again (same or different ``log_dir``) replaces
    the previous wrapper instead of stacking a second trace around the
    first. Returns a ``detach()`` handle that restores the unwrapped
    flush: itself idempotent, and a no-op if someone else re-wrapped
    flush in the meantime (their wrapper is not ours to remove)."""
    original_flush = getattr(executor.flush, _ORIGINAL_ATTR, executor.flush)

    def profiled_flush():
        with trace(log_dir):
            return original_flush()

    setattr(profiled_flush, _ORIGINAL_ATTR, original_flush)
    executor.flush = profiled_flush

    def detach() -> None:
        if getattr(executor, "flush", None) is profiled_flush:
            executor.flush = original_flush

    logger.info("profiler attached; traces -> %s", log_dir)
    return detach
