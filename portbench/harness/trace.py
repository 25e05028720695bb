"""The traced stretch of a run: ``torch.profiler`` over a steady part of
the window, reduced to the device's busy seconds, each kernel's device
time, the top device operations and the longest idle gaps.

Gaps are named by the benchmark's own spans (``portbench.<layer>``,
``torch.profiler.record_function`` around its calls into each layer),
which land in the same trace and on the same clock as the kernels. No
trace is written to disk.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "portbench."


def span(name: str):
    """A benchmark span around a call into one layer (free when no
    profiler runs)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


class Stretch:
    """One profiled stretch on ``device``. ``warm()`` at set-up pays the
    profiler's own first start (CUPTI) outside the window. On the CPU (the
    tests) only host activity is profiled."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._prof = None
        self.t0 = self.t1 = None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        with self._profile():
            torch.zeros(1, device=self.device).add_(1)
            self._sync()

    def start(self) -> None:
        self._sync()
        self._prof = self._profile()
        self._prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        self._prof.stop()

    @property
    def started(self) -> bool:
        return self._prof is not None

    def reduce(self) -> Dict[str, Any]:
        if self._prof is None or self.t1 is None:
            raise RuntimeError("the traced stretch never ran")
        return reduce_events(self._prof.events(), self.t1 - self.t0)


def _is_device(event) -> bool:
    return getattr(getattr(event, "device_type", None), "name", "") == "CUDA"


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def name_gap(mid: float, spans: List[Tuple[float, float, str]]) -> str:
    """The innermost benchmark span open at ``mid`` (the latest started),
    or ``host`` where none is."""
    best: Optional[Tuple[float, str]] = None
    for s, e, name in spans:
        if s <= mid <= e and (best is None or s > best[0]):
            best = (s, name)
    return best[1] if best else "host"


def reduce_intervals(device: List[Tuple[float, float, str]],
                     spans: List[Tuple[float, float, str]],
                     window_s: float) -> Dict[str, Any]:
    """The stretch's numbers from device intervals and benchmark spans
    (microseconds, one clock): busy seconds (their union), seconds per
    kernel name, the top ten device operations and the ten longest idle
    gaps between device work, each named by the span open across it."""
    per_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for s, e, name in device:
        per_name[name][0] += 1
        per_name[name][1] += (e - s) / 1e6
    merged = merge([(s, e) for s, e, _ in device])
    busy_s = sum(e - s for s, e in merged) / 1e6
    gaps = []
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        gaps.append((name_gap((e0 + s1) / 2, spans), (s1 - e0) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "window_s": float(window_s),
        "busy_s": float(busy_s),
        "kernels": {k: {"count": int(v[0]), "seconds": float(v[1])}
                    for k, v in per_name.items()},
        "device_ops": [[k, float(v[1])] for k, v in top],
        "idle_gaps": [[n, float(s)] for n, s in gaps[:10]],
    }


def reduce_events(events, window_s: float) -> Dict[str, Any]:
    device, spans = [], []
    for ev in events:
        tr = ev.time_range
        if ev.name.startswith(SPAN_PREFIX):
            # a span lands twice: on the host, and as the device's copy of
            # the annotation, which is no device work
            if not _is_device(ev):
                spans.append((tr.start, tr.end, ev.name[len(SPAN_PREFIX):]))
        elif _is_device(ev):
            device.append((tr.start, tr.end, ev.name))
    return reduce_intervals(device, spans, window_s)


def kernel_seconds(reduced: Dict[str, Any], fragment: str) -> Tuple[int, float]:
    """Launches and device seconds of the kernels whose name holds
    ``fragment`` (a kernel's name in the trace carries its template)."""
    n, s = 0, 0.0
    for name, v in reduced["kernels"].items():
        if fragment in name:
            n += v["count"]
            s += v["seconds"]
    return n, s


def collect_setup_garbage() -> None:
    """End set-up with one full collection, so that each window starts
    from the same heap and pays for its own garbage, not the warm-up's.
    Nothing is frozen: the window's collections scan the whole heap, as in
    any process that runs the port."""
    import gc

    gc.collect()


class GCWatch:
    """The interpreter's garbage collections while it watches: how many of
    each generation ran and how long they took (``gc.callbacks``)."""

    def __init__(self):
        import gc

        self._gc = gc
        self.count = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self._t = None
        self.cpu_s = time.process_time()

    def _callback(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            gen = info["generation"]
            self.count[gen] += 1
            self.seconds[gen] += time.perf_counter() - self._t
            self._t = None

    def __enter__(self):
        self._gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        self._gc.callbacks.remove(self._callback)
        self.cpu_s = time.process_time() - self.cpu_s

    def line(self) -> str:
        return " ".join(f"gen{g} {n} {s:.4f}s" for g, (n, s) in
                        enumerate(zip(self.count, self.seconds))) + f"; process cpu {self.cpu_s:.3f}s"
