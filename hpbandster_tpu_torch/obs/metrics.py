"""Thread-safe metrics registry: counters, gauges, fixed-bucket histograms.

Ported from ``hpbandster_tpu/obs/metrics.py`` (a copy).

Stdlib-only and hot-path-cheap by design: an increment is one lock acquire + one integer add, and the
whole registry shares a single lock so :meth:`MetricsRegistry.snapshot`
is ATOMIC — the returned dict is a consistent cut across every
instrument, which is what makes "snapshot equals the sum of what the
threads did" a testable property rather than a race.

Instruments are created through the registry (``counter(name)`` /
``gauge(name)`` / ``histogram(name, buckets=...)``); asking for an
existing name returns the existing instrument, asking for it as a
different kind raises. The process-wide default registry is
:func:`get_metrics`; code under test can build private registries.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_metrics",
    "DEFAULT_BUCKETS",
]

#: default histogram bucket upper bounds (seconds-flavored: micro-RPCs to
#: multi-minute fused compiles), +inf implicit as the last bucket
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0, 300.0
)

#: process-wide kill switch, toggled via hpbandster_tpu_torch.obs.set_enabled();
#: disabled instruments drop updates at one boolean check
_ENABLED = True


def _set_enabled(flag: bool) -> None:
    global _ENABLED
    _ENABLED = bool(flag)


class Counter:
    """Monotonically increasing count (events seen, failures, retries)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock  # the owning registry's lock: snapshots stay atomic
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """A value that goes up and down (queue depth, pool size)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram (bucket upper bounds + implicit +inf).

    ``observe(v)`` is O(log n_buckets) (bisect) under the registry lock.
    ``quantile(q)`` returns the upper bound of the bucket holding the
    q-quantile observation — a conservative estimate whose error is
    bounded by the bucket width, the classic fixed-bucket trade."""

    __slots__ = ("name", "_lock", "bounds", "_counts", "_sum", "_count", "_min", "_max")

    def __init__(
        self, name: str, lock: threading.Lock,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.name = name
        self._lock = lock
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last slot = (+inf overflow)
        self._sum = 0.0
        self._count = 0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, v: float) -> None:
        if not _ENABLED:
            return
        v = float(v)
        with self._lock:
            self._counts[bisect.bisect_left(self.bounds, v)] += 1
            self._sum += v
            self._count += 1
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)

    def quantile(self, q: float) -> Optional[float]:
        """Upper bucket bound covering the q-quantile; None when empty,
        the observed max for the overflow bucket."""
        with self._lock:
            return self._quantile_locked(q)

    def _quantile_locked(self, q: float) -> Optional[float]:
        # both callers (quantile(), the registry snapshot) hold self._lock
        if self._count == 0:
            return None
        rank = max(q, 0.0) * self._count
        acc = 0
        for i, c in enumerate(self._counts):
            acc += c
            if acc >= rank and c:
                return self.bounds[i] if i < len(self.bounds) else self._max
        return self._max

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


class MetricsRegistry:
    """Name -> instrument, all sharing ONE lock for atomic snapshots."""

    def __init__(self):
        # re-entrant: the garbage-collection hook (obs/events.py) observes
        # from inside whatever allocation started a collection, which may
        # be this thread's, under this lock
        self._lock = threading.RLock()
        self._instruments: Dict[str, Any] = {}

    def _get(self, name: str, kind: type, *args: Any) -> Any:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = kind(name, self._lock, *args)
                self._instruments[name] = inst
            elif not isinstance(inst, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {kind.__name__}"
                )
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(
        self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get(name, Histogram, buckets)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """One consistent cut across every instrument (single lock hold)."""
        out: Dict[str, Dict[str, Any]] = {
            "counters": {}, "gauges": {}, "histograms": {}
        }
        with self._lock:
            # a copy: a collection's hook may register its histogram while
            # this loop allocates
            for name, inst in sorted(dict(self._instruments).items()):
                if isinstance(inst, Counter):
                    out["counters"][name] = inst._value
                elif isinstance(inst, Gauge):
                    out["gauges"][name] = inst._value
                else:
                    out["histograms"][name] = {
                        "count": inst._count,
                        "sum": inst._sum,
                        "min": inst._min,
                        "max": inst._max,
                        "buckets": dict(zip(
                            [str(b) for b in inst.bounds] + ["+inf"],
                            list(inst._counts),
                        )),
                        "p50": inst._quantile_locked(0.50),
                        "p95": inst._quantile_locked(0.95),
                    }
        return out

    def remove(self, name: str) -> bool:
        """Drop one instrument (e.g. a per-worker gauge when the worker
        leaves the pool — without this, elastic churn leaks stale frozen
        metrics without bound). Returns whether it existed."""
        with self._lock:
            return self._instruments.pop(name, None) is not None

    def reset(self) -> None:
        """Drop every instrument (test isolation)."""
        with self._lock:
            self._instruments.clear()


_DEFAULT_REGISTRY = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    """The process-wide default registry."""
    return _DEFAULT_REGISTRY
