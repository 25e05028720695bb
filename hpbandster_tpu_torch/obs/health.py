"""Fleet health: the ``obs_snapshot`` RPC endpoint + crash forensics.

Ported from ``hpbandster_tpu/obs/health.py`` (a copy; profiles are
``torch.profiler`` captures, ``obs/profile.py``).

Every long-lived process in the fleet (worker, dispatcher) exposes one
introspection RPC, ``obs_snapshot``, returning a JSON-serializable
:meth:`HealthEndpoint.snapshot`: identity (host/pid/...), uptime, the
in-flight job, an atomic metrics snapshot, and the tail of the local
event ring buffer. The dispatcher's heartbeat loop collects these from
workers (falling back to plain ``ping`` for older peers — the endpoint
is additive, never required), feeding the ``dispatcher.workers_alive`` /
per-worker last-seen-age gauges.

:func:`install_crash_dump` is the other half of fleet forensics: an
unhandled exception (main thread via ``sys.excepthook``, any worker
thread via ``threading.excepthook``) writes the same snapshot — plus the
traceback — to a JSON file before the process dies, so a dead run leaves
a record instead of a silence.

This module is deliberately transport-agnostic: it never imports
``parallel/rpc.py`` (which imports ``obs`` — the dependency points one
way). ``register(server)`` only needs a ``server.register(name, fn)``
callable, which :class:`~hpbandster_tpu_torch.parallel.rpc.RPCServer`
satisfies.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from hpbandster_tpu_torch.obs.journal import (
    RingBuffer,
    event_to_record,
    process_identity,
)
from hpbandster_tpu_torch.obs.metrics import MetricsRegistry, get_metrics

__all__ = ["HealthEndpoint", "install_crash_dump"]

logger = logging.getLogger("hpbandster_tpu_torch.obs")


def _ring_tail(ring: Optional[RingBuffer], tail: int) -> List[Dict[str, Any]]:
    if ring is None:
        return []
    items = ring.snapshot()[-max(int(tail), 0):]
    # rings hold Events (bus sink) or plain record dicts (worker ring,
    # dead letters) — normalize to the journal record schema
    return [i if isinstance(i, dict) else event_to_record(i) for i in items]


class HealthEndpoint:
    """One process's introspection surface; register it on an RPC server.

    ``in_flight`` is a zero-arg callable returning a JSON-serializable
    description of what the process is working on right now (a worker's
    current config id, a dispatcher's running/waiting census) — or None.
    """

    def __init__(
        self,
        component: str,
        identity: Optional[Dict[str, Any]] = None,
        ring: Optional[RingBuffer] = None,
        in_flight: Optional[Callable[[], Any]] = None,
        registry: Optional[MetricsRegistry] = None,
        anomaly: Optional[Any] = None,
        slo: Optional[Any] = None,
    ):
        self.component = component
        self.identity = dict(identity) if identity is not None else process_identity()
        self._ring = ring
        self._in_flight = in_flight
        self._registry = registry
        #: optional obs.anomaly.AnomalyDetector whose alert tally rides
        #: the snapshot (anything with a .snapshot() -> dict works)
        self._anomaly = anomaly
        #: optional obs.alerts.AlertManager whose SLO verdict rides the
        #: snapshot (same duck-typed .snapshot() contract as anomaly)
        self._slo = slo
        self._t0_mono = time.monotonic()
        self._t0_wall = time.time()

    def snapshot(self, tail: int = 32) -> Dict[str, Any]:
        """The ``obs_snapshot`` RPC body: identity + uptime + in-flight
        work + atomic metrics cut (histograms include p50/p95) + a
        ``latency`` convenience section + newest ``tail`` ring events."""
        reg = self._registry if self._registry is not None else get_metrics()
        in_flight = None
        if self._in_flight is not None:
            try:
                in_flight = self._in_flight()
            except Exception:
                # introspection must never take the serving process down
                logger.exception("obs_snapshot in_flight callable failed")
        metrics = reg.snapshot()
        # the quantile cut `watch --snapshot` renders: latency visibility
        # with no journal on disk (histogram bounds cap the resolution —
        # the p50/p95 are bucket upper bounds, conservative by design)
        latency = {
            name: {"count": h["count"], "p50": h["p50"], "p95": h["p95"]}
            for name, h in metrics.get("histograms", {}).items()
        }
        out = {
            "component": self.component,
            "identity": self.identity,
            "uptime_s": round(time.monotonic() - self._t0_mono, 3),
            "started_t_wall": self._t0_wall,
            "in_flight": in_flight,
            "metrics": metrics,
            "latency": latency,
            "runtime": self._runtime_section(),
            "ring_tail": _ring_tail(self._ring, tail),
        }
        if self._anomaly is not None:
            try:
                out["alerts"] = self._anomaly.snapshot()
            except Exception:
                logger.exception("obs_snapshot anomaly snapshot failed")
        if self._slo is not None:
            try:
                out["slo"] = self._slo.snapshot()
            except Exception:
                logger.exception("obs_snapshot slo snapshot failed")
        return out

    def _runtime_section(self) -> Dict[str, Any]:
        """The runtime tier of the snapshot: the capture ledger + newest
        device census (obs/runtime.py). Never touches the device."""
        from hpbandster_tpu_torch.obs.runtime import runtime_snapshot

        try:
            return runtime_snapshot()
        except Exception:
            # introspection must never take the serving process down
            logger.exception("obs_snapshot runtime section failed")
            return {"compile": None, "devices": None}

    def metrics_text(self) -> str:
        """The Prometheus text exposition of this process's registry —
        the same atomic cut :meth:`snapshot` serializes as JSON, in the
        format a standard scraper ingests (obs/export.py)."""
        from hpbandster_tpu_torch.obs.export import render_registry

        return render_registry(self._registry)

    # ------------------------------------------------------ deep profiling
    def start_profile(self, log_dir: Optional[str] = None) -> Dict[str, Any]:
        """The ``start_profile`` RPC body: begin a ``torch.profiler`` trace
        capture in THIS process (obs/profile.py) — on demand, no
        construction-time ``profile_dir`` required."""
        from hpbandster_tpu_torch.obs.profile import get_profile_session

        return get_profile_session().start(log_dir=log_dir)

    def stop_profile(self) -> Dict[str, Any]:
        """The ``stop_profile`` RPC body: end the live capture; reports
        the trace dir, duration, and file count."""
        from hpbandster_tpu_torch.obs.profile import get_profile_session

        return get_profile_session().stop()

    def profile_status(self) -> Dict[str, Any]:
        from hpbandster_tpu_torch.obs.profile import get_profile_session

        return get_profile_session().status()

    def register(self, server: Any) -> None:
        """Expose :meth:`snapshot` as the ``obs_snapshot`` RPC method,
        :meth:`metrics_text` as ``metrics_text``, and the on-demand
        profiling trio (``start_profile`` / ``stop_profile`` /
        ``profile_status``) — every fleet process is scrapeable AND
        profileable through its existing health port."""
        server.register("obs_snapshot", self.snapshot)
        server.register("metrics_text", self.metrics_text)
        server.register("start_profile", self.start_profile)
        server.register("stop_profile", self.stop_profile)
        server.register("profile_status", self.profile_status)


def install_crash_dump(
    path: str,
    component: str = "",
    ring: Optional[RingBuffer] = None,
    registry: Optional[MetricsRegistry] = None,
) -> Callable[[], None]:
    """Dump ring buffer + metrics + traceback to ``path`` on an unhandled
    exception, then chain to the previous hooks (output still appears).

    Covers the main thread (``sys.excepthook``) and worker threads
    (``threading.excepthook``). Returns an idempotent ``uninstall()``
    restoring the previous hooks.
    """
    prev_sys = sys.excepthook
    prev_threading = threading.excepthook
    state = {"installed": True}

    def _dump(exc_type: type, exc: BaseException, tb: Any,
              thread_name: Optional[str] = None) -> None:
        try:
            reg = registry if registry is not None else get_metrics()
            dump = {
                "t_wall": time.time(),
                "component": component,
                "identity": process_identity(),
                "thread": thread_name,
                "exception": {
                    "type": getattr(exc_type, "__name__", str(exc_type)),
                    "message": str(exc),
                    "traceback": "".join(
                        traceback.format_exception(exc_type, exc, tb)
                    ),
                },
                "metrics": reg.snapshot(),
                "ring_tail": _ring_tail(ring, 256),
            }
            directory = os.path.dirname(os.path.abspath(path))
            os.makedirs(directory, exist_ok=True)
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(dump, fh, indent=1, default=str)
        except Exception:
            # forensics must never mask the crash it documents
            logger.exception("crash dump to %s failed", path)

    def _sys_hook(exc_type, exc, tb):
        _dump(exc_type, exc, tb)
        prev_sys(exc_type, exc, tb)

    def _threading_hook(args):
        _dump(
            args.exc_type, args.exc_value, args.exc_traceback,
            thread_name=getattr(args.thread, "name", None),
        )
        prev_threading(args)

    sys.excepthook = _sys_hook
    threading.excepthook = _threading_hook

    def uninstall() -> None:
        if state["installed"]:
            state["installed"] = False
            sys.excepthook = prev_sys
            threading.excepthook = prev_threading

    return uninstall
