"""Structured event bus + monotonic spans — the tracing substrate.

Ported from ``hpbandster_tpu/obs/events.py`` (a copy, with the span
backend moved from ``jax.profiler`` to ``torch.profiler``).

Design constraints (the acceptance bar in docs/observability.md):

* **no-sink cost ~ zero**: ``emit()`` with no subscriber is one tuple
  read + one boolean check and returns before an :class:`Event` is even
  constructed — the instrumented hot paths (master submit loop, batched
  waves) pay nothing when nobody is listening;
* **thread-safe**: the sink list is a copy-on-write tuple, so emitters
  read it with one atomic load while subscribe/unsubscribe swap whole
  tuples under the bus lock; with a sink attached, one emit is stamped and
  delivered under the bus's delivery lock, so every sink sees one order;
* **monotonic durations**: spans measure with ``time.monotonic()`` —
  immune to wall-clock jumps — and carry ``time.time()`` alongside only
  for human-readable journal ordering (the same wall/mono split
  ``core.job.Job`` records).

After :func:`use_profiler_annotations` every span additionally opens a
``torch.profiler.record_function`` range, so the named host region shows
up in the profiler's traces beside the device kernels. Never emit events
from inside a captured CUDA graph or a resident round: a host emit there
would run once at capture and never again on replay.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

from hpbandster_tpu_torch.obs.trace import current_tenant, current_trace

__all__ = [
    "Event",
    "EventBus",
    "get_bus",
    "emit",
    "make_event",
    "span",
    "use_profiler_annotations",
    "EVENT_TYPES",
    "JOB_SUBMITTED",
    "JOB_STARTED",
    "JOB_FINISHED",
    "JOB_FAILED",
    "WORKER_DISCOVERED",
    "WORKER_DROPPED",
    "BRACKET_PROMOTION",
    "KDE_REFIT",
    "RPC_RETRY",
    "RESULT_DELIVERED",
    "CHECKPOINT_WRITTEN",
    "UNKNOWN_RESULT",
    "CONFIG_SAMPLED",
    "PROMOTION_DECISION",
    "ALERT",
    "XLA_COMPILE",
    "FLEET_SAMPLE",
    "JOB_REQUEUED",
    "RESULT_REPLAYED",
    "DUPLICATE_RESULT",
    "WORKER_QUARANTINED",
    "CHAOS_FAULT",
    "SWEEP_INCUMBENT",
    "DEVICE_TELEMETRY",
    "LANE_ASSIGNED",
    "LANE_RELEASED",
    "RPC_CLIENT_CALL",
    "SLO_ALERT",
]

logger = logging.getLogger("hpbandster_tpu_torch.obs")

# ------------------------------------------------------------- typed events
JOB_SUBMITTED = "job_submitted"
JOB_STARTED = "job_started"
JOB_FINISHED = "job_finished"
JOB_FAILED = "job_failed"
WORKER_DISCOVERED = "worker_discovered"
WORKER_DROPPED = "worker_dropped"
BRACKET_PROMOTION = "bracket_promotion"
KDE_REFIT = "kde_refit"
RPC_RETRY = "rpc_retry"
RESULT_DELIVERED = "result_delivered"
CHECKPOINT_WRITTEN = "checkpoint_written"
UNKNOWN_RESULT = "unknown_result"
#: optimizer decision audit records (obs/audit.py): why a config was
#: sampled, and what a rung promotion decided — the journal's view of the
#: ALGORITHM, not the infrastructure
CONFIG_SAMPLED = "config_sampled"
PROMOTION_DECISION = "promotion_decision"
#: streaming anomaly detector verdicts (obs/anomaly.py)
ALERT = "alert"
#: XLA runtime telemetry (obs/runtime.py): one record per fresh
#: compilation a ``tracked_jit`` boundary observed — fn name, abstract
#: shape signature, compile seconds, per-function recompile count
XLA_COMPILE = "xla_compile"
#: one fleet-collector poll round (obs/collector.py): derived fleet
#: gauges — endpoint census, device balance, churn and trend rates
FLEET_SAMPLE = "fleet_sample"
#: recovery vocabulary (core/recovery.py, docs/fault_tolerance.md): a
#: dispatcher re-queued an orphaned job after its worker died ...
JOB_REQUEUED = "job_requeued"
#: ... a previously-stranded result (WAL record or dead letter) joined
#: back into a live run exactly once ...
RESULT_REPLAYED = "result_replayed"
#: ... a second delivery of an already-ingested result was recognized by
#: its idempotency key and dropped (the exactly-once gate) ...
DUPLICATE_RESULT = "duplicate_result"
#: ... and a flapping worker was quarantined: dropped AND banned from
#: rediscovery until the quarantine expires
WORKER_QUARANTINED = "worker_quarantined"
#: one injected fault from the chaos harness (parallel/chaos.py):
#: kind in {kill, delay, drop, duplicate}
CHAOS_FAULT = "chaos_fault"
#: the resident (incumbent-only) sweep's single device->host payload,
#: journaled: winning vector/loss/bracket plus each bracket's best final
#: loss — the ONLY decision record a sweep whose per-rung decisions
#: never left the device produces (obs/audit.py emit_sweep_incumbent;
#: `obs replay` re-scores it)
SWEEP_INCUMBENT = "sweep_incumbent"
#: one sweep's decoded device-metrics record (obs/device_metrics.py):
#: per-rung log-binned loss histograms, crash/evaluation/promotion
#: counts, KDE-refit tallies and the per-bracket incumbent trail — all
#: accumulated IN-TRACE (ops/sweep.py DeviceMetrics) and decoded on the
#: sweep's final d2h, so fused/resident sweeps feed the obs pipeline
#: without surfacing per-job events
DEVICE_TELEMETRY = "device_telemetry"
#: continuous-batching lane lifecycle (serve/continuous.py): a mesh lane
#: of a resident bucket-family program changed owner — ``lane_assigned``
#: when a lane takes a NEW owner at a chunk boundary (carries
#: ``lane``/``family``/``tenant``; warm re-boardings are silent —
#: ownership is sticky, so the journal records changes, not every
#: chunk), and ``lane_released`` when the owner departs and the lane
#: returns to the free pool
LANE_ASSIGNED = "lane_assigned"
LANE_RELEASED = "lane_released"
#: one client-side RPC round trip (parallel/rpc.py RPCProxy.call): a
#: span-shaped record (``duration_s`` + ``method``) the flight recorder
#: (obs/timeline.py) renders as an RPC-phase hop slice — emitted only
#: when a sink listens, so the no-recorder RPC path pays one
#: ``bus.active`` read and nothing else
RPC_CLIENT_CALL = "rpc_client_call"
#: one SLO alert lifecycle transition (obs/alerts.py AlertManager):
#: pending -> firing -> resolved, each journaled with the burn rates and
#: budget remaining that justified it — timestamps derive from the
#: records that drove the evaluator, so an offline replay of the same
#: journal reproduces the transitions byte-identically
SLO_ALERT = "slo_alert"

#: the core vocabulary (docs/observability.md "Event schema"). emit() also
#: accepts names outside this set — subsystems may add their own (span
#: names, ``bracket_created``, ``sweep_chunk``) without a registry edit.
EVENT_TYPES = frozenset({
    JOB_SUBMITTED, JOB_STARTED, JOB_FINISHED, JOB_FAILED,
    WORKER_DISCOVERED, WORKER_DROPPED, BRACKET_PROMOTION, KDE_REFIT,
    RPC_RETRY, RESULT_DELIVERED, CHECKPOINT_WRITTEN, UNKNOWN_RESULT,
    CONFIG_SAMPLED, PROMOTION_DECISION, ALERT, XLA_COMPILE, FLEET_SAMPLE,
    JOB_REQUEUED, RESULT_REPLAYED, DUPLICATE_RESULT, WORKER_QUARANTINED,
    CHAOS_FAULT, SWEEP_INCUMBENT, DEVICE_TELEMETRY, LANE_ASSIGNED,
    LANE_RELEASED, RPC_CLIENT_CALL, SLO_ALERT,
})

#: process-wide kill switch (hpbandster_tpu_torch.obs.set_enabled)
_ENABLED = True


def _set_enabled(flag: bool) -> None:
    global _ENABLED
    _ENABLED = bool(flag)


@dataclasses.dataclass(frozen=True)
class Event:
    """One structured record: name + wall/monotonic stamps + fields."""

    name: str
    t_wall: float
    t_mono: float
    fields: Dict[str, Any]


Sink = Callable[[Event], None]


def make_event(name: str, fields: Dict[str, Any]) -> Event:
    """Construct one stamped :class:`Event`: wall + monotonic clocks, the
    current trace's ``trace_id`` and the current tenant's ``tenant_id``
    (see :mod:`~hpbandster_tpu_torch.obs.trace`) folded into the fields. The one
    place trace/tenant stamping happens — call sites never pass
    ``trace_id``/``tenant_id`` by hand (``obs-reserved-fields`` rule).
    With no tenant context the field is absent entirely, so single-tenant
    journals stay byte-compatible (readers default it to ``"default"``).
    """
    tc = current_trace()
    if tc is not None and "trace_id" not in fields:
        fields = dict(fields, trace_id=tc.trace_id)
    tenant = current_tenant()
    if tenant is not None and "tenant_id" not in fields:
        fields = dict(fields, tenant_id=tenant)
    return Event(name, time.time(), time.monotonic(), fields)


class EventBus:
    """Fan one emit out to every subscribed sink; sinks must not raise
    (if one does anyway, the error is logged and the other sinks still
    receive the event — telemetry must never kill the run).

    Unlike the reference's bus, one emit is stamped and delivered to all
    sinks under one re-entrant lock, so every sink sees the events of all
    threads in the same order, the order of their stamps: a journal and a
    live detector on one bus agree, and the detector's verdicts equal an
    offline replay of the journal (a sink may emit from inside its call)."""

    def __init__(self):
        self._lock = threading.Lock()
        # copy-on-write: emit() reads the tuple with one atomic load; the
        # lock only serializes subscribe/unsubscribe swaps
        self._sinks: Tuple[Sink, ...] = ()
        self._deliver = threading.RLock()

    @property
    def active(self) -> bool:
        """True when an emit would actually reach a sink."""
        return _ENABLED and bool(self._sinks)  # graftlint: disable=lock-coverage — copy-on-write tuple: an unlocked read sees a complete old/new tuple

    def subscribe(self, sink: Sink) -> Callable[[], None]:
        """Attach ``sink``; returns a detach callable (idempotent)."""
        with self._lock:
            self._sinks = self._sinks + (sink,)

        def detach() -> None:
            with self._lock:
                self._sinks = tuple(s for s in self._sinks if s is not sink)

        return detach

    def emit(self, name: str, **fields: Any) -> Optional[Event]:
        """Deliver one event; returns it, or None when nobody listens.
        The Event (and its trace stamp) is only constructed when a sink
        will actually see it — the no-sink path stays ~free."""
        sinks = self._sinks  # graftlint: disable=lock-coverage — copy-on-write tuple: an unlocked read sees a complete old/new tuple
        if not sinks or not _ENABLED:
            return None
        with self._deliver:
            ev = make_event(name, fields)
            for sink in sinks:
                try:
                    sink(ev)
                except Exception:
                    logger.exception("obs sink %r failed on %s", sink, name)
        return ev

    def publish(self, ev: Event) -> Optional[Event]:
        """Deliver a pre-built :class:`Event` (e.g. one a worker already
        wrote to its local journal) to the current sinks."""
        sinks = self._sinks  # graftlint: disable=lock-coverage — copy-on-write tuple: an unlocked read sees a complete old/new tuple
        if not sinks or not _ENABLED:
            return None
        with self._deliver:
            for sink in sinks:
                try:
                    sink(ev)
                except Exception:
                    logger.exception("obs sink %r failed on %s", sink, ev.name)
        return ev


_DEFAULT_BUS = EventBus()


def get_bus() -> EventBus:
    """The process-wide default bus."""
    return _DEFAULT_BUS


def emit(name: str, **fields: Any) -> Optional[Event]:
    """``get_bus().emit(...)`` — the module-level convenience every
    instrumented call site uses."""
    return _DEFAULT_BUS.emit(name, **fields)


# ---------------------------------------------------------------- spans
#: optional profiler range factory, installed by use_profiler_annotations();
#: None = spans are host-only
_ANNOTATE: Optional[Callable[[str], Any]] = None


def use_profiler_annotations(enable: bool = True) -> None:
    """The counterpart of the reference's ``use_jax_annotations``: every
    span additionally opens a ``torch.profiler.record_function`` range, so
    named host regions line up with the device kernels in a profiler trace.
    Off by default (the obs layer imports torch only when asked)."""
    global _ANNOTATE
    if enable:
        from torch.profiler import record_function

        _ANNOTATE = record_function
    else:
        _ANNOTATE = None


@contextlib.contextmanager
def span(name: str, bus: Optional[EventBus] = None, **fields: Any) -> Iterator[None]:
    """Monotonic-clock duration region: on exit, emits ``name`` with a
    ``duration_s`` field (plus ``error=<type>`` if the body raised).

    Near-zero when inactive: with no sinks and no profiler annotations
    the body runs with no clock reads at all."""
    target = bus if bus is not None else _DEFAULT_BUS
    annotate = _ANNOTATE
    if not target.active and annotate is None:
        yield
        return
    ctx = annotate(name) if annotate is not None else contextlib.nullcontext()
    t0 = time.monotonic()
    error: Optional[str] = None
    try:
        with ctx:
            yield
    except BaseException as e:
        error = type(e).__name__
        raise
    finally:
        duration = time.monotonic() - t0
        if error is not None:
            fields = dict(fields, error=error)
        target.emit(name, duration_s=round(duration, 6), **fields)
