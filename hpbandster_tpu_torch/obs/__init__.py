"""``hpbandster_tpu_torch.obs`` — structured events, metrics, the run
journal and the optimizer decision audit.

Ported from ``hpbandster_tpu/obs`` (copies: the port imports nothing of the
JAX package):

* :mod:`~hpbandster_tpu_torch.obs.metrics` — thread-safe counters / gauges
  / fixed-bucket histograms with an atomic :meth:`MetricsRegistry.snapshot`;
* :mod:`~hpbandster_tpu_torch.obs.events` — the typed event bus and
  monotonic-clock :func:`span` regions, with ``torch.profiler`` ranges as
  the optional span backend (:func:`use_profiler_annotations`);
* :mod:`~hpbandster_tpu_torch.obs.journal` — the rotating JSONL run journal
  and the in-memory ring buffer, identity-stamped via
  ``configure(identity=...)``; the record format is the reference's, so
  either package reads the other's journals;
* :mod:`~hpbandster_tpu_torch.obs.trace` — per-job trace, tenant and run
  context, stamped onto every event;
* :mod:`~hpbandster_tpu_torch.obs.audit` — ``config_sampled`` /
  ``promotion_decision`` / ``sweep_incumbent`` records and
  :func:`config_lineage`;
* :mod:`~hpbandster_tpu_torch.obs.device_metrics` — the device metrics
  plane's decoder, its gauges and journal record, and the per-budget cost
  feed of Pareto promotion;
* :mod:`~hpbandster_tpu_torch.obs.report` — ``promotion_hindsight``.

Everything here is stdlib-only and costs ~nothing when no sink is
attached, so the instrumentation stays on; attach a sink to look::

    from hpbandster_tpu_torch import obs

    handle = obs.configure(journal_path="run/journal.jsonl")
    try:
        ...  # any optimizer run; events stream into the journal
    finally:
        handle.close()

Not ported yet (ROADMAP A8): the anomaly detector, SLOs and alerts, the
fleet collector, the health endpoint, the runtime ledger, the exporter,
the flight recorder (``timeline``), ``summarize`` and the CLI. The
:func:`configure` arguments that attach them raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

from hpbandster_tpu_torch.obs import events as _events
from hpbandster_tpu_torch.obs import metrics as _metrics
from hpbandster_tpu_torch.obs.audit import (  # noqa: F401
    AUDIT_EVENTS,
    AUDIT_RULE_FIELDS,
    config_lineage,
    drain_stragglers,
    emit_bracket_created,
    emit_bracket_promotion,
    emit_config_sampled,
    emit_promotion_decision,
    emit_sweep_incumbent,
    note_straggler,
)
from hpbandster_tpu_torch.obs.device_metrics import (  # noqa: F401
    budget_cost_from_obs,
    decode_device_metrics,
    device_metrics_default,
    emit_device_telemetry,
    publish_device_metrics,
)
from hpbandster_tpu_torch.obs.events import (  # noqa: F401
    ALERT,
    BRACKET_PROMOTION,
    CHAOS_FAULT,
    CHECKPOINT_WRITTEN,
    CONFIG_SAMPLED,
    DEVICE_TELEMETRY,
    DUPLICATE_RESULT,
    EVENT_TYPES,
    FLEET_SAMPLE,
    JOB_FAILED,
    JOB_FINISHED,
    JOB_REQUEUED,
    JOB_STARTED,
    JOB_SUBMITTED,
    KDE_REFIT,
    PROMOTION_DECISION,
    RESULT_DELIVERED,
    RESULT_REPLAYED,
    RPC_CLIENT_CALL,
    RPC_RETRY,
    SLO_ALERT,
    SWEEP_INCUMBENT,
    UNKNOWN_RESULT,
    WORKER_DISCOVERED,
    WORKER_DROPPED,
    WORKER_QUARANTINED,
    XLA_COMPILE,
    Event,
    EventBus,
    emit,
    get_bus,
    make_event,
    span,
    use_profiler_annotations,
)
from hpbandster_tpu_torch.obs.journal import (  # noqa: F401
    JsonlJournal,
    RingBuffer,
    journal_paths,
    process_identity,
    read_journal,
    read_journal_ex,
)
from hpbandster_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_metrics,
)
from hpbandster_tpu_torch.obs.trace import (  # noqa: F401
    DEFAULT_TENANT,
    TraceContext,
    current_run,
    current_tenant,
    current_trace,
    current_wire,
    extract_tenant,
    extract_wire,
    new_trace,
    use_run,
    use_tenant,
    use_trace,
)

__all__ = [
    "Event", "EventBus", "emit", "make_event", "get_bus", "span",
    "use_profiler_annotations",
    "JsonlJournal", "RingBuffer", "read_journal", "read_journal_ex",
    "journal_paths", "process_identity",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_metrics",
    "TraceContext", "new_trace", "current_trace", "use_trace",
    "current_wire", "extract_wire",
    "DEFAULT_TENANT", "current_tenant", "use_tenant", "extract_tenant",
    "current_run", "use_run",
    "AUDIT_EVENTS", "AUDIT_RULE_FIELDS", "config_lineage",
    "emit_bracket_created", "emit_bracket_promotion",
    "emit_config_sampled", "emit_promotion_decision",
    "emit_sweep_incumbent",
    "note_straggler", "drain_stragglers",
    "decode_device_metrics", "publish_device_metrics",
    "emit_device_telemetry", "budget_cost_from_obs",
    "device_metrics_default",
    "configure", "set_enabled", "enabled", "ObsHandle",
    "EVENT_TYPES", "JOB_SUBMITTED", "JOB_STARTED", "JOB_FINISHED",
    "JOB_FAILED", "WORKER_DISCOVERED", "WORKER_DROPPED",
    "BRACKET_PROMOTION", "KDE_REFIT", "RPC_RETRY", "RESULT_DELIVERED",
    "CHECKPOINT_WRITTEN", "UNKNOWN_RESULT",
    "CONFIG_SAMPLED", "PROMOTION_DECISION", "ALERT", "XLA_COMPILE",
    "FLEET_SAMPLE",
    "JOB_REQUEUED", "RESULT_REPLAYED", "DUPLICATE_RESULT",
    "WORKER_QUARANTINED", "CHAOS_FAULT", "SWEEP_INCUMBENT",
    "DEVICE_TELEMETRY", "RPC_CLIENT_CALL", "SLO_ALERT",
]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"obs.configure({what}) is not ported yet (ROADMAP A8: the "
        "observability modules past the bus and the journal)")


def set_enabled(flag: bool) -> None:
    """Process-wide kill switch: ``False`` turns every emit / counter /
    span into a single-boolean-check no-op."""
    _events._set_enabled(flag)
    _metrics._set_enabled(flag)


def enabled() -> bool:
    return _events._ENABLED


class ObsHandle:
    """What :func:`configure` returns: the attached sinks + one close()."""

    def __init__(self, detachers: List[Callable[[], None]],
                 journal: Optional[JsonlJournal], ring: Optional[RingBuffer]):
        self._detachers = detachers
        self.journal = journal
        self.ring = ring

    def close(self) -> None:
        """Detach every sink and close the journal file (idempotent)."""
        for detach in self._detachers:
            detach()
        self._detachers = []
        if self.journal is not None:
            self.journal.close()

    def __enter__(self) -> "ObsHandle":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


def configure(
    journal_path: Optional[str] = None,
    journal_max_bytes: int = 16 * 1024 * 1024,
    journal_max_files: int = 3,
    ring_capacity: int = 0,
    identity: Union[bool, Dict[str, Any], None] = None,
    bus: Optional[EventBus] = None,
    anomaly: Any = None,
    device_sampler: Any = None,
    slo: Any = None,
) -> ObsHandle:
    """Attach the standard sinks to ``bus`` (default: the process bus).

    ``journal_path`` enables the rotating JSONL journal; ``ring_capacity
    > 0`` additionally keeps the newest events in memory for post-mortems.
    ``identity`` stamps every journal record with this process's identity:
    ``True`` for the automatic ``{host, pid}`` pair, or a dict of extra
    fields merged over it. ``anomaly``, ``device_sampler`` and ``slo``
    attach modules the port has not yet and raise ``NotImplementedError``
    when set. Returns an :class:`ObsHandle`; close it to detach (tests and
    multi-run processes must, or sinks accumulate)."""
    for name, value in (("anomaly=", anomaly), ("device_sampler=", device_sampler),
                        ("slo=", slo)):
        if value:
            raise _not_ported(name)
    bus = bus if bus is not None else get_bus()
    detachers: List[Callable[[], None]] = []
    journal = None
    ring = None
    if journal_path is not None:
        static = None
        if identity:
            static = process_identity(
                **(identity if isinstance(identity, dict) else {})
            )
        journal = JsonlJournal(
            journal_path, max_bytes=journal_max_bytes,
            max_files=journal_max_files, static_fields=static,
        )
        detachers.append(bus.subscribe(journal))
    if ring_capacity > 0:
        ring = RingBuffer(ring_capacity)
        detachers.append(bus.subscribe(ring))
    return ObsHandle(detachers, journal, ring)
