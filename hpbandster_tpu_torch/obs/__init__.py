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
* :mod:`~hpbandster_tpu_torch.obs.report` — the deterministic optimizer
  report (``build_report`` / ``format_report``) and
  ``promotion_hindsight``;
* :mod:`~hpbandster_tpu_torch.obs.runtime` — the capture ledger (one
  record per CUDA-graph capture), the host-link transfer counters and the
  per-card memory sampler;
* :mod:`~hpbandster_tpu_torch.obs.profile` — on-demand ``torch.profiler``
  captures and the roofline over the capture ledger;
* :mod:`~hpbandster_tpu_torch.obs.timeline` — the flight recorder:
  :func:`phase_span` / :func:`mark`, :class:`TimelineRecorder`, the
  Perfetto export and the critical path by phase;
* :mod:`~hpbandster_tpu_torch.obs.anomaly`, :mod:`~hpbandster_tpu_torch.obs.slo`
  and :mod:`~hpbandster_tpu_torch.obs.alerts` — streaming anomaly rules,
  SLOs with multi-window burn rates and the alert lifecycle, each with a
  byte-identical offline replay over a journal;
* :mod:`~hpbandster_tpu_torch.obs.export`, :mod:`~hpbandster_tpu_torch.obs.health`
  and :mod:`~hpbandster_tpu_torch.obs.collector` — the Prometheus text
  exporter, the in-process health snapshot and crash dump, and the fleet
  collector (over the ``obs_snapshot`` RPC or an injected fetcher);
* ``python -m hpbandster_tpu_torch.obs summarize|report|timeline|
  critical-path|replay|slo|alerts|watch|top|export`` — the CLI over
  journals (:mod:`~hpbandster_tpu_torch.obs.summarize`).

Everything here is stdlib-only and costs ~nothing when no sink is
attached, so the instrumentation stays on; attach a sink to look::

    from hpbandster_tpu_torch import obs

    handle = obs.configure(journal_path="run/journal.jsonl")
    try:
        ...  # any optimizer run; events stream into the journal
    finally:
        handle.close()
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

from hpbandster_tpu_torch.obs import events as _events
from hpbandster_tpu_torch.obs import metrics as _metrics
from hpbandster_tpu_torch.obs.alerts import (  # noqa: F401
    AlertManager,
    scan_slo_records,
)
from hpbandster_tpu_torch.obs.anomaly import (  # noqa: F401
    AnomalyDetector,
    AnomalyRules,
    scan_records,
)
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
from hpbandster_tpu_torch.obs.collector import (  # noqa: F401
    FleetCollector,
    derive_fleet,
    format_fleet_table,
    read_series,
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
from hpbandster_tpu_torch.obs.export import (  # noqa: F401
    parse_prometheus_text,
    render_registry,
    render_snapshot,
)
from hpbandster_tpu_torch.obs.health import (  # noqa: F401
    HealthEndpoint,
    install_crash_dump,
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
from hpbandster_tpu_torch.obs.profile import (  # noqa: F401
    ProfileSession,
    device_peaks,
    format_roofline,
    get_profile_session,
    roofline_report,
)
from hpbandster_tpu_torch.obs.runtime import (  # noqa: F401
    CompileTracker,
    DeviceSampler,
    get_compile_tracker,
    note_transfer,
    publish_sweep_transfers,
    runtime_snapshot,
    start_device_sampler,
    transfer_counters,
)
from hpbandster_tpu_torch.obs.slo import (  # noqa: F401
    DEFAULT_WINDOWS,
    BurnWindow,
    Selector,
    SLOEvaluator,
    SLOSpec,
    default_slo_pack,
)
# KDE_REFIT deliberately not re-imported: the phase constant shares its
# value with the already-exported event name (both "kde_refit")
from hpbandster_tpu_torch.obs.timeline import (  # noqa: F401
    ADMISSION,
    COMPILE,
    PHASES,
    PROMOTION,
    RPC,
    RUNG_COMPUTE,
    TRANSFER,
    TimelineRecorder,
    align_clocks,
    build_timeline,
    critical_path,
    format_critical_path,
    mark,
    phase_span,
    to_chrome_trace,
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
    "HealthEndpoint", "install_crash_dump",
    "AnomalyDetector", "AnomalyRules", "scan_records",
    "AlertManager", "scan_slo_records", "SLOSpec", "SLOEvaluator",
    "Selector", "BurnWindow", "DEFAULT_WINDOWS", "default_slo_pack",
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
    "CompileTracker", "DeviceSampler", "get_compile_tracker",
    "note_transfer", "publish_sweep_transfers", "transfer_counters",
    "runtime_snapshot", "start_device_sampler",
    "ProfileSession", "get_profile_session", "device_peaks",
    "roofline_report", "format_roofline",
    "FleetCollector", "derive_fleet", "format_fleet_table", "read_series",
    "render_snapshot", "render_registry", "parse_prometheus_text",
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
    "PHASES", "ADMISSION", "COMPILE", "TRANSFER", "RUNG_COMPUTE",
    "PROMOTION", "RPC",
    "phase_span", "mark", "TimelineRecorder", "align_clocks",
    "build_timeline", "to_chrome_trace", "critical_path",
    "format_critical_path",
]


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
                 journal: Optional[JsonlJournal], ring: Optional[RingBuffer],
                 anomaly: Optional[AnomalyDetector] = None,
                 sampler: Optional[DeviceSampler] = None,
                 slo: Optional[AlertManager] = None):
        self._detachers = detachers
        self.journal = journal
        self.ring = ring
        self.anomaly = anomaly
        self.sampler = sampler
        self.slo = slo

    def close(self) -> None:
        """Detach every sink, stop the sampler and close the journal file
        (idempotent)."""
        for detach in self._detachers:
            detach()
        self._detachers = []
        if self.sampler is not None:
            from hpbandster_tpu_torch.obs.runtime import _clear_device_sampler

            self.sampler.stop()
            _clear_device_sampler(self.sampler)
            self.sampler = None
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
    anomaly: Union[bool, AnomalyRules, None] = None,
    device_sampler: Union[bool, float, None] = None,
    slo: Union[bool, List[SLOSpec], None] = None,
) -> ObsHandle:
    """Attach the standard sinks to ``bus`` (default: the process bus).

    ``journal_path`` enables the rotating JSONL journal; ``ring_capacity
    > 0`` additionally keeps the newest events in memory for post-mortems.
    ``identity`` stamps every journal record with this process's identity:
    ``True`` for the automatic ``{host, pid}`` pair, or a dict of extra
    fields merged over it. ``anomaly`` attaches a streaming
    :class:`AnomalyDetector` (``True`` for default :class:`AnomalyRules`,
    or pass tuned rules); its ``alert`` events land in the same journal
    and it is on the handle as ``handle.anomaly``. ``slo`` attaches an
    :class:`AlertManager` (``True`` for :func:`default_slo_pack`, or pass
    a list of :class:`SLOSpec`); its ``slo_alert`` transitions land in the
    same journal (replayable with ``obs slo``) and it is on the handle as
    ``handle.slo``. ``device_sampler`` starts the periodic per-card memory
    sampler (``True`` for the default 10 s cadence, or a number of
    seconds; :class:`~hpbandster_tpu_torch.obs.runtime.DeviceSampler`),
    kept on the handle as ``handle.sampler``. Returns an
    :class:`ObsHandle`; close it to detach (tests and multi-run processes
    must, or sinks accumulate)."""
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
    detector = None
    if anomaly:
        detector = AnomalyDetector(
            rules=anomaly if isinstance(anomaly, AnomalyRules) else None,
            bus=bus,
        )
        detachers.append(bus.subscribe(detector))
    manager = None
    if slo:
        manager = AlertManager(
            specs=slo if isinstance(slo, (list, tuple)) else None,
            bus=bus,
        )
        detachers.append(bus.subscribe(manager))
    sampler = None
    if device_sampler:
        sampler = start_device_sampler(
            interval_s=10.0 if device_sampler is True else float(device_sampler)
        )
    return ObsHandle(detachers, journal, ring, detector, sampler, manager)
