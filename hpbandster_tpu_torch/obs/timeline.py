"""Unified sweep timeline: flight recorder, Perfetto export, critical path.

Ported from ``hpbandster_tpu/obs/timeline.py`` (a copy). The record and
trace formats are the reference's, so either package's journals lay out
the same timeline; the capture ledger's ``xla_compile`` records (one per
CUDA-graph capture in the port) are the compile phase.

The stack already emits five telemetry planes — host spans
(``obs/events.py``), trace contexts and RPC hop envelopes
(``obs/trace.py`` + ``parallel/rpc.py``), ``tracked_jit`` compile events
(``obs/runtime.py``), serve lane lifecycle records
(``serve/continuous.py``), and the device metrics plane's per-rung
sections (``obs/device_metrics.py``, ordered by the ``rung_seq`` stamp
the in-trace accumulator writes). Each answers its own question; none
answers *where the wall-clock of one sweep went*. This module joins
them into one causally-ordered timeline:

* :func:`to_chrome_trace` exports merged journal records as Chrome
  trace-event JSON (open in https://ui.perfetto.dev): one process row
  per ``(host, pid)``, thread rows for the main loop, each worker, each
  serve lane and the device loop, duration slices for every span-shaped
  record, per-rung device slices laid out in ``rung_seq`` order, and
  flow arrows following a ``trace_id`` across RPC hops into the device
  loop. ``python -m hpbandster_tpu_torch.obs timeline <journal> --out
  trace.json`` is the CLI face.
* :func:`critical_path` walks the same span set and attributes the
  journal's end-to-end wall-clock to the named phases below. Overlapping
  concurrent spans never double-count: the attribution sweeps elementary
  time segments and charges each to the highest-priority active phase,
  so phase seconds always sum to <= the end-to-end span (a property test
  pins this for arbitrary journals). ``obs critical-path`` renders the
  per-phase table; the machine-readable verdict lands in bench.py's
  artifact next to the budget verdicts.

Clock discipline (the cross-host alignment fix): merged records are
ordered on each host's monotonic clock re-anchored by the host's MEDIAN
``t_wall - t_mono`` offset — the wall/mono twin-stamp convention every
event and ``core.job.Job`` already carries. A wall-clock step (NTP jump)
mid-run moves a record's ``t_wall`` but not its ``t_mono``, and one
host's skewed records cannot shuffle another host's ordering; durations
were always monotonic-measured at the emitting site and are used as-is.

Recording discipline: the span API below (:func:`phase_span`,
:func:`mark`) delegates to ``obs.events`` — near-zero with no sink
attached, and NEVER legal inside a captured CUDA graph (a host emit
there runs once at capture and never on replay). With the
recorder off, behavior is byte-identical to not having it: no clock
reads, no event construction.
"""

from __future__ import annotations

import statistics
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from hpbandster_tpu_torch.obs import events as E
from hpbandster_tpu_torch.obs.journal import event_to_record, process_identity

__all__ = [
    "ADMISSION",
    "COMPILE",
    "TRANSFER",
    "RUNG_COMPUTE",
    "PROMOTION",
    "KDE_REFIT",
    "RPC",
    "PHASES",
    "phase_span",
    "mark",
    "TimelineRecorder",
    "clock_offsets",
    "normalized_time",
    "align_clocks",
    "build_timeline",
    "to_chrome_trace",
    "critical_path",
    "format_critical_path",
]

# ------------------------------------------------------------ phase taxonomy
#: master-side wait before a job/chunk is admitted to execution
ADMISSION = "admission_wait"
#: compilation: the capture ledger's records, sweep_chunk compile splits
COMPILE = "compile"
#: host<->device transfer (h2d staging, d2h fetch)
TRANSFER = "transfer"
#: rung evaluation work — device execute windows, worker compute spans
RUNG_COMPUTE = "rung_compute"
#: promotion/successive-halving bookkeeping
PROMOTION = "promotion"
#: KDE model refits
KDE_REFIT = "kde_refit"
#: RPC dispatch/delivery hops and retries
RPC = "rpc"

#: the closed phase vocabulary (docs/observability.md "Timeline &
#: critical path") — ``phase_span`` refuses names outside it so the
#: critical-path table cannot silently grow unaggregatable rows
PHASES = (ADMISSION, COMPILE, TRANSFER, RUNG_COMPUTE, PROMOTION,
          KDE_REFIT, RPC)

#: attribution priority when concurrent spans overlap (lower = wins):
#: device/eval work is the sweep's purpose, so overhead phases only
#: claim time no compute span covers
_PHASE_PRIORITY = {
    RUNG_COMPUTE: 0, COMPILE: 1, TRANSFER: 2, KDE_REFIT: 3,
    PROMOTION: 4, RPC: 5, ADMISSION: 6,
}

#: event name -> phase, for the signals that predate the explicit
#: ``phase=`` field (an explicit field always wins)
_EVENT_PHASE = {
    E.XLA_COMPILE: COMPILE,
    E.KDE_REFIT: KDE_REFIT,
    E.BRACKET_PROMOTION: PROMOTION,
    E.PROMOTION_DECISION: PROMOTION,
    E.RPC_RETRY: RPC,
    E.RPC_CLIENT_CALL: RPC,
    "sweep_chunk": RUNG_COMPUTE,
    "wave_evaluate": RUNG_COMPUTE,
    "serve_chunk": RUNG_COMPUTE,
}

#: journal stage fields (obs/summarize.py _STAGE_FIELDS) -> phase; each
#: is a duration measured at its emitting site, ending at the record
_STAGE_PHASE = (
    ("queue_wait_s", ADMISSION),
    ("dispatch_s", RPC),
    ("compute_s", RUNG_COMPUTE),
    ("delivery_s", RPC),
)


# --------------------------------------------------------- timeline span API
def phase_span(name: str, phase: str, **fields: Any):
    """A named duration region pre-attributed to one of :data:`PHASES`.

    Thin wrapper over :func:`obs.events.span` that stamps the ``phase``
    field the critical-path analyzer attributes by — same near-zero
    inactive path (no sinks + no profiler annotations = no clock
    reads), same monotonic measurement, same ban on use inside a
    captured graph. Returns the span context manager
    directly rather than wrapping it in a second generator frame: the
    validation happens once at call time, so the inactive ``with`` costs
    ONE context frame, not two (bench_timeline_overhead measures this
    path)."""
    if phase not in _PHASE_PRIORITY:
        raise ValueError(
            f"unknown phase {phase!r}; expected one of {PHASES}"
        )
    return E.span(name, phase=phase, **fields)


def mark(name: str, phase: str, **fields: Any) -> Optional[E.Event]:
    """Emit one instant timeline event attributed to ``phase`` — the
    point-in-time sibling of :func:`phase_span` (no-op without a sink,
    like every emit; never legal inside a captured graph)."""
    if phase not in _PHASE_PRIORITY:
        raise ValueError(
            f"unknown phase {phase!r}; expected one of {PHASES}"
        )
    return E.emit(name, phase=phase, **fields)


class TimelineRecorder:
    """In-memory flight recorder: a bus sink that accumulates
    journal-shaped records (identity-stamped like ``JsonlJournal``
    lines), so benches and tests can build timelines without a journal
    on disk. ``attach()``/``detach()`` manage the subscription; the
    recorded list (:attr:`records`) feeds :func:`to_chrome_trace` /
    :func:`critical_path` directly."""

    def __init__(self, static_fields: Optional[Dict[str, Any]] = None):
        self.static_fields = (
            dict(static_fields) if static_fields is not None
            else process_identity()
        )
        self._events: List[E.Event] = []
        self._records: List[Dict[str, Any]] = []
        self._detach = None

    def __call__(self, ev: E.Event) -> None:
        # hot path: ONE list append. Flattening into journal-shaped dicts
        # is deferred to :attr:`records` — the recorded process pays
        # O(100ns) per event, not the µs-scale dict build (the
        # timeline_overhead bench bar rides on this)
        self._events.append(ev)

    @property
    def records(self) -> List[Dict[str, Any]]:
        """Journal-shaped dicts for everything recorded so far (flattened
        lazily and cached; safe to read mid-recording)."""
        while len(self._records) < len(self._events):
            rec = event_to_record(self._events[len(self._records)])
            for k, v in self.static_fields.items():
                rec.setdefault(k, v)
            self._records.append(rec)
        return self._records

    def attach(self, bus: Optional[E.EventBus] = None) -> "TimelineRecorder":
        if self._detach is None:
            self._detach = (bus if bus is not None else E.get_bus()).subscribe(self)
        return self

    def detach(self) -> None:
        if self._detach is not None:
            self._detach()
            self._detach = None

    def __enter__(self) -> "TimelineRecorder":
        return self.attach()

    def __exit__(self, *exc: Any) -> None:
        self.detach()


# ----------------------------------------------------------- clock alignment
def _num(v: Any) -> Optional[float]:
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        v = float(v)
        if v == v and v not in (float("inf"), float("-inf")):
            return v
    return None


def _proc_key(rec: Dict[str, Any]) -> Tuple[str, int]:
    pid = rec.get("pid")
    return (
        str(rec.get("host", "?")),
        int(pid) if isinstance(pid, int) and not isinstance(pid, bool) else 0,
    )


def clock_offsets(
    records: Sequence[Dict[str, Any]],
) -> Dict[Tuple[str, int], float]:
    """Per-``(host, pid)`` wall-anchoring offset: the MEDIAN of each
    process's ``t_wall - t_mono`` twin stamps. The median is the skew
    estimator: a wall-clock step mid-run shifts a minority of stamps and
    leaves the estimate on the stable majority, while monotonic clocks
    (which never jump) carry all intra-process ordering."""
    groups: Dict[Tuple[str, int], List[float]] = {}
    for rec in records:
        tw, tm = _num(rec.get("t_wall")), _num(rec.get("t_mono"))
        if tw is not None and tm is not None:
            groups.setdefault(_proc_key(rec), []).append(tw - tm)
    return {k: statistics.median(v) for k, v in groups.items()}


def normalized_time(
    rec: Dict[str, Any],
    offsets: Dict[Tuple[str, int], float],
) -> float:
    """One record's position on the merged timeline: its monotonic stamp
    re-anchored by its process's offset; records without a twin stamp
    fall back to raw ``t_wall`` (they can only order, never measure)."""
    tm = _num(rec.get("t_mono"))
    if tm is not None:
        off = offsets.get(_proc_key(rec))
        if off is not None:
            return off + tm
    tw = _num(rec.get("t_wall"))
    return tw if tw is not None else 0.0


def align_clocks(
    records: Sequence[Dict[str, Any]],
) -> Tuple[List[Dict[str, Any]], Dict[Tuple[str, int], float]]:
    """Merged records re-ordered on normalized (mono-anchored) time, plus
    the per-process offsets used — the ordering every timeline consumer
    downstream of ``read_merged_ex``'s wall-clock sort should use."""
    offsets = clock_offsets(records)
    ordered = sorted(records, key=lambda r: normalized_time(r, offsets))
    return ordered, offsets


# -------------------------------------------------------- interval extraction
def phase_of(rec: Dict[str, Any]) -> Optional[str]:
    """The phase one journal record belongs to: an explicit ``phase``
    field (the timeline span API) wins; known event names map via
    :data:`_EVENT_PHASE`; anything else is unattributed."""
    p = rec.get("phase")
    if isinstance(p, str) and p in _PHASE_PRIORITY:
        return p
    name = rec.get("event")
    return _EVENT_PHASE.get(name) if isinstance(name, str) else None


def _intervals(
    records: Sequence[Dict[str, Any]],
    offsets: Dict[Tuple[str, int], float],
) -> List[Dict[str, Any]]:
    """Every duration the journal carries, as
    ``{t0, t1, phase, name, row, rec}`` dicts (``phase`` may be None for
    span-shaped records outside the taxonomy; ``row`` is the thread-row
    hint for the exporter). Durations are the monotonic measurements in
    the records — never re-derived from wall stamps."""
    out: List[Dict[str, Any]] = []

    def add(t1, dur, phase, name, rec, row=None):
        dur = _num(dur)
        if dur is None or dur <= 0:
            return
        out.append({
            "t0": t1 - dur, "t1": t1, "phase": phase, "name": name,
            "rec": rec, "row": row,
        })

    for rec in records:
        t = normalized_time(rec, offsets)
        name = rec.get("event")
        name = name if isinstance(name, str) else "?"
        dur = _num(rec.get("duration_s"))
        if name == "sweep_chunk" and dur is not None:
            # one fused/chunked dispatch: the span covers compile (cache
            # misses only) + execute + fetch; split the compile share out
            # so the phase table separates them
            comp = _num(rec.get("compile_s")) or 0.0
            comp = min(max(comp, 0.0), dur)
            if comp > 0:
                add(t - dur + comp, comp, COMPILE, "sweep_chunk compile", rec)
            add(t, dur - comp, RUNG_COMPUTE, name, rec)
        elif dur is not None:
            add(t, dur, phase_of(rec), name, rec)
        elif name == E.XLA_COMPILE:
            add(t, _num(rec.get("compile_s")), COMPILE, name, rec)
        for field, phase in _STAGE_PHASE:
            if field == "compute_s" and dur is not None:
                continue  # a span already measured the compute window
            add(t, _num(rec.get(field)), phase, f"{name}.{field}", rec)
        if name == E.DEVICE_TELEMETRY:
            out.extend(_device_intervals(rec, t))
    return out


def _device_intervals(rec: Dict[str, Any], t: float) -> List[Dict[str, Any]]:
    """Per-rung device slices for one ``device_telemetry`` record: the
    decoded ``rung_order`` section (``rung_seq``-ordered) laid back to
    back across the sweep's measured ``execute_s`` window, ending at the
    record (the decode happens on the sweep's final d2h)."""
    execute_s = _num(rec.get("execute_s"))
    order = rec.get("rung_order")
    if execute_s is None or execute_s <= 0 or not isinstance(order, list):
        return []
    entries = [
        e for e in order
        if isinstance(e, dict) and _num(e.get("est_s")) is not None
    ]
    if not entries:
        return []
    entries.sort(key=lambda e: (e.get("seq", 0)))
    total = sum(float(e["est_s"]) for e in entries)
    scale = execute_s / total if total > 0 else 0.0
    t0 = t - execute_s
    out = []
    for e in entries:
        d = float(e["est_s"]) * scale
        out.append({
            "t0": t0, "t1": t0 + d, "phase": RUNG_COMPUTE,
            "name": "rung b%s r%s budget=%g" % (
                e.get("bracket", "?"), e.get("stage", "?"),
                float(e.get("budget", 0.0)),
            ),
            "rec": rec, "row": "device",
        })
        t0 += d
    return out


# ------------------------------------------------------------- chrome export
def _row_of(interval: Dict[str, Any]) -> str:
    """Thread-row label for one interval within its process."""
    if interval.get("row"):
        return str(interval["row"])
    rec = interval["rec"]
    worker = rec.get("worker")
    if isinstance(worker, str) and worker:
        return f"worker {worker}"
    lane = rec.get("lane")
    if isinstance(lane, int) and not isinstance(lane, bool):
        return f"lane {lane}"
    return "main"


def _flow_id(trace_id: str) -> int:
    return zlib.crc32(trace_id.encode("utf-8", "replace")) & 0x7FFFFFFF


def build_timeline(records: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """The assembled timeline: Chrome trace events plus summary stats.

    Returns ``{"traceEvents": [...], "stats": {...}}``; use
    :func:`to_chrome_trace` for the plain Perfetto-loadable dict.
    Timestamps are microseconds relative to the earliest normalized
    record (Chrome trace format wants us, not s)."""
    ordered, offsets = align_clocks(list(records))
    intervals = _intervals(ordered, offsets)

    times = [normalized_time(r, offsets) for r in ordered]
    times += [iv["t0"] for iv in intervals]
    t_base = min(times) if times else 0.0
    t_end = max(times + [iv["t1"] for iv in intervals]) if times else 0.0

    def us(t: float) -> int:
        return int(round((t - t_base) * 1e6))

    # process rows: one per (host, pid); thread rows assigned on demand
    pids: Dict[Tuple[str, int], int] = {}
    tids: Dict[Tuple[int, str], int] = {}
    events: List[Dict[str, Any]] = []

    def pid_of(key: Tuple[str, int]) -> int:
        if key not in pids:
            pids[key] = len(pids) + 1
            events.append({
                "ph": "M", "name": "process_name", "pid": pids[key],
                "tid": 0, "args": {"name": "%s:%d" % key},
            })
        return pids[key]

    def tid_of(pid: int, row: str) -> int:
        key = (pid, row)
        if key not in tids:
            tids[key] = sum(1 for p, _r in tids if p == pid) + 1
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid,
                "tid": tids[key], "args": {"name": row},
            })
        return tids[key]

    #: args whitelist: small scalar fields worth carrying into Perfetto
    _ARG_FIELDS = (
        "trace_id", "tenant_id", "config_id", "budget", "worker", "lane",
        "family", "tenant", "fn", "evaluations", "brackets", "seq",
        "lanes", "compile_cache_hit", "h2d_bytes", "d2h_bytes", "method",
    )

    slice_rows: Dict[int, Tuple[int, int]] = {}
    for iv in intervals:
        rec = iv["rec"]
        pid = pid_of(_proc_key(rec))
        tid = tid_of(pid, _row_of(iv))
        args = {
            k: rec[k] for k in _ARG_FIELDS
            if k in rec and isinstance(rec[k], (str, int, float, bool))
        }
        if iv["phase"]:
            args["phase"] = iv["phase"]
        events.append({
            "ph": "X", "name": iv["name"],
            "cat": iv["phase"] or "span",
            "pid": pid, "tid": tid,
            "ts": us(iv["t0"]),
            "dur": max(int(round((iv["t1"] - iv["t0"]) * 1e6)), 1),
            "args": args,
        })
        slice_rows[id(rec)] = (pid, tid)

    # lane occupancy slices: lane_assigned opens, the next assignment or
    # lane_released closes (an open lane at journal end closes there)
    open_lanes: Dict[Tuple[Tuple[str, int], int], Tuple[float, Dict[str, Any]]] = {}

    def close_lane(key, t1):
        t0, rec = open_lanes.pop(key)
        pid = pid_of(key[0])
        tid = tid_of(pid, f"lane {key[1]}")
        events.append({
            "ph": "X",
            "name": "tenant %s" % rec.get("tenant", "?"),
            "cat": "lane", "pid": pid, "tid": tid,
            "ts": us(t0), "dur": max(int(round((t1 - t0) * 1e6)), 1),
            "args": {
                k: rec[k] for k in ("lane", "family", "tenant", "trace_id")
                if isinstance(rec.get(k), (str, int, float, bool))
            },
        })

    for rec in ordered:
        name = rec.get("event")
        lane = rec.get("lane")
        if name not in (E.LANE_ASSIGNED, E.LANE_RELEASED):
            continue
        if not isinstance(lane, int) or isinstance(lane, bool):
            continue
        t = normalized_time(rec, offsets)
        key = (_proc_key(rec), lane)
        if key in open_lanes:
            close_lane(key, t)
        if name == E.LANE_ASSIGNED:
            open_lanes[key] = (t, rec)
    for key in list(open_lanes):
        close_lane(key, t_end)

    # instants: point-in-time records worth a mark on their row
    _INSTANT_EVENTS = frozenset({
        E.JOB_SUBMITTED, E.SWEEP_INCUMBENT, E.LANE_ASSIGNED,
        E.LANE_RELEASED, E.WORKER_DISCOVERED, E.WORKER_DROPPED,
        E.CHECKPOINT_WRITTEN,
    })
    for rec in ordered:
        name = rec.get("event")
        if name not in _INSTANT_EVENTS:
            continue
        pid = pid_of(_proc_key(rec))
        tid = tid_of(pid, _row_of({"rec": rec, "row": None}))
        ev = {
            "ph": "i", "name": str(name), "cat": "event", "pid": pid,
            "tid": tid, "ts": us(normalized_time(rec, offsets)), "s": "t",
            "args": {
                k: rec[k] for k in _ARG_FIELDS
                if isinstance(rec.get(k), (str, int, float, bool))
            },
        }
        events.append(ev)
        slice_rows.setdefault(id(rec), (pid, tid))

    # flow arrows: follow each trace_id across rows; one s/f pair per
    # row transition, anchored at the two records that witnessed the hop
    flows = 0
    by_trace: Dict[str, List[Tuple[float, Dict[str, Any]]]] = {}
    for rec in ordered:
        tid_ = rec.get("trace_id")
        if isinstance(tid_, str) and tid_ and id(rec) in slice_rows:
            by_trace.setdefault(tid_, []).append(
                (normalized_time(rec, offsets), rec)
            )
    for trace_id, seq in sorted(by_trace.items()):
        seq.sort(key=lambda p: p[0])
        base_id = _flow_id(trace_id)
        hop = 0
        for (t_a, rec_a), (t_b, rec_b) in zip(seq, seq[1:]):
            row_a, row_b = slice_rows[id(rec_a)], slice_rows[id(rec_b)]
            if row_a == row_b:
                continue
            fid = base_id + hop
            hop += 1
            flows += 1
            events.append({
                "ph": "s", "id": fid, "name": "trace", "cat": "flow",
                "pid": row_a[0], "tid": row_a[1], "ts": us(t_a),
                "args": {"trace_id": trace_id},
            })
            events.append({
                "ph": "f", "bp": "e", "id": fid, "name": "trace",
                "cat": "flow", "pid": row_b[0], "tid": row_b[1],
                "ts": max(us(t_b), us(t_a) + 1),
                "args": {"trace_id": trace_id},
            })

    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0)))
    return {
        "traceEvents": events,
        "stats": {
            "records": len(ordered),
            "slices": sum(1 for e in events if e["ph"] == "X"),
            "flows": flows,
            "processes": len(pids),
            "rows": len(tids),
            "span_s": round(t_end - t_base, 6),
        },
    }


def to_chrome_trace(records: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome trace-event JSON for merged journal records — the dict to
    ``json.dump`` and open in Perfetto (chrome://tracing works too)."""
    built = build_timeline(records)
    return {
        "traceEvents": built["traceEvents"],
        "displayTimeUnit": "ms",
        "otherData": {"generator": "hpbandster_tpu obs timeline",
                      **built["stats"]},
    }


# ------------------------------------------------------------- critical path
def critical_path(
    records: Sequence[Dict[str, Any]],
    threshold: float = 0.95,
) -> Dict[str, Any]:
    """Attribute a journal's end-to-end wall-clock to the phase taxonomy.

    The attribution is a segment sweep, not a span sum: every elementary
    time segment between interval boundaries is charged to exactly one
    phase — the highest-priority phase active there (compute beats
    compile beats transfer ... beats admission) — or to ``unattributed``
    when no phase covers it. Phase seconds therefore partition the
    end-to-end span exactly: they can never double-count overlapping
    concurrent work, and their sum is <= the end-to-end span by
    construction. The ``verdict`` sub-dict is the machine-readable
    acceptance record bench.py persists next to the budget verdicts."""
    ordered, offsets = align_clocks(list(records))
    intervals = [
        iv for iv in _intervals(ordered, offsets) if iv["phase"] is not None
    ]
    times = [normalized_time(r, offsets) for r in ordered]
    times += [iv["t0"] for iv in intervals] + [iv["t1"] for iv in intervals]
    if not times:
        return {
            "end_to_end_s": 0.0, "phases": {}, "attributed_s": 0.0,
            "unattributed_s": 0.0, "attributed_share": None,
            "verdict": {"attributed_share": None,
                        "threshold": threshold, "ok": False},
        }
    t_lo, t_hi = min(times), max(times)
    phases = {p: 0.0 for p in PHASES}

    bounds = sorted(
        {t_lo, t_hi}
        | {min(max(iv["t0"], t_lo), t_hi) for iv in intervals}
        | {min(max(iv["t1"], t_lo), t_hi) for iv in intervals}
    )
    for a, b in zip(bounds, bounds[1:]):
        if b <= a:
            continue
        mid = (a + b) / 2.0
        active = [
            iv["phase"] for iv in intervals if iv["t0"] <= mid < iv["t1"]
        ]
        if active:
            winner = min(active, key=_PHASE_PRIORITY.__getitem__)
            phases[winner] += b - a

    end_to_end = t_hi - t_lo
    attributed = sum(phases.values())
    share = (attributed / end_to_end) if end_to_end > 0 else None
    return {
        "end_to_end_s": round(end_to_end, 6),
        "phases": {
            p: {
                "s": round(s, 6),
                "share": round(s / end_to_end, 4) if end_to_end > 0 else None,
            }
            for p, s in phases.items() if s > 0
        },
        "attributed_s": round(attributed, 6),
        "unattributed_s": round(max(end_to_end - attributed, 0.0), 6),
        "attributed_share": round(share, 4) if share is not None else None,
        "verdict": {
            "attributed_share": round(share, 4) if share is not None else None,
            "threshold": threshold,
            "ok": share is not None and share >= threshold,
        },
    }


def format_critical_path(cp: Dict[str, Any]) -> str:
    """Text table for one :func:`critical_path` result."""
    lines = [
        "critical path: %.6gs end-to-end, %.6gs attributed (%s)"
        % (
            cp.get("end_to_end_s", 0.0), cp.get("attributed_s", 0.0),
            (
                "%.1f%%" % (100.0 * cp["attributed_share"])
                if isinstance(cp.get("attributed_share"), (int, float))
                else "n/a"
            ),
        ),
        "  %-16s %12s %8s" % ("phase", "seconds", "share"),
    ]
    phases = cp.get("phases") or {}
    for p in sorted(phases, key=lambda p: -phases[p]["s"]):
        entry = phases[p]
        share = entry.get("share")
        lines.append(
            "  %-16s %12.6f %8s"
            % (
                p, entry["s"],
                "%.1f%%" % (100.0 * share)
                if isinstance(share, (int, float)) else "?",
            )
        )
    if _num(cp.get("unattributed_s")):
        lines.append(
            "  %-16s %12.6f" % ("(unattributed)", cp["unattributed_s"])
        )
    v = cp.get("verdict") or {}
    lines.append(
        "  verdict: %s (threshold %.0f%%)"
        % ("ok" if v.get("ok") else "BELOW THRESHOLD",
           100.0 * float(v.get("threshold", 0.95)))
    )
    return "\n".join(lines)
