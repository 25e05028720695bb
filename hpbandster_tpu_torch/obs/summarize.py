"""Journal post-processing: ``python -m hpbandster_tpu_torch.obs summarize``.

Ported from ``hpbandster_tpu/obs/summarize.py`` (a copy).

Reads one or MANY (possibly rotated) JSONL run journals — e.g. the
master's and each worker's — merges them by wall clock, and prints the
run's shape:

* **per-stage latencies** — p50/p95 over the ``queue_s`` (submitted ->
  started) and ``run_s`` (started -> finished) durations carried by
  ``job_finished``/``job_failed`` events, plus every span event's
  ``duration_s`` grouped by name (``kde_refit``, ``wave_evaluate``,
  ``sweep_chunk``, ...);
* **worker utilization** — per worker, busy seconds (sum of ``run_s``)
  over the journal's wall-clock window, with jobs/failures tallied;
* **failure tallies** — failed jobs, RPC retries, dropped workers,
  dead-lettered unknown results;
* **xla runtime** — compile count / seconds from ``xla_compile`` records
  (``obs/runtime.py``), the compile-time share of the journal's
  wall-clock window, and the top recompiling functions;
* **device telemetry** — the decoded in-trace metrics plane
  (``device_telemetry`` records, ``obs/device_metrics.py``): crash rate,
  per-rung loss quantiles and promotion counts for fused/resident sweeps
  whose per-job events never surfaced to host;
* **per-trace timelines** — records sharing a ``trace_id`` (one job's
  round-trip, see ``obs/trace.py``) joined across journals into a
  queue-wait -> dispatch -> compute -> delivery stage breakdown, with the
  set of hosts each trace touched.

Durations are computed at the EMITTING site from monotonic clocks and
carried in the events, so the summary never subtracts wall-clock stamps
(immune to clock jumps) and never compares monotonic clocks across
processes — the cross-host join is on ``trace_id``, and wall clock only
orders the display.

:func:`watch_journal` is the live counterpart: tail a journal as the run
writes it, rendering a one-line status per tick (survives rotation and a
not-yet-created file).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, TextIO, Tuple

from hpbandster_tpu_torch.obs import events as E
from hpbandster_tpu_torch.obs.journal import read_journal_ex

#: sink-free bus for CLI-side collectors (watch/top): a viewer must not
#: inject fleet_sample events into the process it happens to run inside
_NULL_BUS = E.EventBus()

__all__ = [
    "summarize_records", "format_summary", "summarize_path",
    "read_merged", "read_merged_ex", "trace_timelines", "watch_journal",
    "watch_snapshot", "make_viewer_collector",
]


def make_viewer_collector(uris: Sequence[str], interval: float) -> Any:
    """A CLI viewer's collector (``watch --snapshot`` / ``top``): private
    registry + sink-free bus, because a viewer must not publish the
    viewed fleet's gauges or ``fleet_sample`` events into whatever
    process it happens to run inside. Validates every URI up front — a
    malformed one can never succeed, so fail fast (``ValueError`` names
    the offending URI) instead of looping "waiting" forever on a typo.
    """
    # CLI-only imports: the obs substrate itself never pulls in the RPC
    # transport (health.py is deliberately transport-agnostic)
    from hpbandster_tpu_torch.obs.collector import FleetCollector
    from hpbandster_tpu_torch.obs.metrics import MetricsRegistry
    from hpbandster_tpu_torch.parallel.rpc import parse_uri

    for u in uris:
        try:
            parse_uri(u)
        except ValueError as e:
            raise ValueError(f"invalid --snapshot URI {u!r}: {e}") from e
    return FleetCollector(
        endpoints=list(uris), interval_s=interval,
        timeout_s=max(interval, 2.0),
        registry=MetricsRegistry(), bus=_NULL_BUS,
    )

#: journal-record fields -> timeline stage names (the emitting sites:
#: dispatcher JOB_STARTED, worker JOB_FINISHED/JOB_FAILED, worker
#: RESULT_DELIVERED, master JOB_FINISHED/JOB_FAILED)
_STAGE_FIELDS = (
    ("queue_wait_s", "queue_wait_s"),
    ("dispatch_s", "dispatch_s"),
    ("compute_s", "compute_s"),
    ("delivery_s", "delivery_s"),
    ("run_s", "end_to_end_s"),
)

#: events both the master side and the worker side emit for the SAME job
#: (same trace_id) — counted once per (event, trace_id) in summaries
_JOB_LIFECYCLE_EVENTS = frozenset(
    {E.JOB_SUBMITTED, E.JOB_STARTED, E.JOB_FINISHED, E.JOB_FAILED}
)


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        raise ValueError("no values")
    k = max(int(round(q * (len(sorted_vals) - 1))), 0)
    return sorted_vals[min(k, len(sorted_vals) - 1)]


def _stats(vals: Iterable[float]) -> Optional[Dict[str, Any]]:
    vals = sorted(float(v) for v in vals)
    if not vals:
        return None
    return {
        "count": len(vals),
        "p50": round(_percentile(vals, 0.50), 6),
        "p95": round(_percentile(vals, 0.95), 6),
        "max": round(vals[-1], 6),
        "total": round(sum(vals), 6),
    }


def read_merged_ex(paths: Sequence[str]) -> "Tuple[List[Dict[str, Any]], int]":
    """Records of N journals merged oldest-first by wall clock (the only
    cross-process ordering available; durations never derive from it),
    plus the total count of skipped corrupt/truncated lines."""
    records: List[Dict[str, Any]] = []
    skipped = 0
    for p in paths:
        recs, skip = read_journal_ex(p)
        records.extend(recs)
        skipped += skip
    records.sort(key=lambda r: r.get("t_wall") if isinstance(r.get("t_wall"), (int, float)) else 0.0)
    return records, skipped


def read_merged(paths: Sequence[str]) -> List[Dict[str, Any]]:
    """:func:`read_merged_ex` without the skip count."""
    return read_merged_ex(paths)[0]


def trace_timelines(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Join records by ``trace_id`` into per-job timelines.

    Each timeline carries the stage durations measured at their emitting
    sites (queue wait and dispatch on the master/dispatcher side, compute
    and delivery on the worker side, end-to-end back on the master), the
    hosts that contributed records, retry/failure flags, and the journal
    wall-clock span. Cross-trace aggregates ride along as
    ``stage_latency_s``. Traces that ran on the fused/resident device
    path additionally carry a ``device`` section — chunk/rung/evaluation
    counts folded from their ``device_telemetry`` records — and a
    ``device_s`` stage accumulating the measured execute windows.
    """
    traces: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        tid = rec.get("trace_id")
        if not isinstance(tid, str) or not tid:
            continue
        slot = traces.setdefault(tid, {
            "trace_id": tid,
            "config_id": None,
            "events": 0,
            "hosts": set(),
            "stages": {},
            "retries": 0,
            "failed": False,
            "dead_lettered": False,
            "t_first": None,
            "t_last": None,
        })
        slot["events"] += 1
        tw = rec.get("t_wall")
        if isinstance(tw, (int, float)):
            slot["t_first"] = tw if slot["t_first"] is None else min(slot["t_first"], tw)
            slot["t_last"] = tw if slot["t_last"] is None else max(slot["t_last"], tw)
        host = rec.get("host")
        if host:
            slot["hosts"].add(str(host))
        if slot["config_id"] is None and rec.get("config_id") is not None:
            slot["config_id"] = rec["config_id"]
        name = rec.get("event")
        if name == E.RPC_RETRY:
            slot["retries"] += 1
        elif name == E.JOB_FAILED:
            slot["failed"] = True
        elif name == E.UNKNOWN_RESULT:
            slot["dead_lettered"] = True
        elif name == E.DEVICE_TELEMETRY:
            # a fused/resident sweep's device sections belong to its
            # trace: fold the decoded rung plane in so the timeline shows
            # where the device window went instead of a gap (device_s
            # accumulates — one record per chunk)
            ex = rec.get("execute_s")
            if isinstance(ex, (int, float)):
                slot["stages"]["device_s"] = (
                    slot["stages"].get("device_s", 0.0) + float(ex)
                )
            dev = slot.setdefault(
                "device", {"chunks": 0, "rungs": 0, "evaluations": 0}
            )
            dev["chunks"] += 1
            order = rec.get("rung_order")
            if isinstance(order, list):
                dev["rungs"] += len(order)
                dev["evaluations"] += sum(
                    int(e.get("evals", 0)) for e in order
                    if isinstance(e, dict)
                )
        for field, stage in _STAGE_FIELDS:
            v = rec.get(field)
            if isinstance(v, (int, float)):
                # keep the LAST occurrence: a requeued job's second
                # dispatch is the one that produced the result
                slot["stages"][stage] = float(v)

    timelines = []
    stage_vals: Dict[str, List[float]] = {}
    for slot in sorted(
        traces.values(), key=lambda s: (s["t_first"] is None, s["t_first"] or 0.0)
    ):
        slot["hosts"] = sorted(slot["hosts"])
        timelines.append(slot)
        for stage, v in slot["stages"].items():
            stage_vals.setdefault(stage, []).append(v)
    return {
        "count": len(timelines),
        "stage_latency_s": {
            stage: _stats(vals) for stage, vals in sorted(stage_vals.items())
        },
        "timelines": timelines,
    }


def summarize_records(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate journal records into the summary dict the CLI renders.

    Merged journals tell each job's story twice — the master/dispatcher
    side and the worker side both emit ``job_*`` under the same names —
    so job lifecycle counts are deduplicated on ``(event, trace_id)``:
    one job, one count, regardless of how many journals witnessed it.
    (Field extraction is NOT deduplicated: the master record carries
    ``queue_s``/``run_s``, the worker record ``compute_s`` — both feed
    the stage and timeline aggregates.)"""
    counts: Dict[str, int] = {}
    queue_s: List[float] = []
    run_s: List[float] = []
    spans: Dict[str, List[float]] = {}
    workers: Dict[str, Dict[str, float]] = {}
    t_wall_min: Optional[float] = None
    t_wall_max: Optional[float] = None
    seen_job_keys: set = set()
    #: host-link bill carried by sweep-level records (``sweep_chunk`` /
    #: ``sweep_incumbent`` stamp h2d_bytes/d2h_bytes/host_syncs)
    link = {"records": 0, "h2d_bytes": 0, "d2h_bytes": 0, "host_syncs": 0}
    #: device-telemetry records (obs/device_metrics.py): the decoded
    #: in-trace counters fused/resident sweeps journal instead of
    #: per-job events
    device_records: List[Dict[str, Any]] = []

    def worker_slot(name: str) -> Dict[str, float]:
        return workers.setdefault(
            name, {"busy_s": 0.0, "jobs": 0, "failed": 0}
        )

    for rec in records:
        name = rec.get("event")
        if not name:
            continue
        tid = rec.get("trace_id")
        if name in _JOB_LIFECYCLE_EVENTS and isinstance(tid, str) and tid:
            key = (name, tid)
            if key not in seen_job_keys:
                seen_job_keys.add(key)
                counts[name] = counts.get(name, 0) + 1
        else:
            counts[name] = counts.get(name, 0) + 1
        tw = rec.get("t_wall")
        if isinstance(tw, (int, float)):
            t_wall_min = tw if t_wall_min is None else min(t_wall_min, tw)
            t_wall_max = tw if t_wall_max is None else max(t_wall_max, tw)

        if name in (E.JOB_FINISHED, E.JOB_FAILED):
            q, r = rec.get("queue_s"), rec.get("run_s")
            if isinstance(q, (int, float)):
                queue_s.append(q)
            if isinstance(r, (int, float)):
                run_s.append(r)
            w = rec.get("worker")
            if w:
                slot = worker_slot(str(w))
                slot["jobs"] += 1
                if isinstance(r, (int, float)):
                    slot["busy_s"] += r
                if name == E.JOB_FAILED:
                    slot["failed"] += 1
        elif isinstance(rec.get("duration_s"), (int, float)):
            spans.setdefault(name, []).append(rec["duration_s"])
        if isinstance(rec.get("h2d_bytes"), (int, float)) or isinstance(
            rec.get("d2h_bytes"), (int, float)
        ):
            link["records"] += 1
            for field in ("h2d_bytes", "d2h_bytes", "host_syncs"):
                v = rec.get(field)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    link[field] += int(v)
        if name == E.DEVICE_TELEMETRY:
            device_records.append(rec)

    window_s = (
        (t_wall_max - t_wall_min)
        if t_wall_min is not None and t_wall_max is not None
        else 0.0
    )
    utilization = {}
    for wname, slot in sorted(workers.items()):
        utilization[wname] = {
            "jobs": int(slot["jobs"]),
            "failed": int(slot["failed"]),
            "busy_s": round(slot["busy_s"], 3),
            "utilization": (
                round(min(slot["busy_s"] / window_s, 1.0), 4)
                if window_s > 0 else None
            ),
        }

    stages: Dict[str, Any] = {}
    if queue_s:
        stages["queue"] = _stats(queue_s)
    if run_s:
        stages["run"] = _stats(run_s)
    for sname in sorted(spans):
        stages[sname] = _stats(spans[sname])

    # one shared aggregation with the report CLI (obs/runtime.py) — the
    # two views of the same journal must agree on compile economics
    from hpbandster_tpu_torch.obs.runtime import compile_stats_from_records

    runtime = compile_stats_from_records(records, window_s)

    # same sharing rule for the device metrics plane: summarize and
    # report both render device_section_from_records' aggregation
    from hpbandster_tpu_torch.obs.device_metrics import device_section_from_records

    device = device_section_from_records(device_records)

    return {
        "events_total": sum(counts.values()),
        "window_s": round(window_s, 3),
        "event_counts": dict(sorted(counts.items())),
        "stage_latency_s": stages,
        "worker_utilization": utilization,
        "runtime": runtime,
        # device<->host byte accounting, when any sweep-level record
        # carried it (the resident tier's flat-d2h evidence in journal form)
        "host_link": link if link["records"] else None,
        # decoded in-trace telemetry (obs/device_metrics.py) — the view
        # of sweeps whose per-job events never surfaced to host
        "device": device,
        "failures": {
            "jobs_failed": counts.get(E.JOB_FAILED, 0),
            "rpc_retries": counts.get(E.RPC_RETRY, 0),
            "workers_dropped": counts.get(E.WORKER_DROPPED, 0),
            "unknown_results_dead_lettered": counts.get(E.UNKNOWN_RESULT, 0),
        },
        "traces": trace_timelines(records),
    }


def summarize_path(path: "str | Sequence[str]") -> Dict[str, Any]:
    paths = [path] if isinstance(path, str) else list(path)
    return summarize_records(read_merged(paths))


def format_summary(s: Dict[str, Any]) -> str:
    lines = [
        f"events: {s['events_total']} over {s['window_s']}s",
        "",
        "stage latency (seconds):",
        f"  {'stage':<24} {'count':>6} {'p50':>10} {'p95':>10} {'max':>10}",
    ]
    for name, st in s["stage_latency_s"].items():
        lines.append(
            f"  {name:<24} {st['count']:>6} {st['p50']:>10.4f} "
            f"{st['p95']:>10.4f} {st['max']:>10.4f}"
        )
    if not s["stage_latency_s"]:
        lines.append("  (no duration-carrying events in this journal)")
    lines.append("")
    lines.append("worker utilization:")
    for wname, u in s["worker_utilization"].items():
        util = "n/a" if u["utilization"] is None else f"{100 * u['utilization']:.1f}%"
        lines.append(
            f"  {wname}: {u['jobs']} jobs ({u['failed']} failed), "
            f"busy {u['busy_s']}s, utilization {util}"
        )
    if not s["worker_utilization"]:
        lines.append("  (no worker-attributed jobs in this journal)")
    rt = s.get("runtime") or {}
    if rt.get("compiles"):
        lines.append("")
        share = rt.get("compile_share_of_wall")
        lines.append(
            "xla runtime: %d compiles, %.3fs compile time%s"
            % (
                rt["compiles"], rt["compile_s"],
                f" ({100 * share:.1f}% of wall)" if share is not None else "",
            )
        )
        for row in rt.get("top_recompilers") or []:
            lines.append(
                f"  {row['fn']}: {row['compiles']} compiles, "
                f"{row['compile_s']:.3f}s"
            )
    link = s.get("host_link")
    if link:
        lines.append("")
        lines.append(
            "host link: h2d %s, d2h %s over %d sweep record(s), "
            "%d host sync(s)"
            % (
                _fmt_bytes(link["h2d_bytes"]), _fmt_bytes(link["d2h_bytes"]),
                link["records"], link["host_syncs"],
            )
        )
    device = s.get("device")
    if device:
        from hpbandster_tpu_torch.obs.device_metrics import format_device_section

        lines.append("")
        lines.extend(format_device_section(device))
    lines.append("")
    f = s["failures"]
    lines.append(
        "failures: %d jobs failed, %d rpc retries, %d workers dropped, "
        "%d unknown results dead-lettered"
        % (
            f["jobs_failed"], f["rpc_retries"],
            f["workers_dropped"], f["unknown_results_dead_lettered"],
        )
    )
    traces = s.get("traces") or {}
    if traces.get("count"):
        lines.append("")
        lines.append(f"trace timelines ({traces['count']} traces):")
        lines.append(
            f"  {'trace':<18} {'config':<12} {'queue_wait':>10} {'dispatch':>9} "
            f"{'compute':>9} {'delivery':>9} {'end_to_end':>10}  hosts"
        )

        def cell(st: Dict[str, Any], key: str) -> str:
            v = st.get(key)
            return f"{v:.4f}" if isinstance(v, (int, float)) else "-"

        shown = traces["timelines"][:_MAX_TIMELINE_ROWS]
        for t in shown:
            flags = "".join(
                mark for mark, on in (
                    ("!", t["failed"]), ("r", t["retries"] > 0),
                    ("d", t["dead_lettered"]),
                ) if on
            )
            st = t["stages"]
            lines.append(
                f"  {t['trace_id'] + flags:<18} {json.dumps(t['config_id']):<12} "
                f"{cell(st, 'queue_wait_s'):>10} {cell(st, 'dispatch_s'):>9} "
                f"{cell(st, 'compute_s'):>9} {cell(st, 'delivery_s'):>9} "
                f"{cell(st, 'end_to_end_s'):>10}  {','.join(t['hosts']) or '-'}"
            )
        if len(traces["timelines"]) > len(shown):
            lines.append(
                f"  ... {len(traces['timelines']) - len(shown)} more "
                "(use --json for all)"
            )
        lines.append("  per-stage across traces (p50/p95/max):")
        for stage, st in traces["stage_latency_s"].items():
            lines.append(
                f"    {stage:<14} {st['count']:>5} traces "
                f"{st['p50']:>10.4f} {st['p95']:>10.4f} {st['max']:>10.4f}"
            )
    lines.append("")
    lines.append("event counts: " + json.dumps(s["event_counts"]))
    return "\n".join(lines)


#: format_summary caps the per-trace table; --json carries every timeline
_MAX_TIMELINE_ROWS = 20


# ------------------------------------------------------------------ watch
class _WatchState:
    """Rolling tallies behind one status line of ``watch``."""

    def __init__(self) -> None:
        self.events = 0
        self.counts: Dict[str, int] = {}
        self.workers: set = set()
        self.last_name: Optional[str] = None
        self.last_t_wall: Optional[float] = None
        self.last_alert: Optional[str] = None
        self.skipped_lines = 0
        self._seen_job_keys: set = set()

    def update(self, rec: Dict[str, Any]) -> None:
        name = rec.get("event")
        if not name:
            return
        self.events += 1
        tid = rec.get("trace_id")
        if name in _JOB_LIFECYCLE_EVENTS and isinstance(tid, str) and tid:
            # both halves of a job journal under the same names — count
            # each (event, trace) once or in_flight goes negative
            key = (name, tid)
            if key not in self._seen_job_keys:
                self._seen_job_keys.add(key)
                self.counts[name] = self.counts.get(name, 0) + 1
        else:
            self.counts[name] = self.counts.get(name, 0) + 1
        w = rec.get("worker") or rec.get("worker_id")
        if w:
            self.workers.add(str(w))
        if name == E.ALERT:
            self.last_alert = (
                f"{rec.get('rule') or '?'}:{rec.get('subject') or '?'}"
            )
        self.last_name = name
        tw = rec.get("t_wall")
        if isinstance(tw, (int, float)):
            self.last_t_wall = float(tw)

    def line(self) -> str:
        c = self.counts
        submitted = c.get(E.JOB_SUBMITTED, 0)
        finished = c.get(E.JOB_FINISHED, 0)
        failed = c.get(E.JOB_FAILED, 0)
        in_flight = max(submitted - finished - failed, 0)
        if self.last_t_wall is not None:
            age = max(time.time() - self.last_t_wall, 0.0)  # graftlint: disable=wallclock-duration — journal records carry another process's wall stamps; monotonic does not compare across hosts
            last = f"{self.last_name} {age:.1f}s ago"
        else:
            last = "-"
        alerts = c.get(E.ALERT, 0)
        alert_part = (
            f" alerts={alerts}({self.last_alert})" if alerts else ""
        )
        compiles = c.get(E.XLA_COMPILE, 0)
        compile_part = f" compiles={compiles}" if compiles else ""
        skip_part = (
            f" skipped_lines={self.skipped_lines}" if self.skipped_lines else ""
        )
        return (
            f"events={self.events} submitted={submitted} finished={finished} "
            f"failed={failed} in_flight={in_flight} "
            f"workers={len(self.workers)} last={last}"
            f"{compile_part}{alert_part}{skip_part}"
        )


def watch_journal(
    path: str,
    interval: float = 2.0,
    ticks: Optional[int] = None,
    stream: Optional[TextIO] = None,
) -> int:
    """Tail a live journal, printing one status line per tick.

    ``ticks=None`` runs until interrupted (the CLI mode); tests pass a
    finite count. Tolerates a journal that does not exist yet (a run
    about to start) and follows through rotation (file shrank -> reopen
    from the top). Partial trailing lines are buffered, never mis-parsed.
    """
    out = stream if stream is not None else sys.stdout
    state = _WatchState()
    pos = 0
    buf = ""
    tick = 0
    while True:
        try:
            size = os.path.getsize(path)
        except OSError:
            size = None
        if size is not None:
            if size < pos:  # rotated under us: the live file restarted
                pos, buf = 0, ""
            with open(path, "r", encoding="utf-8") as fh:
                fh.seek(pos)
                buf += fh.read()
                pos = fh.tell()
            lines = buf.split("\n")
            buf = lines.pop()  # tail w/o newline: kept for the next tick
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    # torn/corrupt line: counted, never fatal — the tail
                    # of a crashing run is exactly when watch matters
                    state.skipped_lines += 1
                    continue
                if isinstance(rec, dict):
                    state.update(rec)
                else:
                    state.skipped_lines += 1
            status = state.line()
        else:
            status = f"(waiting for {path})"
        stamp = time.strftime("%H:%M:%S")
        print(f"[{stamp}] {status}", file=out, flush=True)
        tick += 1
        if ticks is not None and tick >= ticks:
            return 0
        try:
            time.sleep(interval)
        except KeyboardInterrupt:  # graftlint: disable=swallowed-exception — ^C is the intended way to leave watch
            return 0


def _fmt_bytes(n: Any) -> str:
    if not isinstance(n, (int, float)):
        return "?"
    v = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(v) < 1024.0 or unit == "TiB":
            return f"{v:.0f}{unit}" if unit == "B" else f"{v:.1f}{unit}"
        v /= 1024.0
    return f"{v:.1f}TiB"


def _snapshot_runtime_part(snap: Dict[str, Any]) -> str:
    """Render a health snapshot's ``runtime`` section for one watch line:
    compile tally + per-device memory/live-buffer gauges."""
    rt = snap.get("runtime")
    if not isinstance(rt, dict):
        return ""
    parts: List[str] = []
    compile_led = rt.get("compile") or {}
    if compile_led.get("total_compiles"):
        parts.append(
            "compiles=%d(%.1fs)"
            % (compile_led["total_compiles"], compile_led.get("total_compile_s") or 0.0)
        )
    devices = (rt.get("devices") or {}).get("devices") if rt.get("devices") else None
    if isinstance(devices, dict):
        for i in sorted(devices, key=lambda k: (len(k), k)):
            d = devices[i]
            if not isinstance(d, dict):
                continue
            if "bytes_in_use" in d and "bytes_limit" in d:
                mem = f"{_fmt_bytes(d['bytes_in_use'])}/{_fmt_bytes(d['bytes_limit'])}"
            elif "bytes_in_use" in d:
                mem = _fmt_bytes(d["bytes_in_use"])
            else:
                mem = f"{d.get('live_buffers', '?')}buf"
            parts.append(f"dev{i}={mem}")
    return (" runtime: " + " ".join(parts)) if parts else ""


def _snapshot_tenant_part(
    snap: Dict[str, Any], tenant: Optional[str] = None
) -> str:
    """The serving-tier slice of one watch line: per-tenant configs_done
    counters (serve/pool.py). No tenants, no part — single-tenant lines
    stay exactly as they were."""
    from hpbandster_tpu_torch.obs.collector import tenant_counters

    counters = (snap.get("metrics") or {}).get("counters") or {}
    done = tenant_counters(counters)
    if tenant is not None:
        return f" tenant[{tenant}]: configs_done={done.get(tenant, 0)}"
    if not done:
        return ""
    return f" tenants={len(done)}(" + ",".join(
        f"{t}:{v}" for t, v in sorted(done.items())[:4]
    ) + (",..." if len(done) > 4 else "") + ")"


def _snapshot_lane_part(snap: Dict[str, Any]) -> str:
    """The continuous-batching slice of one watch line: lane occupancy,
    starved-lane count and program-warm age (``serve/continuous.py``
    gauges, read through the collector's one parser). No lanes, no part
    — lane-free processes' lines stay exactly as they were."""
    from hpbandster_tpu_torch.obs.collector import lane_gauges

    lanes = lane_gauges((snap.get("metrics") or {}).get("gauges"))
    if not lanes:
        return ""
    parts = []
    if "occupied" in lanes or "total" in lanes:
        parts.append(
            "occ=%d/%d" % (
                int(lanes.get("occupied", 0)), int(lanes.get("total", 0))
            )
        )
    if "starved" in lanes:
        parts.append(f"starved={int(lanes['starved'])}")
    if "warm_age_s" in lanes:
        parts.append(f"warm_age={lanes['warm_age_s']:.1f}s")
    return (" lanes: " + " ".join(parts)) if parts else ""


def _snapshot_slo_part(snap: Dict[str, Any]) -> str:
    """The SLO slice of one watch line: worst burn rate + firing count
    (``obs/alerts.py`` gauges, read through the collector's one parser,
    ``slo_gauges``). No SLOs, no part — lines from manager-free
    processes stay exactly as they were."""
    from hpbandster_tpu_torch.obs.collector import slo_gauges

    slo = slo_gauges((snap.get("metrics") or {}).get("gauges"))
    if not slo:
        return ""
    worst = slo.get("worst_burn_rate")
    return " slo: worst_burn={} firing={}".format(
        f"{worst:.2f}" if isinstance(worst, (int, float)) else "-",
        int(slo.get("firing", 0)),
    )


def _snapshot_device_part(snap: Dict[str, Any]) -> str:
    """The device-metrics-plane slice of one watch line: the last
    sweep's decoded in-trace counters (``sweep.device_metrics.*``
    gauges, obs/device_metrics.py). No telemetry, no part — lines from
    telemetry-free processes stay exactly as they were."""
    from hpbandster_tpu_torch.obs.device_metrics import device_metric_fields

    dm = device_metric_fields((snap.get("metrics") or {}).get("gauges"))
    if not dm:
        return ""
    parts = []
    if "evaluations" in dm:
        parts.append(f"evals={int(dm['evaluations'])}")
    if "crashes" in dm:
        parts.append(f"crashed={int(dm['crashes'])}")
    if "crash_rate" in dm:
        parts.append(f"crash_rate={dm['crash_rate']:.4g}")
    if "rounds" in dm:
        parts.append(f"rounds={int(dm['rounds'])}")
    return (" device: " + " ".join(parts)) if parts else ""


def _snapshot_status_line(
    snap: Dict[str, Any], tenant: Optional[str] = None
) -> str:
    """One endpoint's watch line body from its ``obs_snapshot``."""
    up = snap.get("uptime_s")
    counters = (snap.get("metrics") or {}).get("counters") or {}
    lat = snap.get("latency") or {}
    lat_part = " ".join(
        f"{name}=p50:{v.get('p50'):g}/p95:{v.get('p95'):g}"
        for name, v in sorted(lat.items())
        if isinstance(v, dict)
        and isinstance(v.get("p50"), (int, float))
        and isinstance(v.get("p95"), (int, float))
    )
    alerts = snap.get("alerts") or {}
    return (
        f"{snap.get('component', '?')} up={up}s "
        f"in_flight={json.dumps(snap.get('in_flight'))} "
        f"counters={sum(counters.values())} "
        f"alerts={alerts.get('total', 0)}"
        + (f" latency: {lat_part}" if lat_part else "")
        + _snapshot_tenant_part(snap, tenant)
        + _snapshot_lane_part(snap)
        + _snapshot_slo_part(snap)
        + _snapshot_device_part(snap)
        + _snapshot_runtime_part(snap)
    )


def watch_snapshot(
    uri: "str | List[str]",
    interval: float = 2.0,
    ticks: Optional[int] = None,
    stream: Optional[TextIO] = None,
    tenant: Optional[str] = None,
) -> int:
    """Poll one or many live processes' ``obs_snapshot`` health RPCs —
    latency without a journal on disk.

    Renders each snapshot's histogram quantiles (the ``latency`` section
    :meth:`~hpbandster_tpu_torch.obs.health.HealthEndpoint.snapshot` computes
    from the metrics registry), the in-flight work, and the anomaly
    alert tally. With several URIs (repeat ``--snapshot``), each tick
    prints one row per endpoint, merged through the fleet collector's
    poll/staleness machinery — an unreachable peer prints a waiting line
    (with its staleness once it has been seen at least once) and keeps
    polling; it may simply not be up yet, and one hung peer costs its
    own socket timeout, never the other rows.
    """
    uris = [uri] if isinstance(uri, str) else list(uri)
    out = stream if stream is not None else sys.stdout
    try:
        collector = make_viewer_collector(uris, interval)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    prefix_rows = len(uris) > 1
    tick = 0
    while True:
        collector.poll_once()
        states = collector.endpoint_states()
        snaps = collector.last_snapshots()
        stamp = time.strftime("%H:%M:%S")
        for name in sorted(states):
            st = states[name]
            snap = snaps.get(name)
            if st["ok"] and isinstance(snap, dict):
                status = _snapshot_status_line(snap, tenant)
            else:
                err = (st.get("error") or "?").split(":", 1)[0]
                stale_s = st.get("stale_s")
                stale_part = (
                    f", last seen {stale_s:.0f}s ago"
                    if isinstance(stale_s, (int, float)) else ""
                )
                status = (
                    f"(waiting for obs_snapshot at {st['uri']}: "
                    f"{err}{stale_part})"
                )
            row_prefix = f"{st['uri']} " if prefix_rows else ""
            print(f"[{stamp}] {row_prefix}{status}", file=out, flush=True)
        tick += 1
        if ticks is not None and tick >= ticks:
            return 0
        try:
            time.sleep(interval)
        except KeyboardInterrupt:  # graftlint: disable=swallowed-exception — ^C is the intended way to leave watch
            return 0
