"""Streaming anomaly detection over the event bus.

Ported from ``hpbandster_tpu/obs/anomaly.py`` (a copy): the same rules
over the same records raise the same alerts in either package.

A :class:`AnomalyDetector` is an ordinary bus sink: subscribe it (or let
``obs.configure(anomaly=True)`` do it) and it watches the run's event
stream for the failure shapes an HPO fleet actually exhibits, emitting
``alert`` events (plus ``anomaly.alerts*`` counters) the moment a rule
fires — surfaced live by ``watch``, by the ``obs_snapshot`` health RPC,
and post-hoc by the report CLI's alert digest.

Rules (every threshold is a knob on :class:`AnomalyRules`, see
docs/observability.md "Alert rules"):

* **straggler** — a duration-carrying event (``run_s``, ``compute_s``,
  any span's ``duration_s``) exceeding ``straggler_factor`` × the rolling
  per-stage p95. Catches the one worker quietly 10× slower than its
  peers, which percentile summaries alone hide until the journal is read.
* **worker_flapping** — the same worker dropped ``flap_threshold`` times
  within ``flap_window_s``: a host that keeps rejoining and dying wastes
  requeues and poisons utilization; dropping it once is routine, cycling
  is an incident.
* **nan_burst** — ``nan_burst_threshold`` non-finite-loss / failed
  evaluations within the last ``nan_burst_window`` results. One diverged
  config is BOHB-normal (crashed-as-worst); a burst means the objective
  or a budget rung is broken. The rule has TWO feeds: host job events
  (the per-result window above), and the device crash counters a
  ``device_telemetry`` record carries (``obs/device_metrics.py``) — a
  fused/resident sweep journals no per-job events, so its crashes fire
  the rule through the decoded counters instead: ``crashes >=
  nan_burst_threshold`` AND crash rate >= ``nan_burst_device_rate``
  (an absolute count alone would false-positive at 100k configs).
* **bracket_skew** — a ``device_telemetry`` record whose crashed
  evaluations concentrate in a few brackets: the max per-bracket crash
  count is at least ``bracket_skew_min_crashes`` and its skew over the
  median ((max - median) / max) reaches ``bracket_skew``. Spread-out
  crashes are the objective's problem (nan_burst's beat); one straggling
  bracket means a specific budget rung or rotation slot is broken.
* **kde_refit_stall** — ``kde_stall_results`` results ingested since the
  last ``kde_refit`` while a model exists: the optimizer has silently
  degraded to random search (e.g. every new result lands on a budget
  whose fit keeps failing the min-points gate).
* **fleet_imbalance** — the fleet collector's ``fleet_sample`` records
  report ``device_mem_skew`` at or above ``imbalance_skew`` for
  ``imbalance_consecutive`` consecutive samples: one device is carrying
  the memory the mesh sharding was supposed to spread, and a single hot
  sample is a transient while a sustained streak is a placement bug.
* **worker_churn** — a ``fleet_sample``'s ``worker_churn_per_min``
  (worker drops + endpoint losses, windowed by the collector) at or
  above ``churn_per_min``: distinct from ``worker_flapping`` (ONE host
  cycling), this is the fleet-wide rate that says rungs are being
  rebalanced faster than they can drain.
* **recompile_storm** — one function's ``xla_compile`` events
  (``obs/runtime.py``'s ``tracked_jit``) arriving
  ``recompile_threshold`` times within ``recompile_window_s``. A compile
  per fresh bracket shape is BOHB-normal — the default threshold clears
  a healthy sweep's legitimate compile set (one per bracket shape, one
  per batch-pad size); the same function compiling past it means shapes
  are churning (a jit constructed in a loop, an unpadded batch) and XLA
  is eating the wall-clock the fused paths were supposed to save.
  Subjects key per fn (``tracked_jit`` events carry no budget); a
  foreign journal whose ``xla_compile`` records DO carry a ``budget``
  field gets per-(fn, budget) windows like the straggler rule.

The detector never raises into the bus (rule state is all stdlib), never
reacts to its own ``alert`` events, and rate-limits per (rule, subject)
via ``cooldown_s`` so one stuck worker cannot flood the journal.

Offline, :func:`scan_records` replays the same rules deterministically
over journal records — timestamps come from the records, not the wall
clock — which is how ``report`` synthesizes an alert digest for runs
that journaled without a live detector attached.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import statistics
import threading
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from hpbandster_tpu_torch.obs import events as E
from hpbandster_tpu_torch.obs.journal import event_to_record
from hpbandster_tpu_torch.obs.metrics import MetricsRegistry, get_metrics

__all__ = ["AnomalyRules", "AnomalyDetector", "scan_records"]

#: duration fields a record may carry, in stage-name terms: the master's
#: end-to-end run_s, the worker's compute_s, and any span's duration_s
#: (keyed by the span's event name)
_DURATION_FIELDS = ("run_s", "compute_s", "duration_s")


@dataclasses.dataclass(frozen=True)
class AnomalyRules:
    """Tuning knobs; defaults sized for minutes-scale HPO evaluations."""

    #: straggler: value > factor × rolling p95 of the same stage (the
    #: stage key includes the budget — multi-fidelity rungs never pool)
    straggler_factor: float = 3.0
    #: ... but only once the stage has this many samples (cold-start guard)
    straggler_min_samples: int = 20
    #: rolling window per stage (samples)
    straggler_window: int = 256
    #: p95 floor inside the threshold (factor × max(p95, floor)): a
    #: micro-duration baseline cannot flag trivial blips as "30×", while
    #: a genuinely huge outlier still fires
    straggler_floor_s: float = 0.05

    #: worker_flapping: this many drops of one worker within the window
    flap_threshold: int = 3
    flap_window_s: float = 600.0

    #: nan_burst: this many bad results within the last window results
    nan_burst_threshold: int = 5
    nan_burst_window: int = 32
    #: ... and the device-counter feed: a device_telemetry record fires
    #: nan_burst when its crashes reach the threshold AND this fraction
    #: of its evaluations (rate-gated: 5 crashes in a 100k-config sweep
    #: is healthy, 5 in 12 is not). 0 disables the device feed.
    nan_burst_device_rate: float = 0.25

    #: bracket_skew (device_telemetry records): fire when the max
    #: per-bracket crash count reaches `bracket_skew_min_crashes` and
    #: (max - median) / max over the per-bracket crash counts reaches
    #: `bracket_skew` — crashes concentrated in one bracket mean a
    #: broken budget rung, not a flaky objective. min_crashes=0 disables.
    bracket_skew: float = 0.5
    bracket_skew_min_crashes: int = 8

    #: kde_refit_stall: results since the last refit (0 disables)
    kde_stall_results: int = 64

    #: recompile_storm: this many xla_compile events for one fn subject
    #: within the window (0 disables; records carrying a budget field —
    #: foreign journals — key per (fn, budget)). The default clears a
    #: healthy sweep's LEGITIMATE compile set — one compile per bracket
    #: shape (max_SH_iter = 4 shapes at budgets 1..81) and per log2
    #: batch-pad size — while a loop-constructed wrapper blows past it
    recompile_threshold: int = 6
    recompile_window_s: float = 600.0

    #: fleet_imbalance: device_mem_skew >= this for `imbalance_consecutive`
    #: consecutive fleet_sample records (consecutive=0 disables). The
    #: default skew clears a ragged-but-working fleet (last bracket chunk
    #: pads unevenly) while a device holding ~everything fires
    imbalance_skew: float = 0.6
    imbalance_consecutive: int = 3

    #: worker_churn: fleet_sample worker_churn_per_min >= this (0
    #: disables) — drops + endpoint losses per minute, fleet-wide over
    #: the collector's fixed churn window (default 1.0 = ten churn
    #: events inside a 10-minute window)
    churn_per_min: float = 1.0

    #: per-(rule, subject) re-alert suppression
    cooldown_s: float = 60.0


class AnomalyDetector:
    """Bus sink / record processor implementing the rules above.

    ``bus=None`` (offline mode) collects alert records on ``.alerts``
    without emitting or counting; with a bus, every fired rule emits one
    ``alert`` event and increments ``anomaly.alerts`` plus
    ``anomaly.alerts.<rule>``.

    Thread-safe like every other sink (the bus delivers from whichever
    thread emitted — master, ping loop, and RPC handler threads all emit
    concurrently): rule state mutates under one internal RLock (re-entrant
    because firing an alert re-enters the sink via the bus before the
    ALERT-name guard can skip it). State is plain dicts/deques sized by
    the rule windows, so memory is bounded regardless of run length.
    """

    def __init__(
        self,
        rules: Optional[AnomalyRules] = None,
        bus: Optional[Any] = None,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.rules = rules or AnomalyRules()
        self._bus = bus
        self._registry = registry
        self._lock = threading.RLock()
        #: every alert this detector fired (record dicts, oldest first),
        #: bounded so a pathological run cannot grow it without limit
        self.alerts: Deque[Dict[str, Any]] = collections.deque(maxlen=256)
        self.alert_counts: Dict[str, int] = {}
        # rule state
        self._stage_windows: Dict[str, Deque[float]] = {}
        self._drop_times: Dict[str, Deque[float]] = {}
        self._result_window: Deque[int] = collections.deque(
            maxlen=max(int(self.rules.nan_burst_window), 1)
        )
        self._results_since_refit = 0
        self._refit_seen = False
        self._compile_times: Dict[str, Deque[float]] = {}
        self._imbalance_streak = 0
        self._last_alert: Dict[Tuple[str, str], float] = {}

    # ------------------------------------------------------------- plumbing
    def __call__(self, event: Any) -> None:
        """Bus-sink entry point; must never raise into the bus."""
        try:
            self.process(event_to_record(event))
        except Exception:
            E.logger.exception("anomaly detector failed on %r", event)

    def _fire(
        self, rec: Dict[str, Any], rule: str, subject: str, **detail: Any
    ) -> Optional[Dict[str, Any]]:
        now = rec.get("t_wall")
        now = float(now) if isinstance(now, (int, float)) else 0.0
        key = (rule, subject)
        last = self._last_alert.get(key)
        if last is not None and now - last < self.rules.cooldown_s:
            return None
        self._last_alert[key] = now
        if (
            rule == "straggler"
            and self._bus is not None  # offline replays must not pollute
            # the process ledger with a foreign journal's config ids
            and detail.get("config_id") is not None
        ):
            # close the anomaly -> scheduler loop: the flagged config id
            # rides its rung's next promotion_decision record as
            # `straggler_observed` (obs/audit.py ledger), so replays can
            # correlate stalls with promotion timing
            from hpbandster_tpu_torch.obs.audit import note_straggler

            note_straggler(
                detail.get("config_id"), budget=rec.get("budget")
            )
        alert = {
            "event": E.ALERT,
            "t_wall": now,
            "t_mono": rec.get("t_mono"),
            "rule": rule,
            "subject": subject,
            "source_event": rec.get("event"),
            **detail,
        }
        self.alerts.append(alert)
        self.alert_counts[rule] = self.alert_counts.get(rule, 0) + 1
        if self._bus is not None:
            reg = self._registry if self._registry is not None else get_metrics()
            reg.counter("anomaly.alerts").inc()
            reg.counter(f"anomaly.alerts.{rule}").inc()
            self._bus.emit(
                E.ALERT,
                rule=rule, subject=subject,
                source_event=rec.get("event"),
                **detail,
            )
        return alert

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable detector state for the health endpoint."""
        with self._lock:
            return {
                "total": sum(self.alert_counts.values()),
                "by_rule": dict(sorted(self.alert_counts.items())),
                "recent": list(self.alerts)[-8:],
            }

    # ----------------------------------------------------------------- rules
    def process(self, rec: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Run every rule over one journal-schema record; returns the
        alerts fired (already emitted/counted when a bus is attached)."""
        name = rec.get("event")
        if not name or name == E.ALERT:
            return []
        with self._lock:
            return self._process_locked(rec, name)

    def _process_locked(
        self, rec: Dict[str, Any], name: str
    ) -> List[Dict[str, Any]]:
        fired: List[Dict[str, Any]] = []
        r = self.rules

        # --- straggler: per-stage rolling p95. The window keys include
        # the budget: a budget-9 evaluation is ~9x a budget-1 one by
        # DESIGN in a multi-fidelity sweep, and pooling them would fire
        # a false alert at every rung transition.
        for field in _DURATION_FIELDS:
            v = rec.get(field)
            if not isinstance(v, (int, float)) or not math.isfinite(v):
                continue
            budget = rec.get("budget")
            stage = f"{name}.{field}" + (
                f"@{budget:g}" if isinstance(budget, (int, float)) else ""
            )
            win = self._stage_windows.get(stage)
            if win is None:
                win = self._stage_windows[stage] = collections.deque(
                    maxlen=max(int(r.straggler_window), 2)
                )
            if len(win) >= r.straggler_min_samples:
                ordered = sorted(win)
                p95 = ordered[min(
                    int(round(0.95 * (len(ordered) - 1))), len(ordered) - 1
                )]
                # the floor enters the THRESHOLD: a baseline of micro
                # durations (p95 ~2ms) must not flag a trivial 60ms blip
                # at "30x", yet a genuinely huge outlier still fires
                cut = r.straggler_factor * max(p95, r.straggler_floor_s)
                if v > cut:
                    a = self._fire(
                        rec, "straggler", stage,
                        value_s=round(float(v), 6),
                        p95_s=round(float(p95), 6),
                        # a 0.0 baseline (sub-microsecond stage) has no
                        # meaningful ratio; the floor-based cut still fired
                        factor=round(float(v) / p95, 2) if p95 > 0 else None,
                        worker=rec.get("worker"),
                        config_id=rec.get("config_id"),
                    )
                    if a:
                        fired.append(a)
            win.append(float(v))

        # --- worker flapping: repeated drops of one worker
        if name == E.WORKER_DROPPED:
            worker = str(rec.get("worker") or "?")
            tw = rec.get("t_wall")
            tw = float(tw) if isinstance(tw, (int, float)) else 0.0
            times = self._drop_times.setdefault(
                worker, collections.deque(maxlen=max(int(r.flap_threshold), 1) * 4)
            )
            times.append(tw)
            recent = [t for t in times if tw - t <= r.flap_window_s]
            if len(recent) >= r.flap_threshold:
                a = self._fire(
                    rec, "worker_flapping", worker,
                    drops=len(recent), window_s=r.flap_window_s,
                )
                if a:
                    fired.append(a)

        # --- result-driven rules (the loss-carrying record is the master
        # funnel's / fused replay's — exactly one per job, so counting
        # those avoids double-counting the worker-side twins)
        if name in (E.JOB_FINISHED, E.JOB_FAILED) and "loss" in rec:
            loss = rec.get("loss")
            # bad = failed, OR no finite loss: the emitters journal any
            # non-finite (NaN/inf-diverged) loss as null for strict JSON,
            # so null on a loss-carrying record IS the divergence signal
            # (the isfinite check additionally covers foreign journals
            # that wrote raw non-finite values)
            bad = name == E.JOB_FAILED or loss is None or (
                isinstance(loss, (int, float)) and not math.isfinite(loss)
            )
            self._result_window.append(1 if bad else 0)
            if (
                sum(self._result_window) >= r.nan_burst_threshold
                and len(self._result_window) > 0
            ):
                a = self._fire(
                    rec, "nan_burst", "losses",
                    bad_results=sum(self._result_window),
                    window=self._result_window.maxlen,
                    config_id=rec.get("config_id"),
                )
                if a:
                    fired.append(a)
                    self._result_window.clear()
            if r.kde_stall_results > 0 and self._refit_seen:
                self._results_since_refit += 1
                if self._results_since_refit > r.kde_stall_results:
                    a = self._fire(
                        rec, "kde_refit_stall", "kde",
                        results_since_refit=self._results_since_refit,
                        stall_after=r.kde_stall_results,
                    )
                    if a:
                        fired.append(a)
                        self._results_since_refit = 0
        elif name == E.KDE_REFIT:
            self._refit_seen = True
            self._results_since_refit = 0

        # --- device-counter feeds: a fused/resident sweep journals ONE
        # device_telemetry record instead of per-job events, so the
        # result-shaped rules read its decoded crash counters directly.
        if name == E.DEVICE_TELEMETRY:
            crashes = rec.get("crashes")
            evals = rec.get("evaluations")
            if (
                r.nan_burst_device_rate > 0
                and isinstance(crashes, (int, float))
                and isinstance(evals, (int, float)) and evals > 0
                and crashes >= r.nan_burst_threshold
                and crashes / evals >= r.nan_burst_device_rate
            ):
                a = self._fire(
                    rec, "nan_burst", "device",
                    bad_results=int(crashes),
                    evaluations=int(evals),
                    crash_rate=round(float(crashes) / float(evals), 4),
                )
                if a:
                    fired.append(a)
            per_bracket = rec.get("per_bracket_crashes")
            if (
                r.bracket_skew_min_crashes > 0
                and isinstance(per_bracket, list) and len(per_bracket) >= 2
                and all(
                    isinstance(c, (int, float)) and not isinstance(c, bool)
                    for c in per_bracket
                )
            ):
                counts = [float(c) for c in per_bracket]
                hi = max(counts)
                # true median (statistics.median interpolates even
                # lengths) — the upper-middle element would understate
                # the skew for even bracket counts and silently disable
                # the rule on symmetric crash splits
                median = statistics.median(counts)
                skew = 0.0 if hi <= 0 else (hi - median) / hi
                if hi >= r.bracket_skew_min_crashes and skew >= r.bracket_skew:
                    worst = max(
                        range(len(per_bracket)),
                        key=lambda i: float(per_bracket[i]),
                    )
                    a = self._fire(
                        rec, "bracket_skew", f"bracket{worst}",
                        max_crashes=int(hi),
                        median_crashes=round(median, 1),
                        skew=round(skew, 4),
                        threshold=r.bracket_skew,
                    )
                    if a:
                        fired.append(a)

        # --- recompile storm: one function's tracked_jit boundary keeps
        # compiling. Subjects key per fn (tracked_jit events carry no
        # budget; a foreign record that does gets (fn, budget) windows
        # like the straggler rule): a bounded compile set — one per
        # bracket shape / pad size — stays under the threshold by
        # design; the SAME subject churning past it is the incident.
        if name == E.XLA_COMPILE and r.recompile_threshold > 0:
            fn = str(rec.get("fn") or "?")
            budget = rec.get("budget")
            subject = fn + (
                f"@{budget:g}" if isinstance(budget, (int, float)) else ""
            )
            tw = rec.get("t_wall")
            tw = float(tw) if isinstance(tw, (int, float)) else 0.0
            times = self._compile_times.setdefault(
                subject,
                collections.deque(maxlen=max(int(r.recompile_threshold), 1) * 4),
            )
            times.append(tw)
            recent = [t for t in times if tw - t <= r.recompile_window_s]
            if len(recent) >= r.recompile_threshold:
                a = self._fire(
                    rec, "recompile_storm", subject,
                    compiles=len(recent), window_s=r.recompile_window_s,
                    compile_s=rec.get("compile_s"),
                    signature=rec.get("signature"),
                )
                if a:
                    fired.append(a)

        # --- fleet rules: the collector's derived gauges. Live samples
        # arrive flattened on the bus event; series-file lines nest them
        # under "fleet" — both shapes are read, which is what keeps
        # scan_records over a series file in parity with the live sink.
        if name == E.FLEET_SAMPLE:
            fleet = rec.get("fleet")
            if not isinstance(fleet, dict):
                fleet = rec
            skew = fleet.get("device_mem_skew")
            if r.imbalance_consecutive > 0:
                if (
                    isinstance(skew, (int, float)) and math.isfinite(skew)
                    and skew >= r.imbalance_skew
                ):
                    self._imbalance_streak += 1
                    if self._imbalance_streak >= r.imbalance_consecutive:
                        a = self._fire(
                            rec, "fleet_imbalance", "devices",
                            skew=round(float(skew), 4),
                            threshold=r.imbalance_skew,
                            consecutive=self._imbalance_streak,
                        )
                        if a:
                            fired.append(a)
                            self._imbalance_streak = 0
                else:
                    self._imbalance_streak = 0
            churn = fleet.get("worker_churn_per_min")
            if (
                r.churn_per_min > 0
                and isinstance(churn, (int, float)) and math.isfinite(churn)
                and churn >= r.churn_per_min
            ):
                a = self._fire(
                    rec, "worker_churn", "fleet",
                    churn_per_min=round(float(churn), 4),
                    threshold=r.churn_per_min,
                    lost_endpoints=fleet.get("lost"),
                    churn_events=fleet.get("churn_events"),
                )
                if a:
                    fired.append(a)

        return fired


def scan_records(
    records: List[Dict[str, Any]],
    rules: Optional[AnomalyRules] = None,
) -> List[Dict[str, Any]]:
    """Offline, deterministic replay of the rules over journal records.

    No bus, no metrics, no wall clock — alerts are stamped with the
    triggering record's ``t_wall``/``t_mono``, so two scans of the same
    journal produce identical output (the report CLI's determinism bar).
    """
    det = AnomalyDetector(rules=rules, bus=None)
    out: List[Dict[str, Any]] = []
    for rec in records:
        out.extend(det.process(rec))
    return out
