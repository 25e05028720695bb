"""Declarative SLOs over the journal-record planes: specs + burn-rate math.

Ported from ``hpbandster_tpu/obs/slo.py`` (a copy).

An :class:`SLOSpec` declares an objective (a good/total ratio target)
over the same journal-schema records ``summarize``/``replay`` already
consume, and :class:`SLOEvaluator` turns the record stream into
multi-window multi-burn-rate measurements — the SRE discipline (fast
5m/1h windows page, slow 6h/3d windows ticket) applied to an HPO fleet,
where HyperBand's budget framing already *is* an error-budget problem.

Four objective shapes, all reducing to per-record ``(good, bad)``
increments so one window engine serves them all:

* **ratio** — ``total`` selects the units of work; ``bad`` selects the
  failures from a *separate* record stream (``rpc_client_call`` total
  vs ``rpc_retry`` bad);
* **threshold** — ``total`` selects the units; each is good when
  ``good_when`` also matches it (``serve_admission`` records with
  ``wait_s <= 0.25``) — how a latency-percentile objective ("admission
  p95 <= 250 ms" == "95% of admissions under 250 ms") is declared;
* **counter** — one record carries the counts: ``total_field`` /
  ``bad_field`` read pre-aggregated tallies off it (a
  ``device_telemetry`` record's ``evaluations``/``crashes``, the only
  per-evaluation signal a fused sweep surfaces);
* **staleness** — ``fresh`` marks the signal being kept fresh
  (``kde_refit``), ``total`` probes it (every chunk record): a probe is
  good while the last fresh mark is at most ``max_age_s`` old.

Burn rate = (bad/total over a window) / (1 - objective): 1.0 burns the
error budget exactly at the objective's allowed rate; 14.4 exhausts a
3-day budget in 5 hours (the classic page threshold). A severity fires
only when BOTH its windows burn — the long window proves the problem is
real, the short window proves it is *still happening*.

Everything here is pure record math: no clocks (timestamps come from the
records' ``t_wall``), no locks, no bus, no registry — which is what lets
``obs slo --journal`` re-evaluate a journaled run **byte-identically**
offline (the discipline :mod:`hpbandster_tpu_torch.obs.anomaly` set). The
lifecycle/journaling half lives in :mod:`hpbandster_tpu_torch.obs.alerts`.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple, Union

__all__ = [
    "Selector",
    "BurnWindow",
    "SLOSpec",
    "SLOEvaluator",
    "DEFAULT_WINDOWS",
    "default_slo_pack",
]

#: hard cap per window deque: bounded memory regardless of record rate,
#: identical live and offline (a cap that only one side applied would
#: break replay parity)
_WINDOW_CAP = 65536


def _num(x: Any) -> Optional[float]:
    """Finite number or None; bools are not measurements."""
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        return None
    v = float(x)
    return v if math.isfinite(v) else None


@dataclasses.dataclass(frozen=True)
class Selector:
    """Declarative record predicate: event name(s) + field constraints.

    ``event`` matches the record's ``event`` (a tuple means any-of);
    ``where`` is a tuple of ``(field, value)`` equality constraints;
    ``field`` + ``le``/``ge`` bound a numeric field (a non-numeric or
    missing value fails the bound — absence of evidence is not good
    service). All parts must hold.
    """

    event: Union[str, Tuple[str, ...], None] = None
    where: Tuple[Tuple[str, Any], ...] = ()
    field: Optional[str] = None
    le: Optional[float] = None
    ge: Optional[float] = None

    def matches(self, rec: Dict[str, Any]) -> bool:
        if self.event is not None:
            name = rec.get("event")
            if isinstance(self.event, tuple):
                if name not in self.event:
                    return False
            elif name != self.event:
                return False
        for key, want in self.where:
            if rec.get(key) != want:
                return False
        if self.field is not None:
            v = _num(rec.get(self.field))
            if v is None:
                return False
            if self.le is not None and v > self.le:
                return False
            if self.ge is not None and v < self.ge:
                return False
        return True


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One multi-window burn condition: fire at ``burn``× budget rate
    sustained over BOTH windows (long proves it, short confirms it is
    current)."""

    short_s: float
    long_s: float
    burn: float
    severity: str


#: the SRE standard pair: page on a fast burn (5m/1h at 14.4x — a 3-day
#: budget gone in 5 hours), ticket on a slow one (6h/3d at 1.0x — any
#: sustained burn that will exhaust the budget within its window)
DEFAULT_WINDOWS: Tuple[BurnWindow, ...] = (
    BurnWindow(short_s=300.0, long_s=3600.0, burn=14.4, severity="page"),
    BurnWindow(short_s=21600.0, long_s=259200.0, burn=1.0,
               severity="ticket"),
)


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declared objective over the record stream.

    Exactly one objective shape applies (checked at construction):
    ``bad`` (ratio), ``good_when`` (threshold), ``total_field`` +
    ``bad_field`` (counter), or ``fresh`` + ``max_age_s`` (staleness);
    ``total`` always selects the units of work / probes.
    """

    name: str
    objective: float
    total: Selector
    description: str = ""
    bad: Optional[Selector] = None
    good_when: Optional[Selector] = None
    total_field: Optional[str] = None
    bad_field: Optional[str] = None
    fresh: Optional[Selector] = None
    max_age_s: Optional[float] = None
    windows: Tuple[BurnWindow, ...] = DEFAULT_WINDOWS
    #: the error-budget accounting window (budget_remaining's horizon);
    #: defaults to the longest declared burn window
    budget_window_s: Optional[float] = None
    #: hysteresis: a breach must hold this long before firing ...
    for_s: float = 0.0
    #: ... and must stay clear this long before resolving (flap damping)
    clear_for_s: float = 120.0

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"slo {self.name!r}: objective must be in (0, 1), "
                f"got {self.objective!r}"
            )
        shapes = [
            self.bad is not None,
            self.good_when is not None,
            self.total_field is not None or self.bad_field is not None,
            self.fresh is not None or self.max_age_s is not None,
        ]
        if sum(shapes) != 1:
            raise ValueError(
                f"slo {self.name!r}: declare exactly one objective shape "
                "(bad | good_when | total_field+bad_field | "
                "fresh+max_age_s)"
            )
        if shapes[2] and (self.total_field is None or self.bad_field is None):
            raise ValueError(
                f"slo {self.name!r}: counter form needs BOTH total_field "
                "and bad_field"
            )
        if shapes[3] and (self.fresh is None or self.max_age_s is None):
            raise ValueError(
                f"slo {self.name!r}: staleness form needs BOTH fresh "
                "and max_age_s"
            )
        if not self.windows:
            raise ValueError(f"slo {self.name!r}: at least one BurnWindow")

    @property
    def budget_horizon_s(self) -> float:
        if self.budget_window_s is not None:
            return float(self.budget_window_s)
        return max(w.long_s for w in self.windows)


class _Window:
    """One sliding window's running good/bad tallies.

    Increments append with their record time; pruning walks the deque
    head (amortized O(1)) against the newest time seen. The hard cap
    drops the oldest increment when full — same cap live and offline,
    so replay parity survives pathological rates.
    """

    __slots__ = ("span_s", "items", "good", "bad")

    def __init__(self, span_s: float):
        self.span_s = float(span_s)
        self.items: Deque[Tuple[float, float, float]] = collections.deque()
        self.good = 0.0
        self.bad = 0.0

    def add(self, t: float, good: float, bad: float) -> None:
        if len(self.items) >= _WINDOW_CAP:
            self._drop()
        self.items.append((t, good, bad))
        self.good += good
        self.bad += bad

    def _drop(self) -> None:
        _t, g, b = self.items.popleft()
        self.good -= g
        self.bad -= b

    def prune(self, now: float) -> None:
        cutoff = now - self.span_s
        items = self.items
        while items and items[0][0] < cutoff:
            self._drop()

    @property
    def total(self) -> float:
        return self.good + self.bad

    def error_rate(self) -> Optional[float]:
        total = self.good + self.bad
        if total <= 0:
            return None
        return self.bad / total


class _SpecState:
    """Per-spec window set + staleness bookkeeping."""

    __slots__ = ("spec", "windows", "budget", "last_fresh_t", "first_probe_t")

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        spans = []
        for w in spec.windows:
            for s in (w.short_s, w.long_s):
                if s not in spans:
                    spans.append(s)
        self.windows: Dict[float, _Window] = {s: _Window(s) for s in spans}
        self.budget = _Window(spec.budget_horizon_s)
        self.last_fresh_t: Optional[float] = None
        self.first_probe_t: Optional[float] = None

    # ------------------------------------------------------------ classify
    def classify(self, rec: Dict[str, Any]) -> Optional[Tuple[float, float]]:
        """``(good, bad)`` increments this record contributes, or None."""
        spec = self.spec
        if spec.bad is not None:
            if spec.bad.matches(rec):
                return (0.0, 1.0)
            if spec.total.matches(rec):
                return (1.0, 0.0)
            return None
        if spec.good_when is not None:
            if not spec.total.matches(rec):
                return None
            return (1.0, 0.0) if spec.good_when.matches(rec) else (0.0, 1.0)
        if spec.total_field is not None:
            if not spec.total.matches(rec):
                return None
            total = _num(rec.get(spec.total_field)) or 0.0
            bad = _num(rec.get(spec.bad_field)) or 0.0
            bad = min(max(bad, 0.0), max(total, 0.0))
            if total <= 0:
                return None
            return (total - bad, bad)
        # staleness: fresh marks reset the age clock; probes judge it
        t = _num(rec.get("t_wall"))
        if spec.fresh is not None and spec.fresh.matches(rec):
            if t is not None:
                self.last_fresh_t = t
            return None
        if not spec.total.matches(rec) or t is None:
            return None
        if self.first_probe_t is None:
            self.first_probe_t = t
        baseline = (
            self.last_fresh_t
            if self.last_fresh_t is not None else self.first_probe_t
        )
        age = t - baseline
        ok = age <= float(spec.max_age_s or 0.0)
        return (1.0, 0.0) if ok else (0.0, 1.0)

    # ------------------------------------------------------------- measure
    def add(self, t: float, good: float, bad: float) -> None:
        for win in self.windows.values():
            win.add(t, good, bad)
        self.budget.add(t, good, bad)

    def measure(self, now: float) -> Dict[str, Any]:
        """Burn rates / budget at ``now`` (a record's time, never a
        clock). All floats round to 6 places — the byte-stability
        contract the replay parity check rides on."""
        spec = self.spec
        allowed = 1.0 - spec.objective
        for win in self.windows.values():
            win.prune(now)
        self.budget.prune(now)

        def burn(span_s: float) -> Optional[float]:
            rate = self.windows[span_s].error_rate()
            if rate is None:
                return None
            return round(rate / allowed, 6)

        severities: Dict[str, Dict[str, Any]] = {}
        worst: Optional[float] = None
        for w in spec.windows:
            b_short, b_long = burn(w.short_s), burn(w.long_s)
            breached = (
                b_short is not None and b_long is not None
                and b_short >= w.burn and b_long >= w.burn
            )
            severities[w.severity] = {
                "burn_short": b_short,
                "burn_long": b_long,
                "threshold": w.burn,
                "breached": breached,
            }
            for b in (b_short, b_long):
                if b is not None and (worst is None or b > worst):
                    worst = b
        total = self.budget.total
        if total > 0:
            spent = self.budget.bad / (total * allowed)
            remaining = round(1.0 - spent, 6)
        else:
            remaining = 1.0
        return {
            "slo": spec.name,
            "objective": spec.objective,
            "burn_rate": worst,
            "budget_remaining": remaining,
            "severities": severities,
            "window_total": round(total, 6),
        }


class SLOEvaluator:
    """Pure record-stream evaluator for a pack of specs.

    ``update(rec)`` feeds one journal-schema record to every spec and
    returns the measurements of the specs the record touched. No clocks,
    no locks, no I/O: callers that need thread safety (the live bus
    sink) or side effects (gauges, journaled transitions) wrap it —
    :class:`hpbandster_tpu_torch.obs.alerts.AlertManager` is that wrapper.
    """

    def __init__(self, specs: Sequence[SLOSpec]):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate slo names: {sorted(names)}")
        self.states: Dict[str, _SpecState] = {
            s.name: _SpecState(s) for s in specs
        }
        self.last_t: Optional[float] = None

    @property
    def specs(self) -> List[SLOSpec]:
        return [st.spec for st in self.states.values()]

    def update(self, rec: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Process one record; returns measurements for touched specs."""
        t = _num(rec.get("t_wall"))
        if t is None:
            return []
        # merged multi-process journals can interleave slightly out of
        # order; the window engine needs a non-decreasing "now"
        if self.last_t is None or t > self.last_t:
            self.last_t = t
        now = self.last_t
        out: List[Dict[str, Any]] = []
        for state in self.states.values():
            inc = state.classify(rec)
            if inc is None:
                continue
            state.add(now, inc[0], inc[1])
            out.append(state.measure(now))
        return out

    def measure_all(self) -> List[Dict[str, Any]]:
        """Measurements for every spec at the last seen record time."""
        if self.last_t is None:
            return [
                st.measure(0.0) for st in self.states.values()
            ]
        return [st.measure(self.last_t) for st in self.states.values()]


def default_slo_pack() -> List[SLOSpec]:
    """The fleet's stock objectives, wired to signals the serve tier and
    sweeps already journal (docs/observability.md "SLOs &
    alerting" carries the same table):

    * ``serve_admission`` — 95% of admissions reach dispatch within
      250 ms (``serve_admission`` records, ``serve/pool.py``): the
      continuous-batching latency claim as an objective;
    * ``lane_starvation`` — 99% of serve chunks run with zero starved
      lanes (``serve_chunk`` records, ``serve/continuous.py``);
    * ``tenant_auth_rejects`` — 99% of authenticated frontend calls
      succeed (``tenant_auth`` records, ``serve/frontend.py``): a
      sustained reject rate is a brute-force probe or a rotated key;
    * ``device_crash_rate`` — 95% of device evaluations finish finite
      (``device_telemetry`` counter records — the fused tier's only
      per-evaluation feed, rung tallies included);
    * ``rpc_retry_rate`` — 99% of client RPCs land without a retry
      (``rpc_client_call`` total vs ``rpc_retry`` bad);
    * ``kde_refit_staleness`` — 95% of sweep/serve chunks run with a
      model refit at most 10 minutes old: the optimizer silently
      degrading to random search is an SLO breach, not a curiosity.
    """
    return [
        SLOSpec(
            name="serve_admission",
            description="admission -> dispatch within 250ms (p95)",
            objective=0.95,
            total=Selector(event="serve_admission"),
            good_when=Selector(field="wait_s", le=0.25),
        ),
        SLOSpec(
            name="lane_starvation",
            description="serve chunks with zero starved lanes",
            objective=0.99,
            total=Selector(event="serve_chunk"),
            good_when=Selector(field="starved", le=0.0),
        ),
        SLOSpec(
            name="tenant_auth_rejects",
            description="frontend calls passing tenant auth",
            objective=0.99,
            total=Selector(event="tenant_auth"),
            good_when=Selector(where=(("ok", True),)),
        ),
        SLOSpec(
            name="device_crash_rate",
            description="device evaluations finishing finite (per rung "
                        "tallies ride the same records)",
            objective=0.95,
            total=Selector(event="device_telemetry"),
            total_field="evaluations",
            bad_field="crashes",
        ),
        SLOSpec(
            name="rpc_retry_rate",
            description="client RPCs landing without a retry",
            objective=0.99,
            total=Selector(event="rpc_client_call"),
            bad=Selector(event="rpc_retry"),
        ),
        SLOSpec(
            name="kde_refit_staleness",
            description="chunks running with a fresh model fit "
                        "(<= 10 min old)",
            objective=0.95,
            total=Selector(event=("sweep_chunk", "serve_chunk")),
            fresh=Selector(event="kde_refit"),
            max_age_s=600.0,
        ),
    ]
