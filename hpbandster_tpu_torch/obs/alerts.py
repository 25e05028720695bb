"""SLO alert lifecycle over the event bus: pending -> firing -> resolved.

Ported from ``hpbandster_tpu/obs/alerts.py`` (a copy).

:class:`AlertManager` is an ordinary bus sink (subscribe it, or let
``obs.configure(slo=True)`` do it) wrapping the pure
:class:`hpbandster_tpu_torch.obs.slo.SLOEvaluator`: every record feeds the
burn-rate windows, and each (spec, severity) pair runs a small state
machine with hysteresis —

* **ok -> pending** when the burn condition breaches and the spec
  declares a ``for_s`` hold (breaches shorter than the hold resolve
  silently back to ok: no journal noise for a single hot window);
* **pending -> firing** once the breach has held ``for_s`` (specs with
  ``for_s=0`` skip pending and fire immediately);
* **firing -> resolved** only after the condition has stayed clear for
  ``clear_for_s`` — a flapping signal that re-breaches inside the hold
  resets the clear timer and yields ONE firing -> resolved cycle, not a
  page storm. Re-breaches while firing are deduped by ``key``
  (``<slo>:<severity>``), the same suppression idea as the anomaly
  detector's per-(rule, subject) cooldown but stateful: an alert that
  never resolves never re-fires.

Each transition is appended to :attr:`AlertManager.transitions` (a
record dict stamped with the *triggering record's* time, never a clock)
and — live only — journaled as one ``slo_alert`` event, counted on
``alert.transitions*``, and reflected into the
``slo.<name>.{burn_rate,budget_remaining,state}`` / ``alert.firing``
gauges the collector and exporter read. Offline (``bus=None``,
:func:`scan_slo_records`) the same code path collects transitions and
:meth:`AlertManager.published` values without emitting or counting,
which is what makes ``obs slo --journal`` replay a journaled run
**byte-identically**: live manager and offline scan are the same object
fed the same records.

The manager never raises into the bus, never reacts to its own
``slo_alert`` events (or the anomaly detector's ``alert``s — alerting
on alerts is a feedback loop), and holds one internal RLock (re-entrant
because emitting a transition re-enters the sink via the bus before the
name guard can skip it).
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Deque, Dict, List, Optional, Sequence

from hpbandster_tpu_torch.obs import events as E
from hpbandster_tpu_torch.obs.journal import event_to_record
from hpbandster_tpu_torch.obs.metrics import MetricsRegistry, get_metrics
from hpbandster_tpu_torch.obs.slo import SLOEvaluator, SLOSpec, default_slo_pack

__all__ = ["AlertManager", "scan_slo_records", "STATE_CODES"]

#: the ``slo.<name>.state`` gauge encoding (max over the spec's
#: severities): the collector's fleet rollup and ``watch`` rows decode
#: it with the same table
STATE_CODES = {"ok": 0, "pending": 1, "firing": 2}


class AlertManager:
    """Bus sink owning SLO evaluation + alert lifecycle.

    ``bus=None`` (offline mode) collects transitions and published
    values without emitting or counting; with a bus, every transition
    emits one ``slo_alert`` event, increments ``alert.transitions`` plus
    ``alert.transitions.<slo>``, and refreshes the SLO gauges.
    """

    def __init__(
        self,
        specs: Optional[Sequence[SLOSpec]] = None,
        bus: Optional[Any] = None,
        registry: Optional[MetricsRegistry] = None,
    ):
        self._eval = SLOEvaluator(
            list(specs) if specs is not None else default_slo_pack()
        )
        self._bus = bus
        self._registry = registry
        self._lock = threading.RLock()
        #: every lifecycle transition (record dicts, oldest first),
        #: bounded so a pathological run cannot grow it without limit
        self.transitions: Deque[Dict[str, Any]] = collections.deque(
            maxlen=256
        )
        self.transition_counts: Dict[str, int] = {}
        # (slo, severity) -> {"state", "since", "clear_start"}
        self._life: Dict[Any, Dict[str, Any]] = {}
        self._firing: set = set()
        #: per-spec last gauge values (live == what the registry holds;
        #: offline == what it WOULD hold) — the replay-parity surface
        self._last_published: Dict[str, Dict[str, Any]] = {}

    @property
    def specs(self) -> List[SLOSpec]:
        return self._eval.specs

    # ------------------------------------------------------------- plumbing
    def __call__(self, event: Any) -> None:
        """Bus-sink entry point; must never raise into the bus."""
        try:
            self.process(event_to_record(event))
        except Exception:
            E.logger.exception("alert manager failed on %r", event)

    def process(self, rec: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Feed one journal-schema record; returns the transitions it
        caused (already emitted/counted when a bus is attached)."""
        name = rec.get("event")
        if not name or name in (E.SLO_ALERT, E.ALERT):
            return []
        with self._lock:
            return self._process_locked(rec)

    def _process_locked(self, rec: Dict[str, Any]) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        measured = self._eval.update(rec)
        if not measured:
            return out
        now = self._eval.last_t or 0.0
        for meas in measured:
            spec = self._eval.states[meas["slo"]].spec
            out.extend(self._lifecycle(spec, meas, rec, now))
            self._publish(spec, meas)
        return out

    # ------------------------------------------------------------ lifecycle
    def _lifecycle(
        self,
        spec: SLOSpec,
        meas: Dict[str, Any],
        rec: Dict[str, Any],
        now: float,
    ) -> List[Dict[str, Any]]:
        fired: List[Dict[str, Any]] = []
        for w in spec.windows:
            sev = w.severity
            key = (spec.name, sev)
            life = self._life.setdefault(
                key, {"state": "ok", "since": now, "clear_start": None}
            )
            breached = meas["severities"][sev]["breached"]
            if breached:
                # any re-breach resets the resolve hold: flapping inside
                # clear_for_s stays ONE firing episode
                life["clear_start"] = None
                if life["state"] == "ok":
                    nxt = "pending" if spec.for_s > 0 else "firing"
                    life["state"], life["since"] = nxt, now
                    fired.append(
                        self._transition(spec, sev, nxt, meas, rec, now)
                    )
                elif (
                    life["state"] == "pending"
                    and now - life["since"] >= spec.for_s
                ):
                    life["state"], life["since"] = "firing", now
                    fired.append(
                        self._transition(spec, sev, "firing", meas, rec, now)
                    )
            else:
                if life["state"] == "pending":
                    # never fired: drop back silently (no transition —
                    # pending exists exactly to absorb this)
                    life["state"], life["since"] = "ok", now
                elif life["state"] == "firing":
                    if life["clear_start"] is None:
                        life["clear_start"] = now
                    elif now - life["clear_start"] >= spec.clear_for_s:
                        life["state"], life["since"] = "ok", now
                        life["clear_start"] = None
                        fired.append(
                            self._transition(
                                spec, sev, "resolved", meas, rec, now
                            )
                        )
            if life["state"] == "firing":
                self._firing.add(key)
            else:
                self._firing.discard(key)
        return fired

    def _transition(
        self,
        spec: SLOSpec,
        severity: str,
        state: str,
        meas: Dict[str, Any],
        rec: Dict[str, Any],
        now: float,
    ) -> Dict[str, Any]:
        info = meas["severities"][severity]
        dedup = f"{spec.name}:{severity}"
        tr = {
            "event": E.SLO_ALERT,
            # the triggering record's time, not a clock: offline replay
            # of the same journal rebuilds this dict byte-identically
            "t_wall": now,
            "t_mono": rec.get("t_mono"),
            "slo": spec.name,
            "severity": severity,
            "state": state,
            "burn_short": info["burn_short"],
            "burn_long": info["burn_long"],
            "budget_remaining": meas["budget_remaining"],
            "key": dedup,
        }
        self.transitions.append(tr)
        self.transition_counts[spec.name] = (
            self.transition_counts.get(spec.name, 0) + 1
        )
        if self._bus is not None:
            reg = (
                self._registry if self._registry is not None else get_metrics()
            )
            reg.counter("alert.transitions").inc()
            reg.counter(f"alert.transitions.{spec.name}").inc()
            # reserved envelope fields (t_wall/t_mono/...) stay OFF the
            # emit — the bus stamps its own; the transition dict above is
            # the journaled-record-shaped twin
            self._bus.emit(
                E.SLO_ALERT,
                slo=spec.name,
                severity=severity,
                state=state,
                burn_short=info["burn_short"],
                burn_long=info["burn_long"],
                budget_remaining=meas["budget_remaining"],
                key=dedup,
            )
        return tr

    # ------------------------------------------------------------- publish
    def _state_code(self, name: str) -> int:
        code = 0
        for (slo, _sev), life in self._life.items():
            if slo == name:
                code = max(code, STATE_CODES.get(life["state"], 0))
        return code

    def _publish(self, spec: SLOSpec, meas: Dict[str, Any]) -> None:
        pub = {
            "burn_rate": meas["burn_rate"],
            "budget_remaining": meas["budget_remaining"],
            "state": self._state_code(spec.name),
        }
        self._last_published[spec.name] = pub
        if self._bus is None:
            return
        reg = self._registry if self._registry is not None else get_metrics()
        name = spec.name
        if pub["burn_rate"] is not None:
            reg.gauge(f"slo.{name}.burn_rate").set(float(pub["burn_rate"]))
        reg.gauge(f"slo.{name}.budget_remaining").set(
            float(pub["budget_remaining"])
        )
        reg.gauge(f"slo.{name}.state").set(float(pub["state"]))
        reg.gauge("alert.firing").set(float(len(self._firing)))

    def published(self) -> Dict[str, Dict[str, Any]]:
        """Last per-spec gauge values — compare a live manager's against
        an offline scan's for replay parity."""
        with self._lock:
            return {k: dict(v) for k, v in self._last_published.items()}

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable manager state for the health endpoint."""
        with self._lock:
            rates = [
                p["burn_rate"]
                for p in self._last_published.values()
                if p["burn_rate"] is not None
            ]
            return {
                "specs": [s.name for s in self._eval.specs],
                "firing": len(self._firing),
                "worst_burn_rate": max(rates) if rates else None,
                "by_slo": {
                    k: dict(v)
                    for k, v in sorted(self._last_published.items())
                },
                "recent": list(self.transitions)[-8:],
            }


def scan_slo_records(
    records: Sequence[Dict[str, Any]],
    specs: Optional[Sequence[SLOSpec]] = None,
) -> AlertManager:
    """Offline, deterministic replay of the SLO pack over journal records.

    No bus, no metrics, no wall clock — returns the fed manager so the
    caller can read :attr:`AlertManager.transitions` AND
    :meth:`AlertManager.published` (both halves of the live==offline
    parity check ``obs slo`` performs). ``slo_alert``/``alert`` records
    already in the journal are skipped by :meth:`AlertManager.process`,
    so replaying a live-journaled run does not double-feed its own
    output.
    """
    mgr = AlertManager(specs=specs, bus=None)
    for rec in records:
        mgr.process(rec)
    return mgr
