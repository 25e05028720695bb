"""Optimizer decision audit: why did BOHB do what it did?

Ported from ``hpbandster_tpu/obs/audit.py`` (a copy). The bus and the
journal make the *infrastructure* observable; this module makes the
*algorithm* observable. Two record kinds ride the existing JSONL journal
schema (``docs/observability.md`` "Optimizer decision audit"):

* ``config_sampled`` — one record per config entering a bracket, emitted
  by :meth:`core.iteration.BaseIteration.add_configuration` (the one
  place a config receives its id). The decision details come from the
  config generator's info dict: was the pick model-based or random (and
  WHY random — no trained model yet vs the ``random_fraction`` coin vs a
  model failure), which budget's KDE proposed it, how many observations
  that model had, and the winning ``log l(x) - log g(x)`` acquisition
  score (BOHB §3, Falkner et al. 2018).
* ``promotion_decision`` — one record per rung advancement, emitted by
  :meth:`core.iteration.BaseIteration.process_results`: the rung, its
  budget and the next one, every candidate's loss, the promotion mask,
  and the effective cut threshold (the worst promoted loss). When the
  promotion rule ranked by something other than the raw losses (H2BO's
  learning-curve extrapolation), the rule's scores ride along — the
  record shows what the decision was actually based on.

Both kinds carry ``config_id`` triples, so
:func:`config_lineage` can replay a journal into per-config stories
(sampled → evaluated per budget → promoted/terminated at each rung) —
the join the report CLI (``obs/report.py``) builds its model-vs-random
win rate and promotion-regret tables from.

Emission goes through the event bus, so the no-sink cost is the usual
~zero, and audit call sites never stamp ``trace_id``/``host`` by hand.
The straggler ledger (:func:`note_straggler`) is fed by the anomaly
detector (``obs/anomaly.py``) and drains into ``promotion_decision``
records.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from hpbandster_tpu_torch.obs import events as E

__all__ = [
    "AUDIT_EVENTS",
    "SAMPLING_INFO_KEYS",
    "AUDIT_RULE_FIELDS",
    "emit_bracket_created",
    "emit_bracket_promotion",
    "emit_config_sampled",
    "emit_promotion_decision",
    "emit_sweep_incumbent",
    "note_straggler",
    "drain_stragglers",
    "config_key",
    "config_lineage",
]

#: the audit vocabulary (subset of ``obs.EVENT_TYPES``)
AUDIT_EVENTS = frozenset(
    {E.CONFIG_SAMPLED, E.PROMOTION_DECISION, E.SWEEP_INCUMBENT}
)

#: promotion-audit field names only the dedicated emitters below may
#: stamp (the ``obs-reserved-fields`` graftlint rule enforces it for
#: generic ``emit``/``span`` call sites outside the obs substrate): the
#: active promotion rule and rung, the Pareto ranking a multi-objective
#: decision ranked by, and the straggler correlation marker. An ad-hoc
#: emitter inventing any of these would corrupt the replay/regret join.
AUDIT_RULE_FIELDS = frozenset(
    {"rule", "rung", "pareto_rank", "straggler_observed"}
)

#: config-generator info keys copied into the ``config_sampled`` record.
#: Generators attach these to the info dict they already return (the dict
#: that lands in ``Datum.config_info`` / results.json), so the audit
#: record and the Result stay consistent by construction.
SAMPLING_INFO_KEYS = (
    "model_based_pick",   # bool — model proposal vs random draw
    "sample_reason",      # "model" | "no_model" | "random_fraction" | "model_failure" | "random_search" | "fused_sweep"
    "model_budget",       # which budget's KDE proposed it
    "n_points_in_model",  # observations the proposing KDE was fit on
    "lg_score",           # winning log l(x) - log g(x) acquisition score
    "bandwidth_factor",   # sampling bandwidth multiplier in effect
)


def emit_bracket_created(
    iteration: int,
    num_configs: Sequence[int],
    budgets: Sequence[float],
    eta: Optional[float] = None,
    random_fraction: Optional[float] = None,
) -> None:
    """One ``bracket_created`` record — the bracket plan plus the knobs
    its sampling decisions run under. The single emitter every optimizer
    tier (BOHB, H2BO, fused replay) calls, so the record shape the
    report's bracket table consumes cannot drift between tiers."""
    E.emit(
        "bracket_created",
        iteration=int(iteration),
        num_configs=list(num_configs),
        budgets=list(budgets),
        eta=eta,
        random_fraction=random_fraction,
    )


# -------------------------------------------------------- straggler ledger
#: (run, tenant, config id) triples the anomaly detector's straggler
#: rule flagged, awaiting their rung's next promotion decision (bounded:
#: a run that never promotes must not grow this without limit). The
#: ledger is process-global, so entries are SCOPED by the ambient run
#: (``obs.use_run`` — the master wraps its ingestion path; sinks fall
#: back to the job trace's run_id) and tenant: config-id triples restart
#: at (0, 0, 0) every sweep, and without the scope a marker from one
#: finished sweep — or a concurrent tenant's — would drain into an
#: unrelated decision. Guarded by _STRAGGLER_LOCK — the detector fires
#: from whatever thread emitted the slow event while the master's
#: bookkeeping thread drains.
_StragglerEntry = Tuple[
    Optional[str], Optional[str], Optional[float], Tuple[int, ...]
]
_STRAGGLER_LEDGER: Deque[_StragglerEntry] = collections.deque(maxlen=512)
_STRAGGLER_LOCK = threading.Lock()


def _straggler_scope() -> Tuple[Optional[str], Optional[str]]:
    from hpbandster_tpu_torch.obs.trace import current_run, current_tenant

    return current_run(), current_tenant()


def note_straggler(config_id: Any, budget: Optional[float] = None) -> None:
    """Record a straggler verdict against ``config_id`` (called by the
    anomaly detector when its straggler rule fires on a job event). The
    id joins that rung's next ``promotion_decision`` record — same run,
    tenant, and (when known) the budget the slow evaluation ran at — as
    a ``straggler_observed`` entry, closing the anomaly -> scheduler
    loop one notch: replays can correlate stalls with promotion timing.
    The budget matters under async rules: a config promoted from rung 0
    and flagged while running at budget 3 appears in BOTH rungs'
    candidate censuses, and the marker belongs on the rung that actually
    stalled."""
    key = config_key(config_id)
    if key is None:
        return
    budget = (
        float(budget) if isinstance(budget, (int, float)) else None
    )
    entry = (*_straggler_scope(), budget, key)
    with _STRAGGLER_LOCK:
        if entry not in _STRAGGLER_LEDGER:
            _STRAGGLER_LEDGER.append(entry)


def drain_stragglers(
    config_ids: Sequence[Sequence[int]],
    budget: Optional[float] = None,
) -> List[Tuple[int, ...]]:
    """Flagged ids among ``config_ids`` in the current run/tenant scope
    at ``budget``, removed from the ledger (each straggler verdict rides
    exactly one promotion record). Ids flagged for other rungs — or
    other runs or tenants — stay queued for their own decision. A
    budget of None on either side is a wildcard (hand-rolled notes and
    foreign journals without budget fields still correlate)."""
    keys = {config_key(cid) for cid in config_ids}
    keys.discard(None)
    run, tenant = _straggler_scope()
    budget = (
        float(budget) if isinstance(budget, (int, float)) else None
    )
    with _STRAGGLER_LOCK:
        matched = [
            e for e in _STRAGGLER_LEDGER
            if e[0] == run and e[1] == tenant and e[3] in keys
            and (e[2] is None or budget is None or e[2] == budget)
        ]
        for e in matched:
            _STRAGGLER_LEDGER.remove(e)
    return [e[3] for e in matched]


def emit_bracket_promotion(
    iteration: int,
    rung: int,
    rule: str,
    promoted: int,
    candidates: int,
    budget: float,
    next_budget: Optional[float],
) -> None:
    """One ``bracket_promotion`` event stamped with the active promotion
    rule and rung — the single emitter every promotion tier calls, so the
    labeled Prometheus family and the journal event cannot drift.

    Beside the event, the ``bracket.promotions.<rule>.<rung>`` counter
    advances by the promoted-config count; ``obs/export.py`` renders it
    as ``bracket_promotions_total{rule=..., rung=...}``. The counter
    advances even with no bus sink (metrics are always-on, like every
    other registry family); the event costs ~nothing unheard.
    """
    from hpbandster_tpu_torch.obs.metrics import get_metrics

    get_metrics().counter(
        f"bracket.promotions.{rule}.{int(rung)}"
    ).inc(int(promoted))
    E.emit(
        E.BRACKET_PROMOTION,
        iteration=int(iteration),
        # `stage` keeps the historical meaning (the stage being ENTERED)
        # so pre-existing journal readers stay correct; `rung` is the
        # stage the decision ranked (= stage - 1 for sync advancement)
        stage=int(rung) + 1,
        rung=int(rung),
        rule=rule,
        promoted=int(promoted),
        candidates=int(candidates),
        budget=budget,
        next_budget=next_budget,
    )


def emit_config_sampled(
    config_id: Sequence[int],
    budget: float,
    config_info: Optional[Dict[str, Any]] = None,
) -> None:
    """Emit one per-sample decision record (no-op with no sink attached).

    Only the :data:`SAMPLING_INFO_KEYS` present in ``config_info`` are
    copied — a generator that predates a key simply produces a sparser
    record, never a schema error.
    """
    if not E.get_bus().active:
        return  # no sink: skip even the field-dict build (hot sample loop)
    fields: Dict[str, Any] = {
        "config_id": list(config_id), "budget": budget,
    }
    if config_info:
        for key in SAMPLING_INFO_KEYS:
            if key in config_info:
                fields[key] = config_info[key]
    E.emit(E.CONFIG_SAMPLED, **fields)


def emit_promotion_decision(
    iteration: int,
    rung: int,
    budget: float,
    next_budget: Optional[float],
    config_ids: Sequence[Sequence[int]],
    losses: Sequence[Optional[float]],
    promoted: Sequence[bool],
    rule: str = "successive_halving",
    scores: Optional[Sequence[Optional[float]]] = None,
    pareto_rank: Optional[Sequence[Optional[int]]] = None,
    costs: Optional[Sequence[Optional[float]]] = None,
) -> None:
    """Emit one per-rung promotion record (no-op with no sink attached).

    ``losses`` may contain None (crashed configs); ``scores`` is the
    promotion rule's ranking values when they differ from the raw losses
    (H2BO extrapolation / learning-curve early stopping). The cut
    threshold is the worst promoted loss — the rung's effective survival
    bar in hindsight analysis. ``pareto_rank`` carries the domination
    counts a multi-objective decision ranked by; ``costs`` the measured
    per-candidate evaluation cost (seconds), which is what makes a
    recorded journal Pareto-replayable after the fact. Config ids the
    straggler rule flagged since the last decision join the record as
    ``straggler_observed`` (see :func:`note_straggler`).
    """
    if not E.get_bus().active:
        return  # no sink: skip the per-candidate list builds
    promoted = [bool(p) for p in promoted]
    survivor_losses = [
        l for l, p in zip(losses, promoted) if p and l is not None
    ]
    fields: Dict[str, Any] = {
        "iteration": int(iteration),
        "rung": int(rung),
        "budget": budget,
        "next_budget": next_budget,
        "rule": rule,
        "config_ids": [list(cid) for cid in config_ids],
        "losses": list(losses),
        "promoted": promoted,
        "n_promoted": sum(promoted),
        "n_candidates": len(promoted),
        "cut_threshold": max(survivor_losses) if survivor_losses else None,
        "survivor_losses": sorted(survivor_losses),
    }
    if scores is not None:
        fields["scores"] = list(scores)
    if pareto_rank is not None:
        fields["pareto_rank"] = [
            None if r is None else int(r) for r in pareto_rank
        ]
    if costs is not None:
        fields["costs"] = [
            None if c is None else float(c) for c in costs
        ]
    flagged = drain_stragglers(config_ids, budget=budget)
    if flagged:
        fields["straggler_observed"] = [list(k) for k in flagged]
    E.emit(E.PROMOTION_DECISION, **fields)


def emit_sweep_incumbent(
    vector: Sequence[float],
    loss: Optional[float],
    bracket: int,
    per_bracket_loss: Sequence[Optional[float]],
    evaluations: Optional[int] = None,
    n_configs: Optional[int] = None,
    d2h_bytes: Optional[int] = None,
    h2d_bytes: Optional[int] = None,
    host_syncs: Optional[int] = None,
) -> None:
    """Journal a resident (incumbent-only) sweep's single device->host
    payload — the ONE decision record such a sweep produces.

    When the whole HyperBand outer loop runs in-trace
    (``ops/sweep.py`` ``resident=True`` + ``incumbent_only=True``),
    per-rung promotion decisions never leave the device; this record
    carries everything that did: the winning configuration vector, its
    final-stage loss, which bracket produced it, and each bracket's best
    final loss — enough for ``obs replay`` to re-score the incumbent
    pick against the per-bracket bests (the regret surface that remains
    when per-rung candidates were never materialized host-side). The
    per-sweep transfer accounting (``d2h_bytes``/``h2d_bytes``/
    ``host_syncs``, from :func:`obs.runtime.publish_sweep_transfers`)
    rides along so the flat-d2h claim is replayable from the journal.

    Non-finite losses journal as None (strict-JSON rule, like the
    master's loss-carrying records).
    """

    def _j(v: Any) -> Optional[float]:
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            v = float(v)
            return v if v == v and v not in (float("inf"), float("-inf")) else None
        return None

    fields: Dict[str, Any] = {
        "vector": [_j(x) for x in vector],
        "loss": _j(loss),
        "bracket": int(bracket),
        "per_bracket_loss": [_j(l) for l in per_bracket_loss],
    }
    if evaluations is not None:
        fields["evaluations"] = int(evaluations)
    if n_configs is not None:
        fields["n_configs"] = int(n_configs)
    if d2h_bytes is not None:
        fields["d2h_bytes"] = int(d2h_bytes)
    if h2d_bytes is not None:
        fields["h2d_bytes"] = int(h2d_bytes)
    if host_syncs is not None:
        fields["host_syncs"] = int(host_syncs)
    E.emit(E.SWEEP_INCUMBENT, **fields)


# ------------------------------------------------------------------ replay
def config_key(config_id: Any) -> Optional[Tuple[int, ...]]:
    """Journal ``config_id`` field -> hashable lineage key (or None)."""
    if isinstance(config_id, (list, tuple)) and config_id:
        try:
            return tuple(int(x) for x in config_id)
        except (TypeError, ValueError):
            return None
    return None


def config_lineage(
    records: List[Dict[str, Any]],
) -> Dict[Tuple[int, ...], Dict[str, Any]]:
    """Replay journal records into per-config decision lineages.

    Returns ``{config_id: lineage}`` where each lineage carries:

    * ``sampled`` — the ``config_sampled`` audit fields (first wins);
    * ``results`` — ``{budget: loss}`` from master-side
      ``job_finished`` records (first completed evaluation per budget;
      ``None`` = crashed);
    * ``rungs`` — ordered ``(iteration, rung, budget, promoted)``
      promotion outcomes this config was a candidate in.

    Deterministic in the record order (callers pass
    ``summarize.read_merged`` output, which is wall-clock sorted).
    """
    lineages: Dict[Tuple[int, ...], Dict[str, Any]] = {}

    def slot(key: Tuple[int, ...]) -> Dict[str, Any]:
        return lineages.setdefault(
            key, {"sampled": None, "results": {}, "rungs": []}
        )

    for rec in records:
        name = rec.get("event")
        if name == E.CONFIG_SAMPLED:
            key = config_key(rec.get("config_id"))
            if key is None:
                continue
            s = slot(key)
            if s["sampled"] is None:
                s["sampled"] = {
                    k: rec[k] for k in SAMPLING_INFO_KEYS if k in rec
                }
        elif name in (E.JOB_FINISHED, E.JOB_FAILED):
            key = config_key(rec.get("config_id"))
            budget = rec.get("budget")
            # the loss-carrying record is authoritative (master funnel /
            # fused replay); worker-side twins carry compute_s, no loss
            if key is None or not isinstance(budget, (int, float)):
                continue
            if "loss" not in rec:
                continue
            s = slot(key)
            if float(budget) not in s["results"]:
                loss = rec.get("loss")
                s["results"][float(budget)] = (
                    float(loss) if isinstance(loss, (int, float)) else None
                )
        elif name == E.PROMOTION_DECISION:
            ids = rec.get("config_ids")
            promoted = rec.get("promoted")
            if not isinstance(ids, list) or not isinstance(promoted, list):
                continue
            for cid, prom in zip(ids, promoted):
                key = config_key(cid)
                if key is None:
                    continue
                slot(key)["rungs"].append((
                    rec.get("iteration"), rec.get("rung"),
                    rec.get("budget"), bool(prom),
                ))
    return lineages
