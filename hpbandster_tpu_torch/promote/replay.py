"""Replay / regret harness: re-score recorded promotion journals.

Ported from ``hpbandster_tpu/promote/replay.py``.

Every rung advancement journals one ``promotion_decision`` audit record
(obs/audit.py): the candidate set, losses, the promotion mask, the rule
that decided, measured costs, and — since this subsystem — any
``straggler_observed`` correlation markers. That record is sufficient to
re-run the decision under a DIFFERENT rule and score both against
hindsight (what the promoted configs actually did at the next budget):

* **rank inversions** — among promoted configs with a next-budget
  result, how many pairs swapped order across the rung (the rule's
  ranking disagreed with the next fidelity);
* **incumbent (rank-1) regret** — the next-budget loss of the rule's
  top-ranked promotion minus the best next-budget loss available in the
  promoted set: did the rule's favorite stay the favorite?

:func:`replay_records` reports both for the recorded mask and the
replayed mask, plus their deltas — "what would ASHA/Pareto/early-stop
have cost or saved on this exact run". Output is a hard determinism
contract like ``obs report``: derived exclusively from record content,
every float rounded, every ordering content-keyed — two invocations over
the same journal are byte-identical (pinned by tests).

Hindsight honesty: a config the replayed rule WOULD have promoted but
the recorded rule terminated has no next-budget result — regret is
measured within the evaluated set, and ``evaluated_promoted`` says how
much hindsight each number rests on.

Also here: :func:`promotion_waits` (how long each promoted config sat
between its rung result and its promotion; the sync barrier's stall made
measurable) and :func:`worker_utilization` (the fleet's busy fraction,
from ``obs/summarize.py``).
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from hpbandster_tpu_torch.obs import events as E
from hpbandster_tpu_torch.obs.audit import config_key, config_lineage
from hpbandster_tpu_torch.promote import RULE_NAMES

__all__ = [
    "replay_records",
    "format_replay",
    "promotion_waits",
    "worker_utilization",
]


def _finite(v: Any) -> Optional[float]:
    if (
        isinstance(v, (int, float))
        and not isinstance(v, bool)
        and math.isfinite(v)
    ):
        return float(v)
    return None


# ------------------------------------------------------------ rule re-score
def _replay_mask(
    rule: str,
    rec: Dict[str, Any],
    lineages: Dict[Tuple[int, ...], Dict[str, Any]],
    eta: Optional[float],
    final_budget: Optional[float],
) -> Tuple[List[bool], List[Optional[float]]]:
    """(mask, ranking scores) the named rule produces on one recorded
    decision. Scores are the values the rule ranked by (losses for the
    loss-ranked rules) — what hindsight judges the replay against."""
    import numpy as np

    from hpbandster_tpu_torch.ops.bracket import (
        pareto_promotion_mask_np,
        pareto_rank_np,
        sh_promotion_mask_np,
    )

    losses_raw = rec.get("losses") or []
    losses = np.array(
        [np.nan if _finite(l) is None else float(l) for l in losses_raw],
        dtype=np.float64,
    )
    n = len(losses_raw)
    k_recorded = int(rec.get("n_promoted") or 0)
    loss_scores = [_finite(l) for l in losses_raw]

    if rule in ("successive_halving", "sync", "successive_halving_jax"):
        mask = sh_promotion_mask_np(losses, k_recorded)
        return [bool(m) for m in mask], loss_scores

    if rule == "asha":
        # ASHA's end-state on a full rung: top floor(n / eta). eta comes
        # from the caller or the record's own budget ratio (the ladder
        # is geometric, so the rung ratio IS eta).
        eta_eff = eta
        if eta_eff is None:
            budget = _finite(rec.get("budget"))
            nxt = _finite(rec.get("next_budget"))
            if budget and nxt and nxt > budget:
                eta_eff = nxt / budget
        if eta_eff is None or eta_eff <= 1:
            eta_eff = 3.0
        k = int(n // eta_eff)
        mask = sh_promotion_mask_np(losses, k)
        # crashed rows never promote, whatever floor(n/eta) says
        mask = np.asarray(mask) & ~np.isnan(losses)
        return [bool(m) for m in mask], loss_scores

    if rule == "pareto":
        costs_raw = rec.get("costs") or [None] * n
        costs = np.array(
            [np.nan if _finite(c) is None else float(c) for c in costs_raw],
            dtype=np.float64,
        )
        objectives = np.column_stack([losses, costs])
        mask = pareto_promotion_mask_np(objectives, k_recorded)
        ranks = pareto_rank_np(objectives)
        scores = [
            None if np.isnan(l) else float(r)
            for r, l in zip(ranks, losses)
        ]
        return [bool(m) for m in mask], scores

    if rule == "lc_earlystop":
        from hpbandster_tpu_torch.models.learning_curves import PowerLawModel

        model = PowerLawModel()
        budget = _finite(rec.get("budget"))
        preds: List[Optional[float]] = []
        for cid in rec.get("config_ids") or []:
            key = config_key(cid)
            results = (lineages.get(key) or {}).get("results", {})
            curve = [
                (b, v)
                for b, v in sorted(results.items())
                if v is not None and (budget is None or b <= budget)
            ]
            pred = (
                model.predict(curve, final_budget)
                if curve and final_budget else float("nan")
            )
            preds.append(_finite(pred))
        mask = sh_promotion_mask_np(losses, k_recorded)
        mask = list(np.asarray(mask) & ~np.isnan(losses))
        cut = None
        if final_budget is not None:
            finals = [
                v
                for lineage in lineages.values()
                for b, v in lineage["results"].items()
                if b == final_budget and _finite(v) is not None
            ]
            cut = min(finals) if finals else None
        if cut is not None:
            mask = [
                bool(m) and not (p is not None and p > cut)
                for m, p in zip(mask, preds)
            ]
        scores = [
            p if p is not None else l for p, l in zip(preds, loss_scores)
        ]
        return [bool(m) for m in mask], scores

    raise ValueError(
        f"unknown promotion rule {rule!r} (supported: {RULE_NAMES})"
    )


def _hindsight(
    config_ids: Sequence[Any],
    scores: Sequence[Optional[float]],
    mask: Sequence[bool],
    next_budget: Any,
    lineages: Dict[Tuple[int, ...], Dict[str, Any]],
) -> Dict[str, Any]:
    """Judge one (scores, mask) pair against next-budget results — a
    thin delegate to :func:`obs.report.promotion_hindsight`, THE single
    implementation of the rank-1 regret / inversion arithmetic, so the
    report CLI and this harness cannot drift on the same journal."""
    from hpbandster_tpu_torch.obs.report import promotion_hindsight

    return promotion_hindsight(
        list(config_ids), list(scores), [bool(m) for m in mask],
        next_budget, lineages,
    )


def _incumbent_rows(
    records: List[Dict[str, Any]],
    lineages: Dict[Tuple[int, ...], Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """Re-score ``sweep_incumbent`` records — the ONLY decision payload a
    resident incumbent-only sweep journals (per-rung decisions never left
    the device). Each row judges the recorded winner against the
    per-bracket bests the same payload carried (``rank1_regret`` must be
    ~0: the device incumbent fold IS min over bracket bests — a nonzero
    value flags a corrupted journal or a broken kernel) and, when the
    journal also holds evaluated results (hybrid runs), against the best
    evaluated loss."""
    rows: List[Dict[str, Any]] = []
    evaluated = [
        v
        for lineage in lineages.values()
        for v in lineage["results"].values()
        if _finite(v) is not None
    ]
    best_evaluated = min(evaluated) if evaluated else None
    for rec in records:
        if rec.get("event") != E.SWEEP_INCUMBENT:
            continue
        loss = _finite(rec.get("loss"))
        pb = [_finite(x) for x in rec.get("per_bracket_loss") or []]
        finite = [x for x in pb if x is not None]
        best = min(finite) if finite else None
        regret = (
            round(loss - best, 6)
            if loss is not None and best is not None else None
        )
        rows.append({
            "bracket": rec.get("bracket"),
            "loss": loss,
            "n_brackets": len(pb),
            "best_bracket": (
                pb.index(best) if best is not None else None
            ),
            "best_bracket_loss": best,
            "rank1_regret": regret,
            "consistent": (
                None if regret is None else bool(abs(regret) < 1e-6)
            ),
            "vs_evaluated": (
                round(loss - best_evaluated, 6)
                if loss is not None and best_evaluated is not None
                else None
            ),
            "d2h_bytes": rec.get("d2h_bytes"),
            "host_syncs": rec.get("host_syncs"),
        })
    return rows


def replay_records(
    records: List[Dict[str, Any]],
    rule: str,
    eta: Optional[float] = None,
) -> Dict[str, Any]:
    """Re-score every ``promotion_decision`` in ``records`` under
    ``rule``; returns the deterministic replay report dict. Journals
    whose sweeps ran resident/incumbent-only carry no per-rung records —
    their ``sweep_incumbent`` payloads are re-scored into the
    ``incumbent`` section instead, so regret scoring still works when
    the decisions never left the device."""
    lineages = config_lineage(records)
    budgets = [
        b
        for lineage in lineages.values()
        for b in lineage["results"]
    ]
    final_budget = max(budgets) if budgets else None
    rows: List[Dict[str, Any]] = []
    for rec in records:
        if rec.get("event") != E.PROMOTION_DECISION:
            continue
        ids = rec.get("config_ids") or []
        recorded_mask = [bool(p) for p in rec.get("promoted") or []]
        recorded_scores_raw = rec.get("scores")
        recorded_scores = (
            [_finite(s) for s in recorded_scores_raw]
            if isinstance(recorded_scores_raw, list)
            and len(recorded_scores_raw) == len(ids)
            else [_finite(l) for l in rec.get("losses") or []]
        )
        replay_mask, replay_scores = _replay_mask(
            rule, rec, lineages, eta, final_budget
        )
        recorded = _hindsight(
            ids, recorded_scores, recorded_mask,
            rec.get("next_budget"), lineages,
        )
        replayed = _hindsight(
            ids, replay_scores, replay_mask,
            rec.get("next_budget"), lineages,
        )
        n_changed = sum(
            1 for a, b in zip(recorded_mask, replay_mask) if a != b
        )
        regret_delta = (
            round(replayed["rank1_regret"] - recorded["rank1_regret"], 6)
            if recorded["rank1_regret"] is not None
            and replayed["rank1_regret"] is not None else None
        )
        inversion_delta = (
            replayed["inversions"] - recorded["inversions"]
            if recorded["inversions"] is not None
            and replayed["inversions"] is not None else None
        )
        rows.append({
            "iteration": rec.get("iteration"),
            "rung": rec.get("rung"),
            "budget": rec.get("budget"),
            "next_budget": rec.get("next_budget"),
            "recorded_rule": rec.get("rule"),
            "n_candidates": len(ids),
            "n_promoted_recorded": sum(recorded_mask),
            "n_promoted_replay": sum(1 for m in replay_mask if m),
            "n_changed": n_changed,
            "stragglers_observed": len(
                rec.get("straggler_observed") or []
            ),
            "recorded": recorded,
            "replayed": replayed,
            "regret_delta": regret_delta,
            "inversion_delta": inversion_delta,
        })
    rows.sort(
        key=lambda r: (
            r["iteration"] if isinstance(r["iteration"], int) else -1,
            r["rung"] if isinstance(r["rung"], int) else -1,
            r["budget"] if isinstance(r["budget"], (int, float)) else -1,
        )
    )
    regret_deltas = [
        r["regret_delta"] for r in rows if r["regret_delta"] is not None
    ]
    inversion_deltas = [
        r["inversion_delta"] for r in rows
        if r["inversion_delta"] is not None
    ]
    incumbents = _incumbent_rows(records, lineages)
    return {
        "rule": rule,
        "eta": eta,
        "decisions": rows,
        "incumbent": {
            "sweeps": incumbents,
            "inconsistent": sum(
                1 for r in incumbents if r["consistent"] is False
            ),
        } if incumbents else None,
        "aggregate": {
            "decisions": len(rows),
            "decisions_changed": sum(
                1 for r in rows if r["n_changed"] > 0
            ),
            "configs_changed": sum(r["n_changed"] for r in rows),
            "mean_regret_delta": (
                round(sum(regret_deltas) / len(regret_deltas), 6)
                if regret_deltas else None
            ),
            "total_inversion_delta": (
                sum(inversion_deltas) if inversion_deltas else None
            ),
            "stragglers_observed": sum(
                r["stragglers_observed"] for r in rows
            ),
        },
    }


def _fmt(v: Any) -> str:
    if isinstance(v, bool) or v is None:
        return json.dumps(v)
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def format_replay(rep: Dict[str, Any]) -> str:
    agg = rep["aggregate"]
    lines = [
        f"promotion replay under rule {rep['rule']!r}"
        + (f" (eta={_fmt(rep['eta'])})" if rep.get("eta") else ""),
        f"  {agg['decisions']} decisions, {agg['decisions_changed']} "
        f"changed ({agg['configs_changed']} config flips), "
        f"mean rank-1 regret delta {_fmt(agg['mean_regret_delta'])}, "
        f"inversion delta {_fmt(agg['total_inversion_delta'])}, "
        f"{agg['stragglers_observed']} straggler marker(s)",
        "",
        f"  {'iter':>5} {'rung':>5} {'budget':>8} {'rec_rule':<20} "
        f"{'prom':>5} {'rep':>5} {'flip':>5} {'d_regret':>10} "
        f"{'d_inv':>6} {'strag':>6}",
    ]
    for r in rep["decisions"]:
        lines.append(
            f"  {_fmt(r['iteration']):>5} {_fmt(r['rung']):>5} "
            f"{_fmt(r['budget']):>8} {str(r['recorded_rule'] or '?'):<20} "
            f"{r['n_promoted_recorded']:>5} {r['n_promoted_replay']:>5} "
            f"{r['n_changed']:>5} {_fmt(r['regret_delta']):>10} "
            f"{_fmt(r['inversion_delta']):>6} "
            f"{r['stragglers_observed']:>6}"
        )
    if not rep["decisions"]:
        lines.append("  (no promotion_decision records in this journal)")
    inc = rep.get("incumbent")
    if inc:
        lines.append("")
        lines.append(
            f"  resident incumbent payload(s): {len(inc['sweeps'])} "
            f"sweep(s), {inc['inconsistent']} inconsistent"
        )
        lines.append(
            f"  {'bracket':>8} {'loss':>12} {'best_br':>8} "
            f"{'regret':>10} {'ok':>4} {'vs_eval':>10} {'d2h_B':>8}"
        )
        for r in inc["sweeps"]:
            lines.append(
                f"  {_fmt(r['bracket']):>8} {_fmt(r['loss']):>12} "
                f"{_fmt(r['best_bracket']):>8} "
                f"{_fmt(r['rank1_regret']):>10} "
                f"{_fmt(r['consistent']):>4} {_fmt(r['vs_evaluated']):>10} "
                f"{_fmt(r['d2h_bytes']):>8}"
            )
    lines.append("")
    return "\n".join(lines)


# ------------------------------------------------- straggler-timing helpers
def promotion_waits(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """How long each promoted config waited between its rung result and
    the decision that promoted it — the barrier stall, measured.

    Under the synchronous rule every early finisher waits for the rung's
    last result (one delayed worker = rung-wide stall); under ASHA a top
    config promotes at the next result arrival, so its wait stays near
    zero. Deterministic: both instants come from record ``t_wall``.
    """
    result_t: Dict[Tuple[Tuple[int, ...], float], float] = {}
    for rec in records:
        if rec.get("event") not in (E.JOB_FINISHED, E.JOB_FAILED):
            continue
        if "loss" not in rec:  # worker-side twin: not the ingestion instant
            continue
        key = config_key(rec.get("config_id"))
        budget = rec.get("budget")
        tw = rec.get("t_wall")
        if (
            key is None
            or not isinstance(budget, (int, float))
            or not isinstance(tw, (int, float))
        ):
            continue
        result_t.setdefault((key, float(budget)), float(tw))
    waits: List[float] = []
    per_decision: List[Dict[str, Any]] = []
    for rec in records:
        if rec.get("event") != E.PROMOTION_DECISION:
            continue
        tw = rec.get("t_wall")
        budget = rec.get("budget")
        if not isinstance(tw, (int, float)) or not isinstance(
            budget, (int, float)
        ):
            continue
        decision_waits: List[float] = []
        for cid, promoted in zip(
            rec.get("config_ids") or [], rec.get("promoted") or []
        ):
            if not promoted:
                continue
            key = config_key(cid)
            t_result = result_t.get((key, float(budget))) if key else None
            if t_result is not None:
                decision_waits.append(max(float(tw) - t_result, 0.0))
        if decision_waits:
            waits.extend(decision_waits)
            per_decision.append({
                "iteration": rec.get("iteration"),
                "rung": rec.get("rung"),
                "rule": rec.get("rule"),
                "max_wait_s": round(max(decision_waits), 6),
                "mean_wait_s": round(
                    sum(decision_waits) / len(decision_waits), 6
                ),
            })
    return {
        "promotions": len(waits),
        "max_wait_s": round(max(waits), 6) if waits else None,
        "mean_wait_s": (
            round(sum(waits) / len(waits), 6) if waits else None
        ),
        "per_decision": per_decision,
    }


def worker_utilization(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-worker busy fraction over the journal's wall window, folded
    into one fleet-wide busy fraction: a reshaping of
    ``summarize_records``' worker-utilization aggregation (one
    implementation of the busy-seconds over window arithmetic)."""
    from hpbandster_tpu_torch.obs.summarize import summarize_records

    summary = summarize_records(records)
    window = float(summary.get("window_s") or 0.0)
    util = summary.get("worker_utilization") or {}
    per_worker = {
        w: u.get("utilization") for w, u in sorted(util.items())
    }
    busy_total = sum(float(u.get("busy_s") or 0.0) for u in util.values())
    fleet = (
        round(min(busy_total / (window * len(util)), 1.0), 4)
        if window > 0 and util else None
    )
    return {
        "window_s": round(window, 3),
        "per_worker": per_worker,
        "busy_fraction": fleet,
    }
