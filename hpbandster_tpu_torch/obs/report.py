"""Deterministic run reports: ``python -m hpbandster_tpu_torch.obs report``.

Ported from ``hpbandster_tpu/obs/report.py`` (a copy): the same records
give a byte-identical report in either package.

Where ``summarize`` answers "how did the *infrastructure* behave" (stage
latencies, utilization, failures), ``report`` answers "how did the
*optimizer* behave" — entirely from merged journals, no live run needed:

* **incumbent trajectory** — every time the best-seen loss improved:
  when, at what budget, by which config, and whether the improver was a
  model-based pick or a random draw (joined from ``config_sampled``
  audit records, see ``obs/audit.py``);
* **model vs random** — per budget, how model-based proposals compare to
  random draws: counts, best/mean losses, and the pairwise win rate
  P(model beats random) — the journal-side check of BOHB §4's claim that
  the model earns its keep once trained;
* **promotion regret** — per rung, was the promotion justified in
  hindsight: among the promoted configs, did the rung's top-ranked one
  stay best at the next budget (rank-1 carryover regret), and how many
  promoted pairs swapped order across the rung (inversions)? High regret
  at a rung means its fidelity is too noisy to cut there — HyperBand's
  ladder analysis (Li et al., JMLR 2017) made from the audit trail;
* **bracket utilization** — per iteration: planned vs sampled configs,
  model-based share, completed/crashed evaluations, promotions per rung;
* **runtime** — compile economics from ``xla_compile`` records
  (``obs/runtime.py``): total compiles, compile seconds, their share of
  the run's wall-clock window, and the top recompiling functions;
* **device telemetry** — the decoded in-trace metrics plane
  (``device_telemetry`` records, ``obs/device_metrics.py``): per-rung
  crash/promotion counts and loss quantiles for fused/resident sweeps
  whose decisions never surfaced to host (same aggregation as
  ``summarize`` — the two views cannot drift);
* **alert digest** — the anomaly detector's verdicts: recorded ``alert``
  events when a live detector ran, otherwise a deterministic offline
  replay of the same rules (``obs.anomaly.scan_records``).

Determinism is a hard contract (pinned by tests): the report derives
exclusively from record content — never from the wall clock, dict
iteration order, or file paths — so two invocations over the same
journal(s) are byte-identical.
"""

from __future__ import annotations

import bisect
import json
from typing import Any, Dict, List, Optional, Tuple

from hpbandster_tpu_torch.obs import events as E
from hpbandster_tpu_torch.obs.alerts import scan_slo_records
from hpbandster_tpu_torch.obs.anomaly import scan_records
from hpbandster_tpu_torch.obs.audit import config_key, config_lineage
from hpbandster_tpu_torch.obs.device_metrics import (
    device_section_from_records,
    finite_or_none as _finite,
    format_device_section,
)
from hpbandster_tpu_torch.obs.runtime import compile_stats_from_records
from hpbandster_tpu_torch.obs.trace import DEFAULT_TENANT

__all__ = [
    "build_report",
    "format_report",
    "filter_tenant",
    "promotion_hindsight",
]


def filter_tenant(
    records: List[Dict[str, Any]], tenant: str
) -> List[Dict[str, Any]]:
    """One tenant's slice of a merged multi-tenant journal.

    A record without a ``tenant_id`` belongs to :data:`DEFAULT_TENANT` —
    that is the byte-compat contract (``obs/trace.py``): pre-serving
    journals, and the non-tenant infrastructure records of a serving
    process (collector samples, compile events from shared programs),
    all read as the default tenant. ``report --tenant acme`` over a
    single-tenant journal therefore returns nothing for ``acme`` and
    everything for ``default``.
    """
    tenant = str(tenant)
    return [
        r for r in records
        if str(r.get("tenant_id", DEFAULT_TENANT)) == tenant
    ]


def _fmt(v: Any) -> str:
    """Stable scalar formatting: %.6g for floats, json for the rest."""
    if isinstance(v, bool) or v is None:
        return json.dumps(v)
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def promotion_hindsight(
    config_ids: List[Any],
    scores: List[Optional[float]],
    mask: List[bool],
    next_budget: Any,
    lineages: Dict[Tuple[int, ...], Dict[str, Any]],
) -> Dict[str, Any]:
    """Judge one promotion (ranking ``scores``, promotion ``mask``)
    against next-budget results: rank-1 (incumbent) regret and pairwise
    rank inversions among the promoted configs that were actually
    evaluated further. THE one implementation — the report's
    promotion-regret table and the replay harness
    (``promote/replay.py``) both call it, so the two views of a journal
    cannot drift.

    Ties in ``scores`` break by candidate order — this is load-bearing:
    Pareto's integer domination counts tie across a whole front, and
    breaking by the next loss would hand every tied group a free zero
    regret and hide within-tie inversions. Callers resolve their own
    score fallbacks (e.g. raw losses) before passing.
    """
    from hpbandster_tpu_torch.obs.audit import config_key

    # (rank value, candidate index, next loss)
    pairs: List[Tuple[float, int, float]] = []
    if isinstance(next_budget, (int, float)):
        for idx, (cid, score, promoted) in enumerate(
            zip(config_ids, scores, mask)
        ):
            if not promoted:
                continue
            rank_value = _finite(score)
            key = config_key(cid)
            nxt = (
                _finite(
                    (lineages.get(key) or {})
                    .get("results", {})
                    .get(float(next_budget))
                )
                if key else None
            )
            if rank_value is not None and nxt is not None:
                pairs.append((rank_value, idx, nxt))
    rank1_regret = None
    inversions = None
    if pairs:
        ordered = sorted(pairs)
        best_next = min(p[2] for p in pairs)
        rank1_regret = round(ordered[0][2] - best_next, 6)
        inv = 0
        for i in range(len(ordered)):
            for j in range(i + 1, len(ordered)):
                if ordered[i][2] > ordered[j][2]:
                    inv += 1
        inversions = inv
    return {
        "evaluated_promoted": len(pairs),
        "rank1_regret": rank1_regret,
        "inversions": inversions,
    }


# ----------------------------------------------------------------- sections
def _incumbent_trajectory(
    records: List[Dict[str, Any]],
    lineages: Dict[Tuple[int, ...], Dict[str, Any]],
    t0: Optional[float],
) -> List[Dict[str, Any]]:
    best: Optional[float] = None
    rows: List[Dict[str, Any]] = []
    n_results = 0
    for rec in records:
        # the loss-carrying record is the result's authoritative telling
        # (master funnel / fused replay — worker-side twins carry
        # compute_s, deliberately no loss): one record per result
        if rec.get("event") != E.JOB_FINISHED or "loss" not in rec:
            continue
        loss = _finite(rec.get("loss"))
        if loss is None:
            continue
        n_results += 1
        if best is not None and loss >= best:
            continue
        best = loss
        key = config_key(rec.get("config_id"))
        sampled = (lineages.get(key) or {}).get("sampled") if key else None
        tw = rec.get("t_wall")
        rows.append({
            "at_s": (
                round(float(tw) - t0, 3)
                if isinstance(tw, (int, float)) and t0 is not None else None
            ),
            "n_results": n_results,
            "config_id": list(key) if key else None,
            "budget": rec.get("budget"),
            "loss": loss,
            "model_based": (
                bool(sampled.get("model_based_pick"))
                if sampled and "model_based_pick" in sampled else None
            ),
        })
    return rows


def _model_vs_random(
    lineages: Dict[Tuple[int, ...], Dict[str, Any]],
) -> Dict[str, Any]:
    per_budget: Dict[float, Dict[str, List[float]]] = {}
    unattributed = 0
    for lineage in lineages.values():
        sampled = lineage["sampled"]
        if sampled is None or "model_based_pick" not in sampled:
            if lineage["results"]:
                unattributed += 1
            continue
        arm = "model" if sampled["model_based_pick"] else "random"
        for budget, loss in lineage["results"].items():
            if _finite(loss) is None:
                continue
            per_budget.setdefault(budget, {"model": [], "random": []})[
                arm
            ].append(float(loss))

    budgets_out = {}
    for budget in sorted(per_budget):
        model = sorted(per_budget[budget]["model"])
        random = sorted(per_budget[budget]["random"])
        # P(model < random) over all cross pairs, O(n log n): for each
        # model loss, count random losses above/equal via bisect on the
        # sorted random side (100k-event journals make O(n·m) minutes)
        wins = ties = 0.0
        for m in model:
            lo = bisect.bisect_left(random, m)
            hi = bisect.bisect_right(random, m)
            wins += len(random) - hi
            ties += hi - lo
        pairs = len(model) * len(random)
        budgets_out[f"{budget:g}"] = {
            "n_model": len(model),
            "n_random": len(random),
            "best_model": model[0] if model else None,
            "best_random": random[0] if random else None,
            "mean_model": (
                round(sum(model) / len(model), 6) if model else None
            ),
            "mean_random": (
                round(sum(random) / len(random), 6) if random else None
            ),
            "model_win_rate": (
                round((wins + 0.5 * ties) / pairs, 4) if pairs else None
            ),
        }
    return {"budgets": budgets_out, "unattributed_configs": unattributed}


def _promotion_regret(
    records: List[Dict[str, Any]],
    lineages: Dict[Tuple[int, ...], Dict[str, Any]],
) -> Dict[str, Any]:
    rows: List[Dict[str, Any]] = []
    for rec in records:
        if rec.get("event") != E.PROMOTION_DECISION:
            continue
        ids = rec.get("config_ids") or []
        losses = rec.get("losses") or []
        promoted = rec.get("promoted") or []
        next_budget = rec.get("next_budget")
        # hindsight must judge the ranking the rule ACTUALLY used: when
        # the record carries scores (H2BO extrapolation), rank by those;
        # the raw rung loss is the rule's ranking only for plain SH
        scores = rec.get("scores")
        ranks = scores if isinstance(scores, list) and len(scores) == len(losses) else losses
        # promoted configs with a result at the next budget: the only
        # hindsight available (terminated configs were never evaluated
        # further — regret is measured within the promoted set). Score
        # fallback: where the rule recorded no score, its ranking value
        # was the raw rung loss.
        resolved = [
            _finite(rank) if _finite(rank) is not None else _finite(loss)
            for rank, loss in zip(ranks, losses)
        ]
        hindsight = promotion_hindsight(
            list(ids), resolved, [bool(p) for p in promoted],
            next_budget, lineages,
        )
        rank1_regret = hindsight["rank1_regret"]
        inversions = hindsight["inversions"]
        rows.append({
            "iteration": rec.get("iteration"),
            "rung": rec.get("rung"),
            "budget": rec.get("budget"),
            "next_budget": next_budget,
            "rule": rec.get("rule"),
            "n_candidates": rec.get("n_candidates"),
            "n_promoted": rec.get("n_promoted"),
            "cut_threshold": rec.get("cut_threshold"),
            "evaluated_promoted": hindsight["evaluated_promoted"],
            "rank1_regret": rank1_regret,
            "rank_held": (
                rank1_regret <= 0.0 if rank1_regret is not None else None
            ),
            "inversions": inversions,
            # anomaly correlation (obs/audit.py straggler ledger): how
            # many of this rung's candidates the straggler rule flagged
            # before the decision — high regret WITH stalls reads very
            # differently from high regret on a healthy rung
            "stragglers_observed": len(
                rec.get("straggler_observed") or []
            ),
        })
    rows.sort(key=lambda r: (r["iteration"] or 0, r["rung"] or 0))

    per_rung: Dict[int, List[Dict[str, Any]]] = {}
    for r in rows:
        if r["rank1_regret"] is not None:
            per_rung.setdefault(int(r["rung"] or 0), []).append(r)
    aggregate = {}
    for rung in sorted(per_rung):
        rs = per_rung[rung]
        aggregate[str(rung)] = {
            "decisions": len(rs),
            "mean_rank1_regret": round(
                sum(r["rank1_regret"] for r in rs) / len(rs), 6
            ),
            "rank_held_rate": round(
                sum(1 for r in rs if r["rank_held"]) / len(rs), 4
            ),
        }
    return {"decisions": rows, "per_rung": aggregate}


def _brackets(
    records: List[Dict[str, Any]],
    lineages: Dict[Tuple[int, ...], Dict[str, Any]],
) -> List[Dict[str, Any]]:
    planned: Dict[int, Dict[str, Any]] = {}
    for rec in records:
        if rec.get("event") == "bracket_created":
            it = rec.get("iteration")
            if isinstance(it, int) and it not in planned:
                planned[it] = {
                    "num_configs": rec.get("num_configs"),
                    "budgets": rec.get("budgets"),
                }
    per_iter: Dict[int, Dict[str, Any]] = {}
    for key, lineage in sorted(lineages.items()):
        it = key[0]
        slot = per_iter.setdefault(it, {
            "sampled": 0, "model_based": 0, "completed": 0, "crashed": 0,
        })
        if lineage["sampled"] is not None:
            slot["sampled"] += 1
            if lineage["sampled"].get("model_based_pick"):
                slot["model_based"] += 1
        for loss in lineage["results"].values():
            if loss is None:
                slot["crashed"] += 1
            else:
                slot["completed"] += 1
    promotions: Dict[int, List[int]] = {}
    for rec in records:
        if rec.get("event") == E.PROMOTION_DECISION:
            it = rec.get("iteration")
            if isinstance(it, int):
                promotions.setdefault(it, []).append(
                    int(rec.get("n_promoted") or 0)
                )
    rows = []
    for it in sorted(set(planned) | set(per_iter)):
        plan = planned.get(it, {})
        stats = per_iter.get(it, {
            "sampled": 0, "model_based": 0, "completed": 0, "crashed": 0,
        })
        n_planned = plan.get("num_configs")
        planned_evals = (
            int(sum(n_planned)) if isinstance(n_planned, list) else None
        )
        evals = stats["completed"] + stats["crashed"]
        rows.append({
            "iteration": it,
            "planned_configs": n_planned,
            "budgets": plan.get("budgets"),
            "sampled": stats["sampled"],
            "model_based": stats["model_based"],
            "evaluations": evals,
            "crashed": stats["crashed"],
            "promotions_per_rung": promotions.get(it, []),
            "utilization": (
                round(evals / planned_evals, 4)
                if planned_evals else None
            ),
        })
    return rows


def _alert_digest(records: List[Dict[str, Any]], t0: Optional[float]) -> Dict[str, Any]:
    recorded = [r for r in records if r.get("event") == E.ALERT]
    source = "journal"
    alerts = recorded
    if not recorded:
        alerts = scan_records(records)
        source = "offline_scan"
    by_rule: Dict[str, int] = {}
    by_subject: Dict[str, int] = {}
    rows = []
    for a in alerts:
        rule = str(a.get("rule") or "?")
        subject = str(a.get("subject") or "?")
        by_rule[rule] = by_rule.get(rule, 0) + 1
        by_subject[f"{rule}:{subject}"] = by_subject.get(
            f"{rule}:{subject}", 0
        ) + 1
        tw = a.get("t_wall")
        rows.append({
            "at_s": (
                round(float(tw) - t0, 3)
                if isinstance(tw, (int, float)) and t0 is not None else None
            ),
            "rule": rule,
            "subject": subject,
            "source_event": a.get("source_event"),
        })
    return {
        "source": source,
        "total": len(alerts),
        "by_rule": dict(sorted(by_rule.items())),
        "top_subjects": dict(sorted(
            by_subject.items(), key=lambda kv: (-kv[1], kv[0])
        )[:5]),
        # full list: the text renderer caps its table and points at
        # --json, so the dict must actually carry everything
        "alerts": rows,
    }


def _slo_digest(
    records: List[Dict[str, Any]], t0: Optional[float]
) -> Dict[str, Any]:
    """The SLO story of a journal: the re-evaluated burn-rate verdict
    (scan_slo_records is deterministic, so two reports of one journal
    agree) plus the lifecycle transitions — journaled ``slo_alert``
    records when the run carried a live AlertManager, the offline scan's
    otherwise (the _alert_digest source convention)."""
    recorded = [r for r in records if r.get("event") == E.SLO_ALERT]
    mgr = scan_slo_records(records)
    source = "journal"
    transitions = recorded
    if not recorded:
        transitions = list(mgr.transitions)
        source = "offline_scan"
    snap = mgr.snapshot()
    rows = [
        {
            "at_s": (
                round(tr["t_wall"] - t0, 3)
                if t0 is not None and isinstance(
                    tr.get("t_wall"), (int, float)
                ) else None
            ),
            "slo": tr.get("slo"),
            "severity": tr.get("severity"),
            "state": tr.get("state"),
            "burn_short": tr.get("burn_short"),
            "burn_long": tr.get("burn_long"),
            "budget_remaining": tr.get("budget_remaining"),
        }
        for tr in transitions
    ]
    return {
        "source": source,
        "transitions": len(rows),
        "firing": snap["firing"],
        "worst_burn_rate": snap["worst_burn_rate"],
        "by_slo": snap["by_slo"],
        "rows": rows,
    }


# -------------------------------------------------------------------- report
def build_report(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate merged journal records into the report dict."""
    walls = [
        r["t_wall"] for r in records
        if isinstance(r.get("t_wall"), (int, float))
    ]
    t0 = min(walls) if walls else None
    window = (max(walls) - t0) if walls else 0.0
    lineages = config_lineage(records)
    audit_records = sum(
        1 for r in records
        if r.get("event") in (E.CONFIG_SAMPLED, E.PROMOTION_DECISION)
    )
    return {
        "events_total": len(records),
        "window_s": round(window, 3),
        "configs": len(lineages),
        "audit_records": audit_records,
        "incumbent_trajectory": _incumbent_trajectory(records, lineages, t0),
        "model_vs_random": _model_vs_random(lineages),
        "promotion_regret": _promotion_regret(records, lineages),
        "brackets": _brackets(records, lineages),
        # compile economics: a healthy shape-stable sweep compiles each
        # function once; a climbing count here is the journal-side echo
        # of the live recompile_storm rule (one shared aggregation with
        # the summarize CLI — the two views of one journal must agree)
        "runtime": compile_stats_from_records(records, window),
        # the device metrics plane (obs/device_metrics.py): decoded
        # in-trace telemetry of fused/resident sweeps — shared
        # aggregation with summarize, same drift rule as runtime
        "device": device_section_from_records(records),
        "alerts": _alert_digest(records, t0),
        "slo": _slo_digest(records, t0),
    }


def format_report(rep: Dict[str, Any]) -> str:
    lines = [
        "run report",
        f"  events: {rep['events_total']} over {_fmt(rep['window_s'])}s, "
        f"{rep['configs']} configs, {rep['audit_records']} audit records",
        "",
        "incumbent trajectory:",
    ]
    traj = rep["incumbent_trajectory"]
    if traj:
        lines.append(
            f"  {'#':>5} {'t+s':>10} {'config':<14} {'budget':>8} "
            f"{'loss':>12}  pick"
        )
        for row in traj:
            pick = (
                "model" if row["model_based"]
                else "random" if row["model_based"] is not None else "?"
            )
            lines.append(
                f"  {row['n_results']:>5} {_fmt(row['at_s']):>10} "
                f"{json.dumps(row['config_id']):<14} "
                f"{_fmt(row['budget']):>8} {_fmt(row['loss']):>12}  {pick}"
            )
    else:
        lines.append("  (no finished results with losses in this journal)")

    lines += ["", "model vs random (per budget):"]
    mvr = rep["model_vs_random"]["budgets"]
    if mvr:
        lines.append(
            f"  {'budget':>8} {'n_mod':>6} {'n_rnd':>6} {'best_mod':>12} "
            f"{'best_rnd':>12} {'win_rate':>9}"
        )
        for budget, row in mvr.items():
            lines.append(
                f"  {budget:>8} {row['n_model']:>6} {row['n_random']:>6} "
                f"{_fmt(row['best_model']):>12} {_fmt(row['best_random']):>12} "
                f"{_fmt(row['model_win_rate']):>9}"
            )
        if rep["model_vs_random"]["unattributed_configs"]:
            lines.append(
                "  (%d evaluated configs carry no sampling audit record)"
                % rep["model_vs_random"]["unattributed_configs"]
            )
    else:
        lines.append("  (no audit-attributed results in this journal)")

    lines += ["", "promotion regret (per rung decision):"]
    decisions = rep["promotion_regret"]["decisions"]
    if decisions:
        lines.append(
            f"  {'iter':>5} {'rung':>5} {'budget':>8} {'next':>8} "
            f"{'cand':>5} {'prom':>5} {'cut':>12} {'regret':>10} "
            f"{'held':>5} {'inv':>4} {'strag':>5}  rule"
        )
        for d in decisions:
            lines.append(
                f"  {_fmt(d['iteration']):>5} {_fmt(d['rung']):>5} "
                f"{_fmt(d['budget']):>8} {_fmt(d['next_budget']):>8} "
                f"{_fmt(d['n_candidates']):>5} {_fmt(d['n_promoted']):>5} "
                f"{_fmt(d['cut_threshold']):>12} {_fmt(d['rank1_regret']):>10} "
                f"{_fmt(d['rank_held']):>5} {_fmt(d['inversions']):>4} "
                f"{_fmt(d['stragglers_observed']):>5}  "
                f"{d['rule'] or '?'}"
            )
        for rung, agg in rep["promotion_regret"]["per_rung"].items():
            lines.append(
                f"  rung {rung}: {agg['decisions']} decisions, "
                f"mean rank-1 regret {_fmt(agg['mean_rank1_regret'])}, "
                f"rank held {_fmt(agg['rank_held_rate'])}"
            )
    else:
        lines.append("  (no promotion_decision audit records in this journal)")

    lines += ["", "bracket utilization:"]
    if rep["brackets"]:
        lines.append(
            f"  {'iter':>5} {'planned':<16} {'sampled':>8} {'model':>6} "
            f"{'evals':>6} {'crashed':>8} {'util':>6}  promotions"
        )
        for b in rep["brackets"]:
            lines.append(
                f"  {b['iteration']:>5} "
                f"{json.dumps(b['planned_configs']):<16} "
                f"{b['sampled']:>8} {b['model_based']:>6} "
                f"{b['evaluations']:>6} {b['crashed']:>8} "
                f"{_fmt(b['utilization']):>6}  "
                f"{json.dumps(b['promotions_per_rung'])}"
            )
    else:
        lines.append("  (no bracket records in this journal)")

    rt = rep.get("runtime") or {}
    lines += ["", "xla runtime:"]
    if rt.get("compiles"):
        share = rt.get("compile_share_of_wall")
        lines.append(
            f"  {rt['compiles']} compiles, {_fmt(rt['compile_s'])}s compile time"
            + (
                f" ({_fmt(round(100 * share, 2))}% of run wall-clock)"
                if share is not None else ""
            )
        )
        lines.append(
            f"  {'fn':<32} {'compiles':>9} {'recompiles':>11} {'seconds':>10}"
        )
        for row in rt.get("top_recompilers") or []:
            lines.append(
                f"  {row['fn']:<32} {row['compiles']:>9} "
                f"{row['recompiles']:>11} {_fmt(row['compile_s']):>10}"
            )
    else:
        lines.append("  (no xla_compile records in this journal)")

    device = rep.get("device")
    if device:
        lines += [""] + format_device_section(device)

    al = rep["alerts"]
    lines += [
        "",
        f"alert digest ({al['source']}): {al['total']} alerts "
        + json.dumps(al["by_rule"]),
    ]
    for a in al["alerts"][:20]:
        lines.append(
            f"  t+{_fmt(a['at_s'])}s {a['rule']}: {a['subject']} "
            f"(from {a['source_event']})"
        )
    if al["total"] > 20:
        lines.append(f"  ... {al['total'] - 20} more (use --json for all)")

    slo = rep.get("slo") or {}
    if slo.get("by_slo"):
        lines += [
            "",
            "slo verdict ({}): {} firing, worst burn {}".format(
                slo["source"], slo["firing"],
                _fmt(slo["worst_burn_rate"]),
            ),
        ]
        for name, row in slo["by_slo"].items():
            lines.append(
                f"  {name}: burn={_fmt(row.get('burn_rate'))} "
                f"budget_remaining={_fmt(row.get('budget_remaining'))} "
                f"state={row.get('state')}"
            )
        for tr in slo["rows"][:10]:
            lines.append(
                f"  t+{_fmt(tr['at_s'])}s {tr['slo']}[{tr['severity']}] "
                f"-> {tr['state']} (burn {_fmt(tr['burn_short'])}/"
                f"{_fmt(tr['burn_long'])})"
            )
        if slo["transitions"] > 10:
            lines.append(
                f"  ... {slo['transitions'] - 10} more transitions "
                "(use --json for all)"
            )
    lines.append("")
    return "\n".join(lines)
