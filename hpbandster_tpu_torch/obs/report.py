"""Run reports: ``promotion_hindsight``, the rank-1 regret and rank
inversions of one promotion judged against next-budget results.

Ported from ``hpbandster_tpu/obs/report.py`` (a copy of
``promotion_hindsight`` alone): the promotion replay harness
(``promote/replay.py``) judges every decision through it. The rest of the
reference's report (incumbent trajectory, model-vs-random win rate, bracket
utilization, runtime, alert and SLO digests) waits for the port's analysis
modules (ROADMAP A8).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from hpbandster_tpu_torch.obs.audit import config_key
from hpbandster_tpu_torch.obs.device_metrics import finite_or_none as _finite

__all__ = ["promotion_hindsight"]


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
