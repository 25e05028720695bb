"""Multi-objective Pareto promotion: rank rungs on (loss, measured cost).

Ported from ``hpbandster_tpu/promote/pareto.py``.

A rung's survivors are picked by the Pareto-front top-k kernel
(``ops/bracket.py``: domination-count fronts peel first, loss breaks
ties inside a front) over two objectives per candidate:

* **loss** — the rung's evaluation result, NaN for crashed configs
  (hard-excluded from promotion, whatever ``k``);
* **cost** — the measured evaluation expense, resolved in feed order:

  1. the ``cost`` the evaluation reported in its info payload (a worker
     measuring device seconds) — the only genuinely per-candidate
     measurement, always preferred;
  2. the **obs-histogram feed**
     (:func:`~hpbandster_tpu_torch.obs.device_metrics.budget_cost_from_obs`):
     the budget's aggregate evaluation cost from the master's
     budget-keyed ``job_run_s`` histograms, else from the
     ``sweep.budget_cost_s.<budget>`` gauges the device-telemetry
     decoder derives — the pipeline's measurement rather than one job's
     noisy span. With no per-candidate measurements the rung's costs
     are then uniform and the Pareto rule degrades EXACTLY to the
     single-objective SH ranking — by design: host-side wall jitter
     must not reorder promotions;
  3. the started->finished wall span the job timestamp schema records
     — the fallback used only when no histogram feed exists.

  An unmeasured cost is NaN -> +inf in the kernel: never an advantage.

The decision stays synchronous (barrier semantics like the paper's
rule — combine with ``asha`` by choosing that rule instead when latency
is the bottleneck); what changes is the ranking. Audit records carry
the per-candidate domination counts (``pareto_rank``) and the cost
column (``costs``), which is what makes recorded journals
Pareto-replayable (``promote/replay.py``).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from hpbandster_tpu_torch.core.iteration import BaseIteration, Datum
from hpbandster_tpu_torch.core.job import ConfigId
from hpbandster_tpu_torch.ops.bracket import (
    pareto_promotion_mask_np,
    pareto_rank_np,
)

__all__ = ["ParetoIteration"]


class ParetoIteration(BaseIteration):
    """Promote the Pareto-best ``num_configs[stage+1]`` by (loss, cost).

    ``cost_fn(datum, budget) -> float | None`` overrides the cost
    measurement (tests pin hand-built fronts with it; a deployment could
    rank on a worker-reported energy counter). ``obs_cost=False`` skips
    the obs-histogram feed (reported cost -> wall span, the pre-feed
    behavior); ``cost_registry`` points the feed at a specific metrics
    registry (tests — default: the process registry).
    """

    promotion_rule = "pareto"

    def __init__(
        self,
        *args,
        cost_fn: Optional[Callable[[Datum, float], Optional[float]]] = None,
        obs_cost: bool = True,
        cost_registry=None,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.cost_fn = cost_fn
        self.obs_cost = bool(obs_cost)
        self.cost_registry = cost_registry
        #: (budget, feed value) of the last obs-feed lookup: a rung
        #: decision calls promotion_cost once per candidate (and again
        #: for the audit costs list) at ONE budget, and each raw lookup
        #: snapshots the whole registry — resolve it once per budget,
        #: not once per candidate
        self._feed_cache: Optional[tuple] = None

    def _obs_feed(self, budget: float) -> Optional[float]:
        if not self.obs_cost:
            return None
        key = float(budget)
        if self._feed_cache is not None and self._feed_cache[0] == key:
            return self._feed_cache[1]
        from hpbandster_tpu_torch.obs.device_metrics import budget_cost_from_obs

        feed = budget_cost_from_obs(key, registry=self.cost_registry)
        # caching per budget also makes the decision self-consistent: a
        # histogram update landing mid-rung cannot hand two candidates
        # different aggregate costs
        self._feed_cache = (key, feed)
        return feed

    def promotion_cost(self, config_id: ConfigId, budget: float):
        """The audit record's cost column IS the ranking input here.

        Feed order (module docstring): explicit ``cost_fn`` >
        per-candidate reported cost > obs-histogram aggregate
        (:func:`~hpbandster_tpu_torch.obs.device_metrics.budget_cost_from_obs`,
        resolved once per budget) > per-job wall span — spans only when
        no histogram feed exists.
        """
        if self.cost_fn is not None:
            cost = self.cost_fn(self.data[config_id], budget)
            return float(cost) if cost is not None else None
        reported = self.reported_cost(config_id, budget)
        if reported is not None:
            return reported
        feed = self._obs_feed(budget)
        if feed is not None:
            return feed
        return self.wall_span_cost(config_id, budget)

    def _cost_of(self, config_id: ConfigId, budget: float) -> float:
        cost = self.promotion_cost(config_id, budget)
        return float(cost) if cost is not None else np.nan

    def _advance_to_next_stage(
        self, config_ids: List[ConfigId], losses: np.ndarray
    ) -> np.ndarray:
        budget = self.budgets[self.stage]
        costs = np.array(
            [self._cost_of(cid, budget) for cid in config_ids],
            dtype=np.float64,
        )
        objectives = np.column_stack([losses, costs])
        ranks = pareto_rank_np(objectives)
        k = self.num_configs[self.stage + 1]
        mask = pareto_promotion_mask_np(objectives, k)
        # the audit record must show what the decision ranked by: the
        # domination counts (None for crashed rows, which never promote)
        self.last_pareto_ranks = [
            None if np.isnan(l) else int(r)
            for r, l in zip(ranks, losses)
        ]
        self.last_promotion_scores = [
            None if np.isnan(l) else float(r)
            for r, l in zip(ranks, losses)
        ]
        return mask
