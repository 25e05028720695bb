"""ASHA — asynchronous successive halving, no rung barrier.

Ported from ``hpbandster_tpu/promote/asha.py``.

Reference: Li et al., "A System for Massively Parallel Hyperparameter
Tuning" (MLSys 2020) — the ASHA promotion rule; see PAPERS.md for the
HyperBand analysis this leans on (losses only need to be comparable
WITHIN a rung, so a promotion never has to wait for the rung to fill).

The synchronous rule (``core/successive_halving.py``) advances a bracket
stage-at-a-time: every config of the rung must reach REVIEW before any
is promoted, so one chaos-delayed worker — exactly the straggler the
anomaly detector flags — stalls the whole rung. Here a config is
promoted the moment it ranks inside the top ``floor(n_done / eta)`` of
its rung's COMPLETED results:

* promotions are decided per result arrival
  (:meth:`ASHAIteration.process_results` runs in the master's
  ``job_callback``), so jobs at higher budgets dispatch while lower
  rungs are still running;
* :meth:`get_next_run` prefers the highest-rung QUEUED config (the
  standard ASHA "promote before sampling" order), then falls back to
  sampling fresh rung-0 configs up to the bracket's stage-0 quota;
* rungs above 0 have NO quota: an early promotion that later falls out
  of the top ``1/eta`` is ASHA's documented over-promotion cost, paid
  for wait-free liveness. On a fully completed rung the promoted set
  CONTAINS the synchronous rule's top-k (ranking is the same f32
  double-argsort as ``sh_promotion_mask_np``, so host/device parity
  holds config-for-config);
* crashed configs (NaN loss) rank last and never promote — the same
  crashed-as-worst contract as the sync rule.

On a batched executor a flush delivers a whole wave, one result at a
time, and each delivery runs :meth:`ASHAIteration.process_results`.
Promoted configs keep the bracket's stage 0 (this rule never advances
``stage``), so the executor sees them as a partial stage-0 wave and
evaluates them stage-batched, or serves them from a fused bracket's cache
where the device promoted the same config.

Audit: every promotion wave at a rung emits one ``bracket_promotion``
event and one ``promotion_decision`` record with ``rule="asha"``, the
rung's full completed candidate set, and the NEWLY promoted mask — the
granularity the replay/regret harness (``promote/replay.py``) re-scores.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.core.iteration import BaseIteration, Datum, Status
from hpbandster_tpu_torch.core.job import ConfigId
from hpbandster_tpu_torch.ops.bracket import sh_promotion_mask_np

__all__ = ["ASHAIteration"]


class ASHAIteration(BaseIteration):
    """One ASHA bracket: eager top-``1/eta`` promotion, no barrier."""

    promotion_rule = "asha"
    #: optimizer hint (BOHB.get_next_iteration): pass eta explicitly so
    #: the rule does not have to re-derive it from the budget ladder
    wants_eta = True

    def __init__(self, *args, eta: Optional[float] = None, **kwargs):
        super().__init__(*args, **kwargs)
        if eta is None:
            # the budget ladder is geometric by construction, so the
            # rung ratio IS eta; single-stage brackets never promote
            eta = (
                self.budgets[1] / self.budgets[0]
                if len(self.budgets) > 1 else 2.0
            )
        if eta <= 1:
            raise ValueError(f"need eta > 1, got {eta}")
        self.eta = float(eta)
        self._rung_of: Dict[float, int] = {
            b: i for i, b in enumerate(self.budgets)
        }

    # ------------------------------------------------------------- dispatch
    def get_next_run(self) -> Optional[Tuple[ConfigId, dict, float]]:
        """Highest-rung QUEUED config first (promotions beat fresh
        samples — the deeper the rung, the more evidence behind the
        config), then fresh rung-0 samples up to the stage-0 quota."""
        if self.is_finished:
            return None
        best_cid: Optional[ConfigId] = None
        best_rung = -1
        for cid, datum in self.data.items():
            if datum.status == Status.QUEUED:
                rung = self._rung_of[datum.budget]
                if rung > best_rung:
                    best_rung, best_cid = rung, cid
        if best_cid is not None:
            datum = self.data[best_cid]
            datum.status = Status.RUNNING
            self.num_running += 1
            return (best_cid, datum.config, datum.budget)
        if self.actual_num_configs[0] < self.num_configs[0]:
            self.add_configuration()
            return self.get_next_run()
        return None

    # ------------------------------------------------------------ promotion
    def process_results(self) -> bool:
        """Promote every currently-promotable config (called per result
        from the master's ``job_callback``); finish the bracket when the
        stage-0 quota is spent and nothing is queued, running, or
        promotable."""
        if self.is_finished:
            return False
        advanced = self._promote_ready()
        if (
            self.num_running == 0
            and self.actual_num_configs[0] >= self.num_configs[0]
            and not any(
                d.status == Status.QUEUED for d in self.data.values()
            )
        ):
            self._finalize()
            return True
        return advanced

    def _rung_census(
        self, rung: int
    ) -> Tuple[List[ConfigId], List[Datum], np.ndarray]:
        """Every config with a terminal result at ``rung`` (crashed
        included — they widen ``n_done`` exactly like the reference's
        crashed-as-worst), in insertion order, with NaN-masked losses."""
        budget = self.budgets[rung]
        ids: List[ConfigId] = []
        data: List[Datum] = []
        for cid, datum in self.data.items():
            if budget in datum.results:
                ids.append(cid)
                data.append(datum)
        losses = np.array(
            [
                np.nan if d.results[budget] is None else d.results[budget]
                for d in data
            ],
            dtype=np.float64,
        )
        return ids, data, losses

    def _promote_ready(self) -> bool:
        advanced = False
        for rung in range(self.n_stages - 1):
            budget = self.budgets[rung]
            ids, data, losses = self._rung_census(rung)
            n_done = len(ids)
            k = int(n_done // self.eta)
            if k <= 0:
                continue
            top = sh_promotion_mask_np(losses, k)
            # newly promotable: inside the top 1/eta, still sitting at
            # this rung in REVIEW, and not crashed. Configs promoted
            # earlier occupy their top slots naturally (their rung loss
            # still ranks), so a worse config cannot slip in behind them.
            fresh = np.array(
                [
                    bool(m)
                    and d.status == Status.REVIEW
                    and d.budget == budget
                    and not np.isnan(l)
                    for m, d, l in zip(top, data, losses)
                ],
                dtype=bool,
            )
            if not fresh.any():
                continue
            advanced = True
            next_budget = self.budgets[rung + 1]
            for cid, d, promote in zip(ids, data, fresh):
                if promote:
                    d.status = Status.QUEUED
                    d.budget = next_budget
                    self.actual_num_configs[rung + 1] += 1
            n_new = int(fresh.sum())
            obs.emit_bracket_promotion(
                self.HPB_iter, rung, self.promotion_rule,
                promoted=n_new, candidates=n_done,
                budget=budget, next_budget=next_budget,
            )
            obs.emit_promotion_decision(
                self.HPB_iter, rung, budget, next_budget,
                config_ids=ids,
                losses=[None if np.isnan(l) else float(l) for l in losses],
                promoted=[bool(p) for p in fresh],
                rule=self.promotion_rule,
                # bus-gated like the sync path: no sink, no O(n)
                # cost-measurement bill
                costs=(
                    [self.measured_cost(cid, budget) for cid in ids]
                    if obs.get_bus().active else None
                ),
            )
            self.logger.debug(
                "iteration %d asha promoted %d/%d at rung %d",
                self.HPB_iter, n_new, n_done, rung,
            )
        return advanced

    def _finalize(self) -> None:
        final_budget = self.budgets[-1]
        for datum in self.data.values():
            if datum.status != Status.REVIEW:
                continue
            if datum.results.get(datum.budget) is None:
                datum.status = Status.CRASHED
            elif datum.budget == final_budget:
                datum.status = Status.COMPLETED
            else:
                datum.status = Status.TERMINATED
        self.is_finished = True
        self.logger.debug(
            "iteration %d finished (asha, %d configs)",
            self.HPB_iter, len(self.data),
        )

    def _advance_to_next_stage(
        self, config_ids: List[ConfigId], losses: np.ndarray
    ) -> np.ndarray:  # pragma: no cover - the async path never calls it
        raise RuntimeError(
            "ASHAIteration promotes per result; the stage barrier "
            "path must never run"
        )
