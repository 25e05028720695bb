"""Bracket bookkeeping: Datum + BaseIteration.

Reference semantics (SURVEY.md §2 "BaseIteration" row, §3.1/§3.3 call
stacks): one iteration object tracks one successive-halving bracket; each
config is a ``Datum`` with per-budget results/timestamps/exceptions and a
status in {QUEUED, RUNNING, REVIEW, TERMINATED, COMPLETED, CRASHED}. The
promotion decision itself (``_advance_to_next_stage``) is abstract.

A struct-of-arrays view (:meth:`BaseIteration.loss_matrix`) exposes the
bracket's state as NaN-masked arrays.

Ported from ``hpbandster_tpu/core/iteration.py``: host bookkeeping, no jax.
Every config's birth (``config_sampled``) and every rung's promotion
(``bracket_promotion`` and the ``promotion_decision`` audit record, with
the rule's scores, Pareto ranks and costs) go to the port's event bus
(``hpbandster_tpu_torch.obs``); the cost accessors (``reported_cost``,
``wall_span_cost``, ``measured_cost``, ``promotion_cost``) give the cost
column, paid for only when a sink listens.
"""

from __future__ import annotations

import logging
from enum import IntEnum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.core.job import ConfigId, Job

__all__ = ["Status", "Datum", "BaseIteration"]


class Status(IntEnum):
    """Config lifecycle states, int8-codeable for array form."""

    QUEUED = 0
    RUNNING = 1
    REVIEW = 2
    TERMINATED = 3
    COMPLETED = 4
    CRASHED = 5


class Datum:
    """Per-config bookkeeping inside one bracket."""

    def __init__(
        self,
        config: Dict[str, Any],
        config_info: Dict[str, Any],
        results: Optional[Dict[float, Optional[float]]] = None,
        time_stamps: Optional[Dict[float, Dict[str, float]]] = None,
        exceptions: Optional[Dict[float, Optional[str]]] = None,
        status: Status = Status.QUEUED,
        budget: float = 0.0,
    ):
        self.config = config
        self.config_info = config_info
        self.results: Dict[float, Optional[float]] = results or {}
        self.time_stamps: Dict[float, Dict[str, float]] = time_stamps or {}
        self.exceptions: Dict[float, Optional[str]] = exceptions or {}
        #: per-budget user 'info' payloads from compute()/eval backends
        self.infos: Dict[float, Any] = {}
        self.status = status
        self.budget = budget

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"Datum(status={self.status.name}, budget={self.budget}, "
            f"results={self.results})"
        )


class BaseIteration:
    """One successive-halving bracket.

    Parameters mirror the reference constructor
    (``BaseIteration.__init__(HPB_iter, num_configs, budgets, config_sampler)``,
    SURVEY.md §2): ``num_configs[i]`` configs evaluated at ``budgets[i]`` in
    stage ``i``; ``config_sampler(budget) -> (config, info)`` proposes fresh
    configs (the config-generator seam that makes BOHB = HyperBand + KDE).
    """

    #: audit label for promotion_decision records (obs/audit.py);
    #: subclasses with a different promotion rule override it
    promotion_rule: str = "successive_halving"

    def __init__(
        self,
        HPB_iter: int,
        num_configs: Sequence[int],
        budgets: Sequence[float],
        config_sampler: Callable[[float], Tuple[Dict[str, Any], Dict[str, Any]]],
        logger: Optional[logging.Logger] = None,
        result_logger: Optional[Any] = None,
        config_sampler_batch: Optional[
            Callable[[float, int], List[Tuple[Dict[str, Any], Dict[str, Any]]]]
        ] = None,
    ):
        if len(num_configs) != len(budgets):
            raise ValueError("num_configs and budgets must have equal length")
        self.HPB_iter = int(HPB_iter)
        self.num_configs = [int(n) for n in num_configs]
        self.budgets = [float(b) for b in budgets]
        self.config_sampler = config_sampler
        #: optional whole-stage sampler (batched executors): one vmapped
        #: proposal kernel instead of n sequential get_config calls
        self.config_sampler_batch = config_sampler_batch
        self.logger = logger or logging.getLogger("hpbandster_tpu_torch")
        self.result_logger = result_logger

        self.stage = 0
        self.data: Dict[ConfigId, Datum] = {}
        #: configs actually added per stage (promotions + fresh samples)
        self.actual_num_configs = [0] * len(num_configs)
        self.is_finished = False
        self.num_running = 0
        #: a promotion rule that ranks by something other than the raw
        #: losses (H2BO extrapolation) stashes its per-candidate scores
        #: here from _advance_to_next_stage; they ride the audit record
        self.last_promotion_scores: Optional[List[Optional[float]]] = None
        #: multi-objective rules (promote/pareto.py) additionally stash
        #: the per-candidate Pareto domination counts here — the audit
        #: record then shows the front structure the decision ranked by
        self.last_pareto_ranks: Optional[List[Optional[int]]] = None

    # ------------------------------------------------------------- properties
    @property
    def n_stages(self) -> int:
        return len(self.num_configs)

    def add_configuration(
        self,
        config: Optional[Dict[str, Any]] = None,
        config_info: Optional[Dict[str, Any]] = None,
    ) -> ConfigId:
        """Register a fresh config for the current stage.

        Config ids are ``(HPB_iter, stage_sampled, index)`` triples — the same
        three-int shape the reference uses, so the JSONL log format and all
        ``Result`` tooling are interchangeable.
        """
        if config is None:
            config, config_info = self.config_sampler(self.budgets[self.stage])
        config_info = config_info or {}
        if self.is_finished:
            raise RuntimeError("iteration is finished, cannot add configurations")
        if self.actual_num_configs[self.stage] >= self.num_configs[self.stage]:
            raise RuntimeError(
                f"stage {self.stage} of iteration {self.HPB_iter} is already full"
            )
        config_id: ConfigId = (
            self.HPB_iter,
            self.stage,
            self.actual_num_configs[self.stage],
        )
        self.data[config_id] = Datum(
            config=config,
            config_info=config_info,
            budget=self.budgets[self.stage],
        )
        self.actual_num_configs[self.stage] += 1
        if self.result_logger is not None:
            self.result_logger.new_config(config_id, config, config_info)
        # the audit trail's birth record: the one place a config receives
        # its id, so the generator's decision details (model vs random,
        # KDE budget, l/g score — riding config_info) get linked to it
        obs.emit_config_sampled(
            config_id, self.budgets[self.stage], config_info
        )
        return config_id

    def get_next_run(self) -> Optional[Tuple[ConfigId, Dict[str, Any], float]]:
        """Hand out one (config_id, config, budget) ready to evaluate, or None.

        Reference logic (SURVEY.md §3.1): first any QUEUED datum at the
        current stage; otherwise sample a fresh config if the stage still has
        quota; otherwise nothing until results arrive.
        """
        if self.is_finished:
            return None
        for config_id, datum in self.data.items():
            if datum.status == Status.QUEUED:
                assert datum.budget == self.budgets[self.stage], (
                    f"queued budget {datum.budget} != stage budget "
                    f"{self.budgets[self.stage]}"
                )
                datum.status = Status.RUNNING
                self.num_running += 1
                return (config_id, datum.config, datum.budget)
        if self.actual_num_configs[self.stage] < self.num_configs[self.stage]:
            if self.config_sampler_batch is not None:
                # fill the whole remaining stage quota in one batched call
                k = self.num_configs[self.stage] - self.actual_num_configs[self.stage]
                for cfg, info in self.config_sampler_batch(
                    self.budgets[self.stage], k
                ):
                    self.add_configuration(cfg, info)
            else:
                self.add_configuration()
            return self.get_next_run()
        return None

    def register_result(self, job: Job, skip_sanity_checks: bool = False) -> None:
        """Record a finished job into its datum (RUNNING -> REVIEW/CRASHED)."""
        if self.is_finished:
            raise RuntimeError("iteration is finished, cannot register results")
        config_id = job.id
        budget = job.kwargs["budget"]
        datum = self.data[config_id]
        if not skip_sanity_checks:
            if datum.status != Status.RUNNING:
                raise RuntimeError(
                    f"result for {config_id} in status {datum.status.name}"
                )
            if datum.budget != budget:
                raise RuntimeError(
                    f"result budget {budget} != datum budget {datum.budget}"
                )
        loss = job.loss
        datum.results[budget] = None if np.isnan(loss) else loss
        datum.exceptions[budget] = job.exception
        datum.time_stamps[budget] = dict(job.timestamps)
        if isinstance(job.result, dict) and "info" in job.result:
            datum.infos[budget] = job.result["info"]
        # crashed evaluations stay in the bracket as REVIEW with a None loss —
        # they are simply never promoted (reference: crashed-as-worst, §5)
        datum.status = Status.REVIEW
        self.num_running -= 1

    def process_results(self) -> bool:
        """If the current stage is complete, advance the bracket one stage.

        Returns True when the bracket advanced (or finished). Reference flow
        (SURVEY.md §3.3): gather REVIEW losses, ask the promotion rule for a
        mask, promoted configs re-queue at the next budget, the rest
        TERMINATE; after the last stage survivors COMPLETE.
        """
        if self.is_finished:
            return False
        stage_full = (
            self.actual_num_configs[self.stage] == self.num_configs[self.stage]
        )
        all_reviewed = all(
            d.status == Status.REVIEW
            for d in self.data.values()
            if d.budget == self.budgets[self.stage]
        ) and any(d.budget == self.budgets[self.stage] for d in self.data.values())
        if not (stage_full and all_reviewed and self.num_running == 0):
            return False

        budget = self.budgets[self.stage]
        config_ids = [
            cid for cid, d in self.data.items() if d.budget == budget
        ]
        losses = np.array(
            [
                np.nan if self.data[cid].results.get(budget) is None
                else self.data[cid].results[budget]
                for cid in config_ids
            ],
            dtype=np.float64,
        )

        if self.stage == self.n_stages - 1:
            for cid in config_ids:
                d = self.data[cid]
                d.status = (
                    Status.CRASHED
                    if d.results.get(budget) is None
                    else Status.COMPLETED
                )
            self.is_finished = True
            self.logger.debug(
                "iteration %d finished (%d configs at final budget %g)",
                self.HPB_iter, len(config_ids), budget,
            )
            return True

        self.last_promotion_scores = None
        self.last_pareto_ranks = None
        advance = self._advance_to_next_stage(config_ids, losses)
        rung = self.stage
        self.stage += 1
        next_budget = self.budgets[self.stage]
        for cid, promote in zip(config_ids, advance):
            d = self.data[cid]
            if promote:
                d.status = Status.QUEUED
                d.budget = next_budget
                self.actual_num_configs[self.stage] += 1
            else:
                d.status = (
                    Status.CRASHED if d.results.get(budget) is None
                    else Status.TERMINATED
                )
        obs.emit_bracket_promotion(
            self.HPB_iter, rung, self.promotion_rule,
            promoted=int(np.sum(advance)), candidates=len(config_ids),
            budget=budget, next_budget=next_budget,
        )
        # the audit twin: full per-candidate detail (losses, mask, cut
        # threshold, rule scores, measured costs) — what report's regret
        # table and the promote/replay.py harness re-score
        obs.emit_promotion_decision(
            self.HPB_iter, rung, budget, next_budget,
            config_ids=config_ids,
            losses=[None if np.isnan(l) else float(l) for l in losses],
            promoted=[bool(a) for a in advance],
            rule=self.promotion_rule,
            scores=self.last_promotion_scores,
            pareto_rank=self.last_pareto_ranks,
            # bus-gated: the emitter discards everything when no sink is
            # attached, so the O(n) cost measurement must not be paid
            # eagerly on the no-sink fast path
            costs=(
                [self.promotion_cost(cid, budget) for cid in config_ids]
                if obs.get_bus().active else None
            ),
        )
        self.last_promotion_scores = None
        self.last_pareto_ranks = None
        self.logger.debug(
            "iteration %d advanced to stage %d (%d promoted)",
            self.HPB_iter, self.stage, int(np.sum(advance)),
        )
        return True

    def _advance_to_next_stage(
        self, config_ids: List[ConfigId], losses: np.ndarray
    ) -> np.ndarray:
        """bool[n] promotion mask — implemented by subclasses."""
        raise NotImplementedError

    def reported_cost(
        self, config_id: ConfigId, budget: float
    ) -> Optional[float]:
        """The explicit ``cost`` an evaluation reported in its info
        payload (a worker measuring device seconds, not wall) — the only
        genuinely PER-CANDIDATE cost measurement; None when the
        evaluation reported none. Split out of :meth:`measured_cost` so
        cost-aware promotion (promote/pareto.py) can prefer a reported
        measurement, then an obs-histogram aggregate, and fall back to
        the wall span only when neither exists."""
        d = self.data.get(config_id)
        if d is None:
            return None
        info = d.infos.get(budget)
        if isinstance(info, dict):
            cost = info.get("cost")
            if isinstance(cost, (int, float)) and np.isfinite(cost):
                return float(cost)
        return None

    def wall_span_cost(
        self, config_id: ConfigId, budget: float
    ) -> Optional[float]:
        """The started->finished wall span the job's timestamp schema
        records — the noisiest cost estimate (queue/dispatch jitter
        included), kept as the last-resort fallback."""
        d = self.data.get(config_id)
        if d is None:
            return None
        ts = d.time_stamps.get(budget) or {}
        try:
            span = float(ts["finished"]) - float(ts["started"])
        except (KeyError, TypeError, ValueError):
            return None
        return span if np.isfinite(span) and span >= 0 else None

    def measured_cost(
        self, config_id: ConfigId, budget: float
    ) -> Optional[float]:
        """Measured evaluation cost (seconds) of one config at one rung,
        or None when unmeasured.

        Priority: an explicit ``cost`` the evaluation reported in its
        info payload (:meth:`reported_cost`), then the started->finished
        wall span (:meth:`wall_span_cost`). This is the cost column
        multi-objective promotion ranks (promote/pareto.py) and what
        rides ``promotion_decision.costs`` so a recorded journal stays
        Pareto-replayable.
        """
        cost = self.reported_cost(config_id, budget)
        if cost is not None:
            return cost
        return self.wall_span_cost(config_id, budget)

    def promotion_cost(
        self, config_id: ConfigId, budget: float
    ) -> Optional[float]:
        """The cost column the audit record journals. Default: the
        measured cost. A rule ranking by a custom cost (ParetoIteration's
        ``cost_fn``) overrides this so ``promotion_decision.costs``
        carries the numbers the decision ACTUALLY used — the replay
        harness's Pareto re-scoring depends on that fidelity."""
        return self.measured_cost(config_id, budget)

    # ------------------------------------------------------- array interface
    def loss_matrix(self) -> Tuple[List[ConfigId], np.ndarray]:
        """Struct-of-arrays view: ``(ids, f64[n_configs, n_stages])`` NaN-masked."""
        ids = list(self.data.keys())
        mat = np.full((len(ids), self.n_stages), np.nan)
        for i, cid in enumerate(ids):
            for j, b in enumerate(self.budgets):
                v = self.data[cid].results.get(b)
                if v is not None:
                    mat[i, j] = v
        return ids, mat

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"{type(self).__name__}(iter={self.HPB_iter}, stage={self.stage}/"
            f"{self.n_stages}, configs={self.actual_num_configs}, "
            f"finished={self.is_finished})"
        )
