"""BOHB optimizer: HyperBand bracket arithmetic + the KDE config generator.

Ported from ``hpbandster_tpu/optimizers/bohb.py``: the reference's knob
surface (eta, budgets, min_points_in_model, top_n_percent, num_samples,
random_fraction, bandwidth_factor, min_bandwidth, in_trace_refit), with the
proposals on ``device`` (``None`` means ``cuda``; see
``models/bohb_kde.py``). ``promotion_rule=`` names a rule of
``hpbandster_tpu_torch.promote`` (``asha``, ``pareto``, ``lc_earlystop``,
``successive_halving`` / ``sync``, ``successive_halving_jax``) and selects
its iteration class; without it an explicit ``iteration_class`` does. Each
new bracket emits ``bracket_created`` to the event bus.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.core.master import Master
from hpbandster_tpu_torch.core.successive_halving import SuccessiveHalving
from hpbandster_tpu_torch.models.bohb_kde import BOHBKDE
from hpbandster_tpu_torch.ops.bracket import budget_ladder, hyperband_bracket, max_sh_iterations
from hpbandster_tpu_torch.space import ConfigurationSpace

__all__ = ["BOHB"]


class BOHB(Master):
    def __init__(
        self,
        configspace: Optional[ConfigurationSpace] = None,
        eta: float = 3,
        min_budget: float = 0.01,
        max_budget: float = 1,
        min_points_in_model: Optional[int] = None,
        top_n_percent: int = 15,
        num_samples: int = 64,
        random_fraction: float = 1 / 3,
        bandwidth_factor: float = 3.0,
        min_bandwidth: float = 1e-3,
        seed: Optional[int] = None,
        iteration_class: type = SuccessiveHalving,
        promotion_rule: Optional[str] = None,
        in_trace_refit: Optional[bool] = None,
        device=None,
        **kwargs: Any,
    ):
        if configspace is None:
            raise ValueError("you have to provide a valid ConfigurationSpace object")
        # a rule name resolves to its iteration class before
        # Master.__init__ starts the executor: an unknown name must not
        # leave a started executor behind
        if promotion_rule is not None:
            from hpbandster_tpu_torch.promote import resolve_rule

            iteration_class = resolve_rule(promotion_rule)
        cg = BOHBKDE(
            configspace=configspace,
            min_points_in_model=min_points_in_model,
            top_n_percent=top_n_percent,
            num_samples=num_samples,
            random_fraction=random_fraction,
            bandwidth_factor=bandwidth_factor,
            min_bandwidth=min_bandwidth,
            seed=seed,
            in_trace_refit=in_trace_refit,
            device=device,
        )
        super().__init__(config_generator=cg, **kwargs)
        self.device = cg.device
        self.promotion_rule = promotion_rule
        self.iteration_class = iteration_class

        self.configspace = configspace
        self.eta = float(eta)
        self.min_budget = float(min_budget)
        self.max_budget = float(max_budget)
        self.max_SH_iter = max_sh_iterations(min_budget, max_budget, eta)
        self.budgets = budget_ladder(min_budget, max_budget, eta)

        self.config.update(
            {
                "eta": self.eta,
                "min_budget": self.min_budget,
                "max_budget": self.max_budget,
                "budgets": list(self.budgets),
                "max_SH_iter": self.max_SH_iter,
                "min_points_in_model": cg.min_points_in_model,
                "top_n_percent": top_n_percent,
                "num_samples": num_samples,
                "random_fraction": random_fraction,
                "bandwidth_factor": bandwidth_factor,
                "min_bandwidth": min_bandwidth,
                "promotion_rule": (
                    promotion_rule
                    or getattr(iteration_class, "promotion_rule", None)
                ),
            }
        )

    def iteration_plan(self, iteration: int):
        """The bracket shape global iteration ``iteration`` will run, known
        before any sampling."""
        return hyperband_bracket(
            iteration, self.min_budget, self.max_budget, self.eta
        )

    def get_next_iteration(
        self, iteration: int, iteration_kwargs: Dict[str, Any]
    ) -> SuccessiveHalving:
        plan = self.iteration_plan(iteration)
        obs.emit_bracket_created(
            iteration, plan.num_configs, plan.budgets,
            eta=self.eta, random_fraction=self.config.get("random_fraction"),
        )
        # what an iteration class asks for by class attribute: ASHA the
        # ladder's eta, learning-curve early stopping a sweep-wide
        # incumbent reader for its cut, a device rule the optimizer's device
        extra: Dict[str, Any] = {}
        if getattr(self.iteration_class, "wants_eta", False):
            extra["eta"] = self.eta
        if getattr(self.iteration_class, "wants_cut_fn", False):
            extra["cut_fn"] = self.best_loss_at
        if getattr(self.iteration_class, "wants_device", False):
            extra["device"] = self.device
        return self.iteration_class(
            HPB_iter=iteration,
            num_configs=list(plan.num_configs),
            budgets=list(plan.budgets),
            config_sampler=self.config_generator.get_config,
            **extra,
            **iteration_kwargs,
        )
