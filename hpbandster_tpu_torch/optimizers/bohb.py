"""BOHB optimizer: HyperBand bracket arithmetic + the KDE config generator.

Ported from ``hpbandster_tpu/optimizers/bohb.py``: the reference's knob
surface (eta, budgets, min_points_in_model, top_n_percent, num_samples,
random_fraction, bandwidth_factor, min_bandwidth, in_trace_refit), with the
proposals on ``device`` (``None`` means ``cuda``; see
``models/bohb_kde.py``). ``promotion_rule=`` (the reference's ``promote``
package) is not ported yet (ROADMAP A5b); an explicit ``iteration_class``
still selects the promotion rule.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

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
        # before Master.__init__, which starts the executor
        if promotion_rule is not None:
            raise NotImplementedError(
                f"promotion_rule={promotion_rule!r} is not ported yet (ROADMAP "
                "A5b: promotion rules); pass iteration_class= instead")
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
        self.promotion_rule = None
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
                "promotion_rule": getattr(iteration_class, "promotion_rule", None),
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
        # an iteration class that ranks on a device ranks on the optimizer's
        extra = ({"device": self.device}
                 if getattr(self.iteration_class, "wants_device", False) else {})
        return self.iteration_class(
            HPB_iter=iteration,
            num_configs=list(plan.num_configs),
            budgets=list(plan.budgets),
            config_sampler=self.config_generator.get_config,
            **extra,
            **iteration_kwargs,
        )
