"""RandomSearch baseline: every config evaluated at max_budget.

Ported from ``hpbandster_tpu/optimizers/randomsearch.py``: single-stage
successive-halving iterations sized like the matching HyperBand bracket's
first stage, all at the maximum budget.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from hpbandster_tpu_torch.core.master import Master
from hpbandster_tpu_torch.core.successive_halving import SuccessiveHalving
from hpbandster_tpu_torch.models.random_sampling import RandomSampling
from hpbandster_tpu_torch.ops.bracket import BracketPlan, hyperband_bracket, max_sh_iterations
from hpbandster_tpu_torch.space import ConfigurationSpace

__all__ = ["RandomSearch"]


class RandomSearch(Master):
    def __init__(
        self,
        configspace: Optional[ConfigurationSpace] = None,
        eta: float = 3,
        min_budget: float = 1,
        max_budget: float = 1,
        seed: Optional[int] = None,
        **kwargs: Any,
    ):
        if configspace is None:
            raise ValueError("you have to provide a valid ConfigurationSpace object")
        cg = RandomSampling(configspace, seed=seed)
        super().__init__(config_generator=cg, **kwargs)

        self.configspace = configspace
        self.eta = float(eta)
        self.min_budget = float(min_budget)
        self.max_budget = float(max_budget)
        self.max_SH_iter = max_sh_iterations(min_budget, max_budget, eta)

        self.config.update(
            {
                "eta": self.eta,
                "min_budget": self.min_budget,
                "max_budget": self.max_budget,
                "budgets": [self.max_budget],
                "max_SH_iter": self.max_SH_iter,
            }
        )

    def iteration_plan(self, iteration: int) -> BracketPlan:
        """Single stage, as many configs as the matching HyperBand bracket's
        first stage, at the maximum budget."""
        base = hyperband_bracket(
            iteration, self.min_budget, self.max_budget, self.eta
        )
        return BracketPlan(
            num_configs=(base.num_configs[0],), budgets=(self.max_budget,)
        )

    def get_next_iteration(
        self, iteration: int, iteration_kwargs: Dict[str, Any]
    ) -> SuccessiveHalving:
        plan = self.iteration_plan(iteration)
        return SuccessiveHalving(
            HPB_iter=iteration,
            num_configs=list(plan.num_configs),
            budgets=list(plan.budgets),
            config_sampler=self.config_generator.get_config,
            **iteration_kwargs,
        )
