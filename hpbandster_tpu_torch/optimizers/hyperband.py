"""HyperBand optimizer (random sampling + successive halving).

Ported from ``hpbandster_tpu/optimizers/hyperband.py``: the bracket
arithmetic of ``ops/bracket.py`` and the reference's ``HB_config``
bookkeeping (eta, budget ladder, max_SH_iter), so ``Result`` consumers see
the same metadata.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from hpbandster_tpu_torch.core.master import Master
from hpbandster_tpu_torch.core.successive_halving import SuccessiveHalving
from hpbandster_tpu_torch.models.random_sampling import RandomSampling
from hpbandster_tpu_torch.ops.bracket import budget_ladder, hyperband_bracket, max_sh_iterations
from hpbandster_tpu_torch.space import ConfigurationSpace

__all__ = ["HyperBand"]


class HyperBand(Master):
    def __init__(
        self,
        configspace: Optional[ConfigurationSpace] = None,
        eta: float = 3,
        min_budget: float = 0.01,
        max_budget: float = 1,
        seed: Optional[int] = None,
        iteration_class: type = SuccessiveHalving,
        **kwargs: Any,
    ):
        if configspace is None:
            raise ValueError("you have to provide a valid ConfigurationSpace object")
        cg = RandomSampling(configspace, seed=seed)
        super().__init__(config_generator=cg, **kwargs)
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
            }
        )

    def iteration_plan(self, iteration: int):
        """Bracket shape for iteration ``iteration``, known before sampling."""
        return hyperband_bracket(
            iteration, self.min_budget, self.max_budget, self.eta
        )

    def get_next_iteration(
        self, iteration: int, iteration_kwargs: Dict[str, Any]
    ) -> SuccessiveHalving:
        plan = self.iteration_plan(iteration)
        return self.iteration_class(
            HPB_iter=iteration,
            num_configs=list(plan.num_configs),
            budgets=list(plan.budgets),
            config_sampler=self.config_generator.get_config,
            **iteration_kwargs,
        )
