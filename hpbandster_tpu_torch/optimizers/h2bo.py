"""H2BO — BOHB with learning-curve-informed promotion.

Ported from ``hpbandster_tpu/optimizers/h2bo.py``: BOHB's bracket arithmetic
and KDE proposals, but stage promotion ranks configs by a learning-curve
extrapolation of their loss to the bracket's final budget
(``models.learning_curves.PowerLawModel``, on the host) instead of the raw
current-stage loss.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from hpbandster_tpu_torch.core.iteration import BaseIteration
from hpbandster_tpu_torch.core.job import ConfigId
from hpbandster_tpu_torch.models.learning_curves import PowerLawModel
from hpbandster_tpu_torch.ops.bracket import sh_promotion_mask_np
from hpbandster_tpu_torch.optimizers.bohb import BOHB

__all__ = ["H2BO", "LCExtrapolationIteration"]


class LCExtrapolationIteration(BaseIteration):
    """Promote by extrapolated final-budget loss instead of current loss."""

    promotion_rule = "lc_extrapolation"

    def __init__(self, *args, lc_model=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.lc_model = lc_model or PowerLawModel()
        #: the scores the last promotion ranked by (None where crashed)
        self.last_promotion_scores = None

    def _advance_to_next_stage(
        self, config_ids: List[ConfigId], losses: np.ndarray
    ) -> np.ndarray:
        target = self.budgets[-1]
        extrapolated = np.array(
            [
                self.lc_model.predict(
                    [
                        (b, v)
                        for b, v in sorted(self.data[cid].results.items())
                        if v is not None
                    ],
                    target,
                )
                for cid in config_ids
            ]
        )
        # the raw stage loss where the extrapolation is undefined
        scores = np.where(np.isnan(extrapolated), losses, extrapolated)
        # crashed configs (NaN raw loss) stay NaN: never promoted
        scores = np.where(np.isnan(losses), np.nan, scores)
        self.last_promotion_scores = [
            None if np.isnan(s) else float(s) for s in scores
        ]
        k = self.num_configs[self.stage + 1]
        return sh_promotion_mask_np(scores.astype(np.float32), k)


class H2BO(BOHB):
    def __init__(self, *args, lc_model=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.lc_model = lc_model or PowerLawModel()

    def get_next_iteration(
        self, iteration: int, iteration_kwargs: Dict[str, Any]
    ) -> LCExtrapolationIteration:
        plan = self.iteration_plan(iteration)
        return LCExtrapolationIteration(
            HPB_iter=iteration,
            num_configs=list(plan.num_configs),
            budgets=list(plan.budgets),
            config_sampler=self.config_generator.get_config,
            lc_model=self.lc_model,
            **iteration_kwargs,
        )
