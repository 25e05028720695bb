"""Concrete iteration type: SuccessiveHalving.

Ported from ``hpbandster_tpu/core/successive_halving.py``: host bookkeeping,
no jax. The promotion rule is the host twin ``sh_promotion_mask_np`` from
``ops/bracket.py``. ``SuccessiveResampling`` and the device-ranked
``JaxSuccessiveHalving`` belong to the per-bracket path and are not ported
yet.
"""

from __future__ import annotations

from typing import List

import numpy as np

from hpbandster_tpu_torch.core.iteration import BaseIteration
from hpbandster_tpu_torch.core.job import ConfigId
from hpbandster_tpu_torch.ops.bracket import sh_promotion_mask_np

__all__ = ["SuccessiveHalving"]


class SuccessiveHalving(BaseIteration):
    """Promote the best ``num_configs[next_stage]`` configs by loss rank."""

    promotion_rule = "successive_halving"

    def _advance_to_next_stage(
        self, config_ids: List[ConfigId], losses: np.ndarray
    ) -> np.ndarray:
        k = self.num_configs[self.stage + 1]
        return sh_promotion_mask_np(losses, k)
