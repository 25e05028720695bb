"""Concrete iteration types: SuccessiveHalving, SuccessiveResampling and
JaxSuccessiveHalving.

Ported from ``hpbandster_tpu/core/successive_halving.py``: host bookkeeping,
no jax. ``SuccessiveHalving`` and ``SuccessiveResampling`` rank with the host
rule ``sh_promotion_mask_np``; ``JaxSuccessiveHalving`` keeps its name, so
``iteration_class=`` code maps one to one, and ranks with
``sh_promotion_mask`` on a torch device (the optimizer's, by default the
card). The two rules are the same function: NaN ranks as +inf, float32,
stable double argsort.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from hpbandster_tpu_torch.core.iteration import BaseIteration
from hpbandster_tpu_torch.core.job import ConfigId
from hpbandster_tpu_torch.device import resolve_device
from hpbandster_tpu_torch.ops.bracket import sh_promotion_mask, sh_promotion_mask_np

__all__ = ["SuccessiveHalving", "SuccessiveResampling", "JaxSuccessiveHalving"]


class SuccessiveHalving(BaseIteration):
    """Promote the best ``num_configs[next_stage]`` configs by loss rank."""

    promotion_rule = "successive_halving"

    def _advance_to_next_stage(
        self, config_ids: List[ConfigId], losses: np.ndarray
    ) -> np.ndarray:
        k = self.num_configs[self.stage + 1]
        return sh_promotion_mask_np(losses, k)


class SuccessiveResampling(BaseIteration):
    """Promote fewer survivors and refill the gap with fresh samples.

    ``resampling_rate`` is the fraction of the next stage drawn fresh from the
    config generator instead of promoted.
    """

    promotion_rule = "successive_resampling"

    def __init__(self, *args, resampling_rate: float = 0.5, min_samples_advance: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        self.resampling_rate = float(resampling_rate)
        self.min_samples_advance = int(min_samples_advance)

    def _advance_to_next_stage(
        self, config_ids: List[ConfigId], losses: np.ndarray
    ) -> np.ndarray:
        k = self.num_configs[self.stage + 1]
        n_promote = max(
            int(np.ceil(k * (1.0 - self.resampling_rate))), self.min_samples_advance
        )
        # get_next_run() tops the unfilled remainder of the next stage up
        # with fresh samples (actual_num_configs < quota)
        return sh_promotion_mask_np(losses, min(n_promote, k))


class JaxSuccessiveHalving(SuccessiveHalving):
    """SuccessiveHalving whose promotion mask is decided on a torch device.

    ``device`` (``None`` means ``cuda``, which raises where there is no
    card) is where the ranking runs; an optimizer that has a device passes
    its own (``wants_device``). The rule equals the host rule bit for bit,
    so a fused bracket's cached survivors and the host bookkeeping agree.
    """

    promotion_rule = "successive_halving_jax"
    #: optimizers pass ``device=`` to iteration classes that set this
    wants_device = True

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)

    def _advance_to_next_stage(
        self, config_ids: List[ConfigId], losses: np.ndarray
    ) -> np.ndarray:
        k = self.num_configs[self.stage + 1]
        mask = sh_promotion_mask(
            torch.as_tensor(np.asarray(losses, np.float32), device=self.device), k
        )
        return mask.cpu().numpy()
