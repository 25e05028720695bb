"""Random config generator (HyperBand's and RandomSearch's sampler).

Ported from ``hpbandster_tpu/models/random_sampling.py``: host numpy on the
port's own ``space``, whose ``sample_configuration(rng=)`` draws what the
reference's draws, draw for draw.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from hpbandster_tpu_torch.models.base import base_config_generator
from hpbandster_tpu_torch.space import ConfigurationSpace

__all__ = ["RandomSampling"]


class RandomSampling(base_config_generator):
    def __init__(
        self,
        configspace: ConfigurationSpace,
        seed: Optional[int] = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.configspace = configspace
        self.rng = np.random.default_rng(seed)

    #: every pick is a deliberate random draw: this generator has no model
    _INFO = {"model_based_pick": False, "sample_reason": "random_search"}

    def get_config(self, budget: float) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        cfg = self.configspace.sample_configuration(rng=self.rng)
        return dict(cfg), dict(self._INFO)

    def get_config_batch(
        self, budget: float, n: int
    ) -> List[Tuple[Dict[str, Any], Dict[str, Any]]]:
        return [
            (dict(c), dict(self._INFO))
            for c in self.configspace.sample_configuration(n, rng=self.rng)
        ]

    # ----------------------------------------------------------- checkpoint
    def get_state(self):
        return {"np_rng": self.rng.bit_generator.state}

    def set_state(self, state):
        self.rng = np.random.default_rng()
        self.rng.bit_generator.state = state["np_rng"]
