"""base_config_generator — the config-proposal plugin seam.

Ported from ``hpbandster_tpu/models/base.py``: ``get_config(budget)``
proposes, ``new_result(job)`` feeds observations back, and
``get_config_batch`` lets batched executors request a whole stage at once.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

from hpbandster_tpu_torch.core.job import Job

__all__ = ["base_config_generator"]


class base_config_generator:
    def __init__(self, logger: Optional[logging.Logger] = None):
        self.logger = logger or logging.getLogger("hpbandster_tpu_torch.config_generator")

    def get_config(self, budget: float) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Propose one configuration for evaluation at ``budget``.

        Returns ``(config_dict, info_dict)``; the info records provenance
        (model-based vs random).
        """
        raise NotImplementedError

    def get_config_batch(
        self, budget: float, n: int
    ) -> List[Tuple[Dict[str, Any], Dict[str, Any]]]:
        """Propose ``n`` configurations at once (default: loop get_config)."""
        return [self.get_config(budget) for _ in range(n)]

    def new_result(self, job: Job, update_model: bool = True) -> None:
        """Register a finished job. Crashed runs (result None) are kept as
        information: they count as bad observations, not discarded."""
        if job.exception is not None:
            self.logger.warning(
                "job %s raised an exception: %s", job.id, job.exception
            )
