"""Config generators: the model seam (random sampling, BOHB KDE)."""

from hpbandster_tpu_torch.models.base import base_config_generator  # noqa: F401
from hpbandster_tpu_torch.models.random_sampling import RandomSampling  # noqa: F401
from hpbandster_tpu_torch.models.bohb_kde import BOHBKDE  # noqa: F401

__all__ = ["base_config_generator", "RandomSampling", "BOHBKDE"]
