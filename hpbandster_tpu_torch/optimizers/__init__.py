"""Optimizers of the port: the Master-driven ones (BOHB, HyperBand,
RandomSearch, H2BO) and the fused whole-sweep ones."""

from hpbandster_tpu_torch.optimizers.hyperband import HyperBand  # noqa: F401
from hpbandster_tpu_torch.optimizers.bohb import BOHB  # noqa: F401
from hpbandster_tpu_torch.optimizers.randomsearch import RandomSearch  # noqa: F401
from hpbandster_tpu_torch.optimizers.h2bo import H2BO  # noqa: F401
from hpbandster_tpu_torch.optimizers.fused_bohb import (  # noqa: F401
    FusedBOHB,
    FusedH2BO,
    FusedHyperBand,
    FusedRandomSearch,
)

__all__ = ["BOHB", "HyperBand", "RandomSearch", "H2BO", "FusedBOHB",
           "FusedHyperBand", "FusedH2BO", "FusedRandomSearch"]
