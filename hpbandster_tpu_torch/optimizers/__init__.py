"""Optimizers of the port."""

from hpbandster_tpu_torch.optimizers.fused_bohb import (  # noqa: F401
    FusedBOHB,
    FusedH2BO,
    FusedHyperBand,
    FusedRandomSearch,
)

__all__ = ["FusedBOHB", "FusedHyperBand", "FusedH2BO", "FusedRandomSearch"]
