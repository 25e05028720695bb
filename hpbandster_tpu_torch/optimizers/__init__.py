"""Optimizers of the port."""

from hpbandster_tpu_torch.optimizers.fused_bohb import FusedBOHB  # noqa: F401

__all__ = ["FusedBOHB"]
