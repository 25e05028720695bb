"""Batched evaluation behind the Master: ``VmapBackend`` (a wave of configs
on one device) and ``BatchedExecutor`` (stage batching and bracket
fusion)."""

from hpbandster_tpu_torch.parallel.backends import VmapBackend  # noqa: F401
from hpbandster_tpu_torch.parallel.batched_executor import BatchedExecutor  # noqa: F401

__all__ = ["VmapBackend", "BatchedExecutor"]
