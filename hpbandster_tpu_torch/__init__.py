"""hpbandster_tpu_torch: the PyTorch/CUDA port of ``hpbandster_tpu``.

The port mirrors the JAX package's layout (``space/``, ``ops/``, ``core/``,
``models/``, ``parallel/``, ``optimizers/``, ``workloads/``, ``serve/``); each module names the file it was ported
from. It imports torch, numpy and the standard library, never jax and never
the JAX package. Its kernels are hand-written CUDA C++ under ``csrc/``,
built with ``nvcc`` at first launch.
"""

from hpbandster_tpu_torch.optimizers import (  # noqa: F401
    BOHB,
    H2BO,
    FusedBOHB,
    FusedH2BO,
    FusedHyperBand,
    FusedRandomSearch,
    HyperBand,
    RandomSearch,
)
from hpbandster_tpu_torch.parallel import BatchedExecutor, VmapBackend  # noqa: F401
from hpbandster_tpu_torch.serve import ServePool  # noqa: F401
from hpbandster_tpu_torch.space import ConfigurationSpace  # noqa: F401

__all__ = ["BOHB", "HyperBand", "RandomSearch", "H2BO", "BatchedExecutor",
           "VmapBackend", "FusedBOHB", "FusedHyperBand", "FusedH2BO",
           "FusedRandomSearch", "ConfigurationSpace", "ServePool"]
