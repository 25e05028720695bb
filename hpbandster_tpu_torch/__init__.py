"""hpbandster_tpu_torch: the PyTorch/CUDA port of ``hpbandster_tpu``.

The port mirrors the JAX package's layout (``space/``, ``ops/``, ``core/``,
``optimizers/``, ``workloads/``); each module names the file it was ported
from. It imports torch, numpy and the standard library, never jax and never
the JAX package. Its kernels are hand-written CUDA C++ under ``csrc/``,
built with ``nvcc`` at first launch.
"""

from hpbandster_tpu_torch.optimizers import (  # noqa: F401
    FusedBOHB,
    FusedH2BO,
    FusedHyperBand,
    FusedRandomSearch,
)
from hpbandster_tpu_torch.space import ConfigurationSpace  # noqa: F401

__all__ = ["FusedBOHB", "FusedHyperBand", "FusedH2BO", "FusedRandomSearch",
           "ConfigurationSpace"]
