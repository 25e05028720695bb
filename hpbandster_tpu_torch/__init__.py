"""hpbandster_tpu_torch: the PyTorch/CUDA port of ``hpbandster_tpu``.

The port mirrors the JAX package's layout (``space/``, ``ops/``, ``core/``,
``models/``, ``parallel/``, ``optimizers/``, ``workloads/``, ``serve/``,
``obs/``, ``promote/``); each module names the file it was ported
from. It imports torch, numpy and the standard library, never jax and never
the JAX package. Its kernels are hand-written CUDA C++ under ``csrc/``,
built with ``nvcc`` at first launch.
"""

from hpbandster_tpu_torch.core.nameserver import NameServer  # noqa: F401
from hpbandster_tpu_torch.core.result import (  # noqa: F401
    Result,
    Run,
    json_result_logger,
    logged_results_to_HBS_result,
)
from hpbandster_tpu_torch.core.successive_halving import JaxSuccessiveHalving  # noqa: F401
from hpbandster_tpu_torch.core.worker import Worker  # noqa: F401
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
from hpbandster_tpu_torch.parallel import (  # noqa: F401
    BatchedExecutor,
    RPCBatchBackend,
    TPUBatchedWorker,
    VmapBackend,
)
from hpbandster_tpu_torch.serve import ServeFrontend, ServePool  # noqa: F401
from hpbandster_tpu_torch.space import ConfigurationSpace  # noqa: F401

__all__ = ["BOHB", "HyperBand", "RandomSearch", "H2BO", "BatchedExecutor",
           "VmapBackend", "FusedBOHB", "FusedHyperBand", "FusedH2BO",
           "FusedRandomSearch", "ConfigurationSpace", "ServePool", "NameServer",
           "Worker", "TPUBatchedWorker", "RPCBatchBackend", "ServeFrontend",
           "Result", "Run", "json_result_logger", "logged_results_to_HBS_result",
           "JaxSuccessiveHalving"]
