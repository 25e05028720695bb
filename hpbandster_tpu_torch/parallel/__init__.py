"""Execution tiers behind the Master.

Batched: ``VmapBackend`` (a wave of configs on one device, or over a
mesh's config axis: ``parallel/mesh.py``) and ``BatchedExecutor`` (stage
batching and bracket fusion). Multi-process: ``parallel/multihost.py``
(``torch.distributed`` ranks, the SPMD driver, and the sharded 100k-1M
configuration tier). Host: the
asynchronous worker pool (``Dispatcher`` + ``NameServer`` + ``Worker``
over ``parallel/rpc.py``), the batched workers behind it
(``TPUBatchedWorker`` + ``RPCBatchBackend``) and seeded fault injection
(``parallel/chaos.py``).
"""

from hpbandster_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    config_mesh,
    config_model_mesh,
    is_multiprocess_mesh,
    pad_to_shards,
    shard_count,
)
from hpbandster_tpu_torch.parallel.backends import VmapBackend  # noqa: F401
from hpbandster_tpu_torch.parallel.batched_executor import BatchedExecutor  # noqa: F401
from hpbandster_tpu_torch.parallel.batched_worker import (  # noqa: F401
    RPCBatchBackend,
    TPUBatchedWorker,
)
from hpbandster_tpu_torch.parallel.chaos import (  # noqa: F401
    ChaosMonkey,
    ChaosProxy,
    ChaosSchedule,
)
from hpbandster_tpu_torch.parallel.dispatcher import Dispatcher  # noqa: F401
from hpbandster_tpu_torch.parallel.multihost import (  # noqa: F401
    MultiHostBatchedExecutor,
    initialize_multihost,
    is_primary_host,
    publish_device_balance,
    run_sharded_fused_sweep,
)
from hpbandster_tpu_torch.parallel.rpc import (  # noqa: F401
    CommunicationError,
    RPCError,
    RPCProxy,
    RPCServer,
)

__all__ = [
    "batch_sharding", "config_mesh", "config_model_mesh", "is_multiprocess_mesh",
    "pad_to_shards", "shard_count",
    "MultiHostBatchedExecutor", "initialize_multihost", "is_primary_host",
    "publish_device_balance", "run_sharded_fused_sweep",
    "VmapBackend", "BatchedExecutor", "RPCBatchBackend", "TPUBatchedWorker",
    "ChaosMonkey", "ChaosProxy", "ChaosSchedule", "Dispatcher",
    "CommunicationError", "RPCError", "RPCProxy", "RPCServer",
]
