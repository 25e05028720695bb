"""Execution tiers behind the Master.

Batched: ``VmapBackend`` (a wave of configs on one device) and
``BatchedExecutor`` (stage batching and bracket fusion). Host: the
asynchronous worker pool (``Dispatcher`` + ``NameServer`` + ``Worker``
over ``parallel/rpc.py``), the batched workers behind it
(``TPUBatchedWorker`` + ``RPCBatchBackend``) and seeded fault injection
(``parallel/chaos.py``).
"""

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
from hpbandster_tpu_torch.parallel.rpc import (  # noqa: F401
    CommunicationError,
    RPCError,
    RPCProxy,
    RPCServer,
)

__all__ = [
    "VmapBackend", "BatchedExecutor", "RPCBatchBackend", "TPUBatchedWorker",
    "ChaosMonkey", "ChaosProxy", "ChaosSchedule", "Dispatcher",
    "CommunicationError", "RPCError", "RPCProxy", "RPCServer",
]
