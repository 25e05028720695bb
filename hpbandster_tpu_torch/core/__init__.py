"""Host bookkeeping of the port: Job, Datum/BaseIteration, the iteration
types (SuccessiveHalving, SuccessiveResampling, JaxSuccessiveHalving),
Result, warm start (WarmStartIteration), the Master's run loop and the
Master and fused-tier checkpoints; and the host tier: NameServer, Worker
and crash recovery (``core/recovery.py``)."""

from hpbandster_tpu_torch.core.job import Job  # noqa: F401
from hpbandster_tpu_torch.core.iteration import BaseIteration, Datum, Status  # noqa: F401
from hpbandster_tpu_torch.core.successive_halving import (  # noqa: F401
    JaxSuccessiveHalving,
    SuccessiveHalving,
    SuccessiveResampling,
)
from hpbandster_tpu_torch.core.master import Master  # noqa: F401
from hpbandster_tpu_torch.core.nameserver import NameServer  # noqa: F401
from hpbandster_tpu_torch.core.result import (  # noqa: F401
    Result,
    Run,
    extract_HBS_learning_curves,
    json_result_logger,
    logged_results_to_HBS_result,
)
from hpbandster_tpu_torch.core.worker import Worker  # noqa: F401
