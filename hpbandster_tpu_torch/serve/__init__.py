"""``hpbandster_tpu_torch.serve``: the multi-tenant serving tier on one
device.

Ported from ``hpbandster_tpu/serve/``:

* :mod:`~hpbandster_tpu_torch.serve.scheduler`: admission control and
  weighted deficit-fair scheduling across tenants, over a configs x budget
  cost;
* :mod:`~hpbandster_tpu_torch.serve.megabatch`: brackets of one bucket from
  different tenants packed into one lane-packed dispatch
  (``ops/buckets.py``), demuxed back per tenant;
* :mod:`~hpbandster_tpu_torch.serve.continuous`: a resident lane program per
  bucket family with a device-resident per-lane incumbent carry, which
  tenants join and leave at chunk boundaries;
* :mod:`~hpbandster_tpu_torch.serve.pool`: :class:`ServePool`, per-tenant
  executor facades feeding fair-scheduled, megabatched (or continuous)
  rounds against one shared backend.

The reference's sweep specs, tenant sessions with warm models, the
per-sweep ``TenantMaster`` and the RPC ``ServeFrontend`` wait for the
port's host tier (ROADMAP A9).
"""

from hpbandster_tpu_torch.serve.continuous import (  # noqa: F401
    ContinuousRunner,
    LaneAllocator,
    make_lane_mesh,
)
from hpbandster_tpu_torch.serve.megabatch import (  # noqa: F401
    MegaRunner,
    PackEntry,
    demux,
    make_mega_runner,
    pack_members,
)
from hpbandster_tpu_torch.serve.pool import ServePool  # noqa: F401
from hpbandster_tpu_torch.serve.scheduler import (  # noqa: F401
    AdmissionController,
    AdmissionDecision,
    DeficitFairScheduler,
    TenantQuota,
    work_cost,
)

__all__ = [
    "ContinuousRunner",
    "LaneAllocator",
    "make_lane_mesh",
    "ServePool",
    "TenantQuota",
    "AdmissionController",
    "AdmissionDecision",
    "DeficitFairScheduler",
    "MegaRunner",
    "PackEntry",
    "demux",
    "make_mega_runner",
    "pack_members",
    "work_cost",
]
