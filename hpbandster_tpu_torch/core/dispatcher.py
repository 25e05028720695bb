"""Alias module: the reference's dispatcher lives at ``core/dispatcher.py``
(SURVEY.md §1 layer map); the implementation here sits in the parallel tier
next to its sibling executors."""

from hpbandster_tpu_torch.parallel.dispatcher import Dispatcher, WorkerProxy  # noqa: F401
from hpbandster_tpu_torch.core.job import Job  # noqa: F401
