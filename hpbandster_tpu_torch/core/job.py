"""Job — one (config, budget) evaluation travelling through the system.

Mirrors the reference's ``Job`` record (SURVEY.md §2 "Dispatcher" row):
config id + kwargs, submitted/started/finished wall-clock timestamps, and a
result-or-exception outcome. The timestamp schema is preserved verbatim so
``Result`` analysis and the JSONL log format stay compatible.

Beside the verbatim wall-clock schema, ``time_it`` also records a
monotonic-clock twin (``Job.mono``) for the obs layer: durations derived
via :meth:`mono_duration` are immune to wall-clock jumps, while
``Job.timestamps`` stays byte-identical to what the reference logs.

Ported from ``hpbandster_tpu/core/job.py``: host bookkeeping, no jax.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

__all__ = ["Job"]

ConfigId = Tuple[int, int, int]


class Job:
    def __init__(self, id: ConfigId, **kwargs: Any):
        self.id: ConfigId = tuple(id)  # type: ignore[assignment]
        self.kwargs: Dict[str, Any] = kwargs
        self.timestamps: Dict[str, float] = {}
        #: monotonic twins of ``timestamps`` (obs spans; never serialized)
        self.mono: Dict[str, float] = {}
        self.result: Optional[Dict[str, Any]] = None
        self.exception: Optional[str] = None
        self.worker_name: Optional[str] = None
        #: obs trace identity (a TraceContext in the reference's obs layer) minted
        #: by the master at submit time; survives requeues, so one trace_id
        #: tells a job's whole story including redispatch. Never serialized
        #: into ``timestamps``/result schema.
        self.trace: Optional[Any] = None
        #: exactly-once identity (core/recovery.py idempotency_key) minted
        #: beside the trace: stable across requeues and redispatches, so
        #: every copy of this job's result resolves to one key
        self.idem_key: Optional[str] = None
        #: elastic-recovery bookkeeping (parallel/dispatcher.py): how many
        #: times this job was orphaned by a dying worker and requeued, and
        #: the earliest monotonic instant it may redispatch (capped
        #: exponential backoff — a crashing config must not hot-loop
        #: through the surviving pool)
        self.requeue_count: int = 0
        self.not_before_mono: float = 0.0
        #: the serving-tier tenant whose master submitted this job (None
        #: outside a ServePool)
        self.tenant_id: Optional[str] = None

    def time_it(self, which_time: str) -> "Job":
        """Record a wall-clock timestamp ('submitted' | 'started' | 'finished')."""
        self.timestamps[which_time] = time.time()
        self.mono[which_time] = time.monotonic()
        return self

    def mono_duration(self, start: str, end: str) -> Optional[float]:
        """Monotonic seconds between two recorded stamps, or None if either
        is missing (e.g. a requeued job re-records 'started')."""
        try:
            return self.mono[end] - self.mono[start]
        except KeyError:
            return None

    @property
    def loss(self) -> float:
        """The scalar loss, or NaN for crashed/invalid results."""
        if self.result is None:
            return float("nan")
        try:
            return float(self.result["loss"])
        except (KeyError, TypeError, ValueError):
            return float("nan")

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"Job(id={self.id}, budget={self.kwargs.get('budget')}, "
            f"result={self.result!r}, exception={self.exception!r})"
        )
