"""BatchedExecutor — the Master-facing adapter for on-device evaluation.

Ported from ``hpbandster_tpu/parallel/batched_executor.py``: jobs the Master
submits are buffered; when the Master runs out of ready work it calls
``flush()``, which evaluates the buffer on the device and fires the result
callback for every job synchronously. Non-finite losses become crashed
jobs (result ``None`` and an exception string).

Two evaluation modes:

* **stage batching** (always on): buffered jobs group by budget; each group
  is one backend call.
* **bracket fusion** (``fuse_brackets=True``, default): when the buffer
  holds a complete stage-0 wave of a bracket, the whole bracket (every
  stage and every promotion) runs on the device in one dispatch
  (``ops.fused.make_fused_bracket_fn``). Later stages are then served from
  a cache when the Master's own promotion rule re-queues the survivors. If
  the host promotes a different set (H2BO's learning-curve rule), the
  configs it promotes that the device did not fall back to stage batching:
  fusion never changes a result.

The reference's shape-bucketed brackets (``bucket_brackets``) are not
ported yet (ROADMAP A6), and XLA's persistent compile cache has no
counterpart here.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from hpbandster_tpu_torch.core.job import Job
from hpbandster_tpu_torch.ops.fused import make_fused_bracket_fn
from hpbandster_tpu_torch.space import ConfigurationSpace

__all__ = ["BatchedExecutor"]


class BatchedExecutor:
    #: tells the Master not to throttle submissions on a worker-sized queue
    unbounded_queue = True
    #: stage quotas are filled through get_config_batch (one scorer launch)
    #: instead of per-config get_config calls
    prefers_batched_sampling = True

    def __init__(
        self,
        backend,
        configspace: ConfigurationSpace,
        fuse_brackets: bool = True,
        parallel_brackets: int = 1,
        bucket_brackets: bool = False,
        logger: Optional[logging.Logger] = None,
    ):
        if bucket_brackets:
            raise NotImplementedError(
                "BatchedExecutor(bucket_brackets=True) is not ported yet "
                "(ROADMAP A6: bucketed programs)")
        self.backend = backend
        self.configspace = configspace
        self.fuse_brackets = bool(fuse_brackets) and hasattr(backend, "eval_fn")
        # >1 pipelines brackets: bracket k+1's stage-0 wave is sampled (from
        # a one-bracket-stale model) and dispatched before bracket k's
        # results are fetched
        self.preferred_parallel_brackets = max(int(parallel_brackets), 1)
        self.logger = logger or logging.getLogger("hpbandster_tpu_torch.batched_executor")
        self.buffer: List[Job] = []
        self._new_result_callback: Optional[Callable[..., None]] = None
        self.total_evaluated = 0
        #: (config_id, budget) -> loss a fused bracket computed ahead of time
        self._fused_cache: Dict[Tuple[Any, float], float] = {}
        self.fused_brackets_run = 0
        #: results served from the fused cache, and later-stage jobs that
        #: found none there (stage batched instead)
        self.fused_cache_hits = 0
        self.fused_cache_misses = 0

    # -------------------------------------------------------- executor seam
    def start(self, new_result_callback, new_worker_callback) -> None:
        self._new_result_callback = new_result_callback
        new_worker_callback(self.number_of_workers())

    def number_of_workers(self) -> int:
        return max(int(getattr(self.backend, "parallelism", 1)), 1)

    def submit_job(self, job: Job) -> None:
        self.buffer.append(job)

    def n_waiting(self) -> int:
        return len(self.buffer)

    # ------------------------------------------------------------- delivery
    def _crash_wave(self, jobs: List[Job], exc: Exception, where: str) -> None:
        """A bracket-level failure crashes only its own wave's jobs."""
        self.logger.exception("%s failed; wave of %d crashes", where, len(jobs))
        for j in jobs:
            j.exception = f"{where} failed: {exc!r}"
            self._finish(j, float("nan"))

    def _finish(self, job: Job, loss: float) -> None:
        job.time_it("finished")
        if np.isfinite(loss):
            job.result = {"loss": float(loss), "info": {}}
        else:
            job.result = None
            job.exception = job.exception or (
                f"non-finite loss {loss!r} at budget {job.kwargs['budget']}"
            )
        self.total_evaluated += 1
        # burst delivery: a flush's results all land before the Master can
        # propose again, so the model records each now and refits once, at
        # the next proposal
        self._new_result_callback(job, update_model=False)

    def _vectors(self, jobs: List[Job]) -> np.ndarray:
        return np.stack([
            np.nan_to_num(self.configspace.to_vector(j.kwargs["config"]), nan=0.0)
            for j in jobs
        ]).astype(np.float32)

    # ---------------------------------------------------------- fused path
    def _try_fuse(self, jobs: List[Job]) -> Optional[List[Job]]:
        """Fuse every complete stage-0 bracket wave found in ``jobs``, all
        of them dispatched before the first fetch. Returns the leftover
        (non-fused) jobs, or None if nothing was fused."""
        groups: Dict[int, List[Job]] = {}
        leftovers: List[Job] = []
        for j in jobs:
            info = getattr(j, "bracket_info", None)
            if info is None or info["stage"] != 0 or len(info["num_configs"]) < 2:
                leftovers.append(j)
            else:
                groups.setdefault(j.id[0], []).append(j)

        dispatched = []
        crashed = False
        for iteration, gjobs in sorted(groups.items()):
            info = gjobs[0].bracket_info
            complete = (
                all(getattr(j, "bracket_info", None) == info for j in gjobs)
                and len(gjobs) == info["num_configs"][0]
            )
            if not complete:
                leftovers.extend(gjobs)
                continue
            jobs_sorted = sorted(gjobs, key=lambda j: j.id)
            vectors = self._vectors(jobs_sorted)
            for j in jobs_sorted:
                j.time_it("started")
            runner = make_fused_bracket_fn(
                self.backend.eval_fn, info["num_configs"], info["budgets"],
                device=getattr(self.backend, "device", None),
            )
            try:
                packed = runner.dispatch(vectors)
            except Exception as e:  # contain: only this wave crashes
                self._crash_wave(jobs_sorted, e, "fused dispatch")
                crashed = True
                continue
            dispatched.append((iteration, info, jobs_sorted, runner, packed))

        if not dispatched and not crashed:
            return None  # nothing fused, nothing consumed: stage-batch

        for iteration, info, jobs_sorted, runner, packed in dispatched:
            try:
                stages = runner.fetch(packed)
            except Exception as e:
                self._crash_wave(jobs_sorted, e, "fused fetch")
                continue
            self.fused_brackets_run += 1
            # stage 0 feeds back now; stages >= 1 fill the cache
            for s, (idx, losses) in enumerate(stages[1:], start=1):
                budget = info["budgets"][s]
                for i, loss in zip(idx, losses):
                    cid = jobs_sorted[int(i)].id
                    self._fused_cache[(cid, float(budget))] = float(loss)
            self.logger.debug(
                "fused bracket %d: %s evals in one dispatch",
                iteration, sum(len(i) for i, _ in stages),
            )
            for j, loss in zip(jobs_sorted, stages[0][1]):
                self._finish(j, loss)
        return leftovers

    # -------------------------------------------------------------- flush
    def flush(self) -> bool:
        """Evaluate everything buffered; returns True if any job ran."""
        if not self.buffer:
            return False
        jobs, self.buffer = self.buffer, []

        # serve results a fused bracket already computed
        remaining: List[Job] = []
        for job in jobs:
            key = (job.id, float(job.kwargs["budget"]))
            if key in self._fused_cache:
                job.time_it("started")
                self.fused_cache_hits += 1
                self._finish(job, self._fused_cache.pop(key))
            else:
                info = getattr(job, "bracket_info", None)
                if self.fuse_brackets and info is not None and info["stage"] > 0:
                    self.fused_cache_misses += 1
                remaining.append(job)
        if not remaining:
            return True

        if self.fuse_brackets:
            fused_rest = self._try_fuse(remaining)
            if fused_rest is not None:
                remaining = fused_rest
                if not remaining:
                    return True

        by_budget: Dict[float, List[Job]] = {}
        for job in remaining:
            by_budget.setdefault(float(job.kwargs["budget"]), []).append(job)

        for budget, group in sorted(by_budget.items()):
            vectors = self._vectors(group)
            for j in group:
                j.time_it("started")
            try:
                losses = self.backend.evaluate(vectors, budget)
            except Exception as e:  # a backend failure crashes the wave
                self.logger.exception("batched evaluation failed at budget %g", budget)
                losses = np.full(len(group), np.nan)
                for j in group:
                    j.exception = f"batched evaluation failed: {e!r}"
            for j, loss in zip(group, losses):
                self._finish(j, loss)
        return True

    def shutdown(self, shutdown_workers: bool = False) -> None:
        if self.buffer:
            self.logger.warning(
                "shutdown with %d unevaluated buffered jobs", len(self.buffer)
            )
