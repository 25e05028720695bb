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
  stage and every promotion) runs on the device in one dispatch. Later
  stages are then served from a cache when the Master's own promotion rule
  re-queues the survivors. If the host promotes a different set (H2BO's
  learning-curve rule), the configs it promotes that the device did not
  fall back to stage batching: fusion never changes a result.

With ``bucket_brackets=True`` (the default, as in the reference) a fused
bracket runs on its shape's bucket program (``ops/buckets.py``): when the
Master announces the remaining schedule (``prepare_schedule``), the
schedule's shapes pad up to a small bucket set whose programs build in the
background (on a card, one CUDA graph per bucket), overlapped with stage-0
sampling. A shape the set does not cover runs on its own per-shape program
(``ops.fused.make_fused_bracket_fn``). Bucketing never changes a result.
With a mesh on the backend (``VmapBackend(mesh=)``) both programs split
their stages over its config axis, and the bucket widths pad to the
axis's shard count only: on a ``("config", "model")`` mesh the model axis
replicates the batch.

Where the reference falls back to the per-shape program on any bucketed
failure, the port does so on the CPU only: on a card a failed bucketed
dispatch, or a failed schedule preparation, raises, so a run meant for the
graphs never quietly runs without them. The reference's persistent compile
cache is the port's kernel cache (``utils/compile_cache.py``): the nvcc
libraries persist across processes, the CUDA graphs stay per process.

Each fused dispatch, fused fetch and stage batch is a span on the event bus
(``fused_dispatch``, ``fused_fetch``, ``stage_batch``): host regions around
the device calls, never inside a captured graph.

The half of the executor seam that the serving pool's tenant facade
(``serve/pool.py``) shares lives here as well: :class:`ExecutorSeam` holds
the buffer, the fused cache and the result delivery (the seam methods,
``_finish``, ``_crash_wave``, serving the cache at a flush and filling it
from a fused bracket), :class:`OnBackend` the two reads of the backend
(whether it runs on a card, its mesh), and :func:`stage0_waves` and
:func:`job_vectors` the split of a flush into complete stage-0 waves and
the vector encode. ``BatchedExecutor`` adds the per-shape fallback, the
bracket pipelining and the cache hit and miss counts; the facade adds the
pool's queueing and a per-tenant finished-configs counter.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.core.job import Job
from hpbandster_tpu_torch.ops.bracket import BracketPlan
from hpbandster_tpu_torch.ops.buckets import (
    build_bucket_set,
    make_bucketed_bracket_fn,
    member_counts_for,
    precompile_buckets,
    slice_member_stages,
)
from hpbandster_tpu_torch.ops.fused import make_fused_bracket_fn
from hpbandster_tpu_torch.parallel.mesh import shard_count
from hpbandster_tpu_torch.space import ConfigurationSpace

__all__ = ["BatchedExecutor"]


def stage0_waves(jobs: List[Job]) -> Tuple[List[Tuple[int, Dict[str, Any], List[Job]]], List[Job]]:
    """Split a flush's jobs into complete stage-0 bracket waves and the rest.

    A wave is complete when all of one iteration's stage-0 jobs of a
    bracket of two or more stages carry one ``bracket_info`` and number
    ``num_configs[0]``. Returns ``[(iteration, bracket_info, jobs sorted by
    id)]`` in iteration order, and the leftovers: the other jobs in their
    order, then the incomplete waves' jobs."""
    groups: Dict[int, List[Job]] = {}
    leftovers: List[Job] = []
    for j in jobs:
        info = getattr(j, "bracket_info", None)
        if info is None or info["stage"] != 0 or len(info["num_configs"]) < 2:
            leftovers.append(j)
        else:
            groups.setdefault(j.id[0], []).append(j)
    waves = []
    for iteration, group in sorted(groups.items()):
        info = group[0].bracket_info
        if len(group) == info["num_configs"][0] and all(j.bracket_info == info for j in group):
            waves.append((iteration, info, sorted(group, key=lambda j: j.id)))
        else:
            leftovers.extend(group)
    return waves, leftovers


def job_vectors(configspace: ConfigurationSpace, jobs: Sequence[Job]) -> np.ndarray:
    """The jobs' configurations as one f32 matrix (inactive dimensions 0)."""
    return np.stack([
        np.nan_to_num(configspace.to_vector(j.kwargs["config"]), nan=0.0) for j in jobs
    ]).astype(np.float32)


class OnBackend:
    """The reads an executor makes of its batched backend (``backend`` and
    ``device`` are set by the subclass)."""

    def _strict(self) -> bool:
        """On a card a device-program failure raises instead of falling back."""
        return self.device is not None and self.device.type == "cuda"

    def _mesh(self):
        """The backend's mesh and axis (``(None, "config")`` unmeshed)."""
        return getattr(self.backend, "mesh", None), getattr(self.backend, "axis", "config")


class ExecutorSeam(OnBackend):
    """The executor seam a Master drives: buffer its jobs, hand them to the
    device at ``flush()`` (the subclass's), deliver each result."""

    #: tells the Master not to throttle submissions on a worker-sized queue
    unbounded_queue = True
    #: stage quotas are filled through get_config_batch (one scorer launch)
    #: instead of per-config get_config calls
    prefers_batched_sampling = True

    def __init__(self, backend, configspace: ConfigurationSpace):
        self.backend = backend
        self.configspace = configspace
        #: the backend's device; on a card device-program failures raise
        self.device = getattr(backend, "device", None)
        self.buffer: List[Job] = []
        self._new_result_callback: Optional[Callable[..., None]] = None
        self.total_evaluated = 0
        #: (config_id, budget) -> loss a fused bracket computed ahead of time
        self._fused_cache: Dict[Tuple[Any, float], float] = {}

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

    def _crash_wave(self, jobs: List[Job], why: str) -> None:
        """A bracket- or batch-level failure crashes only its own wave."""
        for j in jobs:
            j.exception = why
            self._finish(j, float("nan"))

    def _serve_cached(self, jobs: List[Job]) -> List[Job]:
        """Finish the jobs whose ``(id, budget)`` a fused bracket already
        computed; returns the others."""
        rest: List[Job] = []
        for job in jobs:
            key = (job.id, float(job.kwargs["budget"]))
            if key in self._fused_cache:
                job.time_it("started")
                self._finish(job, self._fused_cache.pop(key))
            else:
                rest.append(job)
        return rest

    def _fill_cache(self, jobs: List[Job], budgets, stages) -> None:
        """A fused bracket's true-shape stages ``[(idx, losses), ...]`` over
        its stage-0 ``jobs``: stages 1.. wait in the cache for the Master's
        own promotions, stage 0 finishes now."""
        for budget, (idx, losses) in zip(budgets[1:], stages[1:]):
            for i, loss in zip(np.asarray(idx), np.asarray(losses)):
                self._fused_cache[(jobs[int(i)].id, float(budget))] = float(loss)
        for j, loss in zip(jobs, np.asarray(stages[0][1])):
            self._finish(j, float(loss))


class BatchedExecutor(ExecutorSeam):
    def __init__(
        self,
        backend,
        configspace: ConfigurationSpace,
        fuse_brackets: bool = True,
        parallel_brackets: int = 1,
        bucket_brackets: bool = True,
        logger: Optional[logging.Logger] = None,
    ):
        from hpbandster_tpu_torch.utils.compile_cache import (
            enable_persistent_compile_cache,
        )

        # the executor launches the kernels: point their builds at the
        # shared kernel cache first (idempotent; HPB_XLA_CACHE=0 opts out)
        enable_persistent_compile_cache()
        super().__init__(backend, configspace)
        self.fuse_brackets = bool(fuse_brackets) and hasattr(backend, "eval_fn")
        #: shape-bucketed fused brackets (ops/buckets.py), built when the
        #: Master announces the schedule (prepare_schedule)
        self.bucket_brackets = bool(bucket_brackets) and self.fuse_brackets
        # >1 pipelines brackets: bracket k+1's stage-0 wave is sampled (from
        # a one-bracket-stale model) and dispatched before bracket k's
        # results are fetched
        self.preferred_parallel_brackets = max(int(parallel_brackets), 1)
        self.logger = logger or logging.getLogger("hpbandster_tpu_torch.batched_executor")
        self.fused_brackets_run = 0
        #: results served from the fused cache, and later-stage jobs that
        #: found none there (stage batched instead)
        self.fused_cache_hits = 0
        self.fused_cache_misses = 0
        #: of the fused brackets, those served by a shared bucket program
        self.bucketed_brackets_run = 0
        #: every plan prepare_schedule has seen (the bucket set rebuilds over
        #: the union, so a second run() widens it rather than resetting it)
        self._bucket_plans: List[BracketPlan] = []
        self._bucket_set = None
        self._bucket_precompile = None

    # -------------------------------------------------------- bucketed path
    def prepare_schedule(self, plans) -> None:
        """The Master's schedule announcement: the remaining brackets'
        shapes, known before any sampling. Builds the bucket set over every
        plan seen so far and starts the background build of its programs,
        so the build overlaps the optimizer's stage-0 sampling."""
        if not self.bucket_brackets:
            return
        fusable = [p for p in plans if len(p.num_configs) >= 2]
        if not fusable:
            return
        self._bucket_plans.extend(fusable)
        mesh, axis = self._mesh()
        self._bucket_set = build_bucket_set(self._bucket_plans,
                                            mesh_size=shard_count(mesh, axis))
        self._bucket_precompile = precompile_buckets(
            self.backend.eval_fn, self._bucket_set, d=self.configspace.dim,
            mesh=mesh, axis=axis, device=self.device, background=True,
        )
        self.logger.debug(
            "bucket set prepared: %d shapes -> %d programs",
            len(self._bucket_set.assignment), len(self._bucket_set.buckets),
        )

    def _bucket_runner_for(self, info):
        """The ``(runner, plan, entry)`` serving this bracket shape, or None
        when bucketing is off or unprepared, or does not cover the shape."""
        if self._bucket_set is None:
            return None
        placed = self._bucket_set.place(info["num_configs"], info["budgets"])
        if placed is None:
            return None
        bucket, plan, entry = placed
        mesh, axis = self._mesh()
        runner = make_bucketed_bracket_fn(self.backend.eval_fn, bucket, mesh=mesh,
                                          axis=axis, device=self.device)
        return runner, plan, entry

    def _dispatch_bucketed(self, iteration, info, vectors):
        """Launch a bracket on its bucket program; returns its fetch, or
        None where no bucket covers it or (on the CPU only) the bucketed
        dispatch failed and the per-shape program takes over."""
        bucketed = self._bucket_runner_for(info)
        if bucketed is None:
            return None
        runner, plan, entry = bucketed
        try:
            with obs.span("fused_dispatch", iteration=iteration, n=len(vectors),
                          bucketed=True):
                packed = runner.dispatch(vectors, member_counts_for(runner.bucket, plan, entry))
        except Exception:
            if self._strict():
                raise
            self.logger.exception(
                "bucketed dispatch failed; falling back to the per-shape fused program")
            return None
        self.bucketed_brackets_run += 1
        return lambda: slice_member_stages(runner.unpack(packed), plan, entry)

    # ---------------------------------------------------------- fused path
    def _try_fuse(self, jobs: List[Job]) -> Optional[List[Job]]:
        """Fuse every complete stage-0 bracket wave found in ``jobs``, all
        of them dispatched before the first fetch. Returns the leftover
        (non-fused) jobs, or None if nothing was fused."""
        waves, leftovers = stage0_waves(jobs)
        if not waves:
            return None  # nothing fused, nothing consumed: stage-batch
        dispatched = []
        for iteration, info, wave in waves:
            vectors = job_vectors(self.configspace, wave)
            for j in wave:
                j.time_it("started")
            fetch = self._dispatch_bucketed(iteration, info, vectors)
            if fetch is None:
                mesh, axis = self._mesh()
                runner = make_fused_bracket_fn(
                    self.backend.eval_fn, info["num_configs"], info["budgets"],
                    mesh=mesh, axis=axis, device=self.device,
                )
                try:
                    with obs.span("fused_dispatch", iteration=iteration, n=len(wave)):
                        packed = runner.dispatch(vectors)
                except Exception as e:  # contain: only this wave crashes
                    self.logger.exception("fused dispatch failed; wave of %d crashes", len(wave))
                    self._crash_wave(wave, f"fused dispatch failed: {e!r}")
                    continue
                fetch = lambda runner=runner, packed=packed: runner.fetch(packed)  # noqa: E731
            dispatched.append((iteration, info, wave, fetch))

        for iteration, info, wave, fetch in dispatched:
            try:
                with obs.span("fused_fetch", iteration=iteration):
                    stages = fetch()
            except Exception as e:
                self.logger.exception("fused fetch failed; wave of %d crashes", len(wave))
                self._crash_wave(wave, f"fused fetch failed: {e!r}")
                continue
            self.fused_brackets_run += 1
            self.logger.debug(
                "fused bracket %d: %s evals in one dispatch",
                iteration, sum(len(i) for i, _ in stages),
            )
            self._fill_cache(wave, info["budgets"], stages)
        return leftovers

    # -------------------------------------------------------------- flush
    def flush(self) -> bool:
        """Evaluate everything buffered; returns True if any job ran."""
        if not self.buffer:
            return False
        jobs, self.buffer = self.buffer, []

        # serve results a fused bracket already computed
        remaining = self._serve_cached(jobs)
        self.fused_cache_hits += len(jobs) - len(remaining)
        if self.fuse_brackets:
            self.fused_cache_misses += sum(
                1 for j in remaining
                if getattr(j, "bracket_info", None) is not None and j.bracket_info["stage"] > 0)
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
            vectors = job_vectors(self.configspace, group)
            for j in group:
                j.time_it("started")
            try:
                with obs.span("stage_batch", n=len(group), budget=budget):
                    losses = self.backend.evaluate(vectors, budget)
            except Exception as e:  # a backend failure crashes the wave
                self.logger.exception("batched evaluation failed at budget %g", budget)
                self._crash_wave(group, f"batched evaluation failed: {e!r}")
                continue
            for j, loss in zip(group, losses):
                self._finish(j, loss)
        return True

    def shutdown(self, shutdown_workers: bool = False) -> None:
        if self.buffer:
            self.logger.warning(
                "shutdown with %d unevaluated buffered jobs", len(self.buffer)
            )
