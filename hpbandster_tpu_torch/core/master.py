"""Master — the optimizer main loop.

Ported from ``hpbandster_tpu/core/master.py``, the local loop: the Master
owns an executor, a config generator and the list of iteration objects;
``run()`` pulls ready runs from the active iterations, creates new
iterations up to ``n_iterations`` and submits jobs; ``job_callback``
registers results, updates the model and advances brackets. Batched
executors (``parallel.BatchedExecutor``) buffer submitted jobs and evaluate
them when the Master drains its ready queue and calls ``flush()``, which
fires ``job_callback`` synchronously, under the Master's re-entrant lock.

Not ported yet: the RPC ``Dispatcher`` that ``executor=None`` builds, the
fleet collector and the write-ahead result journal with ``resume()``
(ROADMAP A9), and the observability events (A8).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from hpbandster_tpu_torch.core.iteration import BaseIteration
from hpbandster_tpu_torch.core.job import ConfigId, Job
from hpbandster_tpu_torch.core.result import Result
from hpbandster_tpu_torch.core.warmstart import WarmStartIteration

__all__ = ["Master"]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP A9: host tier); pass "
        "executor=parallel.BatchedExecutor(...)")


class Master:
    def __init__(
        self,
        run_id: str,
        config_generator,
        executor=None,
        working_directory: str = ".",
        logger: Optional[logging.Logger] = None,
        result_logger=None,
        previous_result: Optional[Result] = None,
        job_queue_sizes: Tuple[int, int] = (-1, 0),
        dynamic_queue_size: bool = True,
        checkpoint_path: Optional[str] = None,
        checkpoint_interval: float = 30.0,
        wal_path: Optional[str] = None,
        collector: Any = None,
    ):
        if executor is None:
            raise _not_ported("executor=None (the RPC Dispatcher and its workers)")
        if wal_path is not None:
            raise _not_ported("wal_path= (the write-ahead result journal)")
        if collector:
            raise _not_ported("collector= (the fleet observatory)")
        self.run_id = run_id
        self.config_generator = config_generator
        self.working_directory = working_directory
        self.logger = logger or logging.getLogger("hpbandster_tpu_torch.master")
        self.result_logger = result_logger

        self.iterations: List[BaseIteration] = []
        self.jobs: List[Job] = []
        self.num_running_jobs = 0
        self.job_queue_sizes = job_queue_sizes
        self.dynamic_queue_size = dynamic_queue_size
        if job_queue_sizes[0] >= job_queue_sizes[1]:
            raise ValueError("job_queue_sizes: need lower < upper")

        self.time_ref: Optional[float] = None
        self.config: Dict[str, Any] = {"time_ref": None}

        # mid-run state checkpoints, saved from job_callback at most every
        # checkpoint_interval seconds (monotonic clock)
        self.checkpoint_path = checkpoint_path
        self.checkpoint_interval = float(checkpoint_interval)
        self._last_checkpoint_mono = 0.0

        # re-entrant: batched executors fire job_callback synchronously from
        # inside flush(), which runs under this same condition
        self.thread_cond = threading.Condition(threading.RLock())

        self.warmstart_iteration: List[Any] = []
        if previous_result is not None:
            self.warmstart_iteration = [
                WarmStartIteration(previous_result, self.config_generator)
            ]

        self.executor = executor
        self.executor.start(
            new_result_callback=self.job_callback,
            new_worker_callback=self.adjust_queue_size,
        )
        if getattr(self.executor, "unbounded_queue", False):
            self.dynamic_queue_size = False
            self.job_queue_sizes = (-1, float("inf"))
        # brackets that may run at once before buffered work is evaluated:
        # batched executors prefer 1 (each bracket's samples then see every
        # earlier result, and each stage is still one device batch)
        self.parallel_brackets: float = getattr(
            self.executor, "preferred_parallel_brackets", float("inf")
        )

    # ----------------------------------------------------------------- hooks
    def get_next_iteration(
        self, iteration: int, iteration_kwargs: Dict[str, Any]
    ) -> BaseIteration:
        """Instantiate the next bracket — implemented by optimizer subclasses."""
        raise NotImplementedError

    # -------------------------------------------------------------- plumbing
    def adjust_queue_size(self, number_of_workers: Optional[int] = None) -> None:
        """Retarget the in-flight window to the worker count
        (``dynamic_queue_size``: queue = (n_workers-1, n_workers))."""
        with self.thread_cond:
            n = (
                number_of_workers
                if number_of_workers is not None
                else self.executor.number_of_workers()
            )
            if self.dynamic_queue_size:
                self.job_queue_sizes = (max(n - 1, 0), max(n, 1))
            self.thread_cond.notify_all()

    def job_callback(self, job: Job, update_model: bool = True) -> None:
        """Result ingestion: log -> iteration bookkeeping -> model update ->
        stage advancement -> wake the run loop.

        ``update_model=False`` records the observation but defers the model
        refit to the next proposal (burst deliveries from batched
        executors)."""
        with self.thread_cond:
            self.num_running_jobs -= 1
            if self.result_logger is not None:
                self.result_logger(job)
            self.iterations[job.id[0]].register_result(job)
            self.config_generator.new_result(job, update_model=update_model)
            self.iterations[job.id[0]].process_results()
            if self.num_running_jobs <= self.job_queue_sizes[0]:
                self.thread_cond.notify_all()
            if (
                self.checkpoint_path is not None
                and time.monotonic() - self._last_checkpoint_mono
                > self.checkpoint_interval
            ):
                self.save_checkpoint(self.checkpoint_path)

    def _submit_job(self, config_id: ConfigId, config: Dict[str, Any], budget: float) -> None:
        job = Job(
            config_id,
            config=config,
            budget=budget,
            working_directory=self.working_directory,
        )
        # the bracket's shape rides on the job, so a batched executor can
        # fuse a whole bracket into one device dispatch (ops/fused.py)
        it = self.iterations[config_id[0]]
        job.bracket_info = {
            "num_configs": tuple(it.num_configs),
            "budgets": tuple(it.budgets),
            "stage": it.stage,
        }
        job.time_it("submitted")
        with self.thread_cond:
            self.num_running_jobs += 1
            self.jobs.append(job)
        self.executor.submit_job(job)

    def active_iterations(self) -> List[int]:
        return [i for i, it in enumerate(self.iterations) if not it.is_finished]

    def best_loss_at(self, budget: float) -> Optional[float]:
        """Best (lowest) recorded loss at ``budget`` across every bracket
        so far, or None."""
        best: Optional[float] = None
        for it in self.iterations:
            for d in it.data.values():
                v = d.results.get(budget)
                if v is not None and (best is None or v < best):
                    best = float(v)
        return best

    def wait_for_workers(self, min_n_workers: int) -> None:
        while self.executor.number_of_workers() < min_n_workers:
            time.sleep(0.05)

    # ------------------------------------------------------------------- run
    def run(
        self,
        n_iterations: int = 1,
        min_n_workers: int = 1,
        iteration_kwargs: Optional[Dict[str, Any]] = None,
    ) -> Result:
        """Drive ``n_iterations`` brackets to completion and return a Result.
        A resumed Master counts its restored iterations: ``n_iterations`` is
        the total."""
        iteration_kwargs = dict(iteration_kwargs or {})
        self.wait_for_workers(min_n_workers)
        self.adjust_queue_size()

        if self.time_ref is None:
            self.time_ref = time.time()
            self.config["time_ref"] = self.time_ref
        iteration_kwargs.setdefault("result_logger", self.result_logger)
        if getattr(self.executor, "prefers_batched_sampling", False) and hasattr(
            self.config_generator, "get_config_batch"
        ):
            iteration_kwargs.setdefault(
                "config_sampler_batch", self.config_generator.get_config_batch
            )
            # iterations restored from a checkpoint sample their remaining
            # stages as a new iteration would, so a resumed run draws what
            # the uninterrupted run drew
            for it in self.iterations:
                if it.config_sampler_batch is None:
                    it.config_sampler_batch = iteration_kwargs["config_sampler_batch"]
        n_remaining = max(n_iterations - len(self.iterations), 0)
        return self._run_loop(n_remaining, iteration_kwargs)

    def _run_loop(
        self, n_remaining: int, iteration_kwargs: Dict[str, Any]
    ) -> Result:
        while True:
            with self.thread_cond:
                # respect the in-flight window (async executors)
                while self.num_running_jobs > self.job_queue_sizes[1]:
                    self.thread_cond.wait(0.5)

                next_run = None
                for i in self.active_iterations():
                    next_run = self.iterations[i].get_next_run()
                    if next_run is not None:
                        break

                if next_run is not None:
                    self._submit_job(*next_run)
                    continue

                if (
                    n_remaining > 0
                    and len(self.active_iterations()) < self.parallel_brackets
                ):
                    self.iterations.append(
                        self.get_next_iteration(len(self.iterations), iteration_kwargs)
                    )
                    n_remaining -= 1
                    continue

                # nothing ready: let a batched executor evaluate its buffer
                # (it fires job_callback under this RLock) before any new
                # bracket samples, so fresh proposals see the latest model
                if hasattr(self.executor, "flush") and self.executor.flush():
                    continue

                if n_remaining > 0:
                    self.iterations.append(
                        self.get_next_iteration(len(self.iterations), iteration_kwargs)
                    )
                    n_remaining -= 1
                    continue

                if not self.active_iterations() and self.num_running_jobs == 0:
                    break

                self.thread_cond.wait(0.5)

        return Result(
            [i for i in self.iterations] + self.warmstart_iteration, self.config
        )

    def shutdown(self, shutdown_workers: bool = False) -> None:
        self.executor.shutdown(shutdown_workers)

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, path: str) -> None:
        """Snapshot the full optimizer state (brackets and model) to
        ``path``."""
        from hpbandster_tpu_torch.core.checkpoint import save_checkpoint

        with self.thread_cond:
            save_checkpoint(self, path)
        self._last_checkpoint_mono = time.monotonic()

    def load_checkpoint(self, path: str) -> None:
        """Restore state saved by :meth:`save_checkpoint` into this (fresh)
        optimizer; a later ``run(n_iterations=<same total>)`` resumes
        mid-bracket."""
        from hpbandster_tpu_torch.core.checkpoint import load_checkpoint

        load_checkpoint(self, path)

    def resume(self, checkpoint_path: str, wal_path: Optional[str] = None):
        """Crash-restart from a checkpoint and the write-ahead journal: not
        ported yet; :meth:`load_checkpoint` restores a checkpoint."""
        raise _not_ported("Master.resume (the write-ahead result journal)")
