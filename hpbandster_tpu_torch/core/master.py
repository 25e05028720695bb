"""Master — the optimizer main loop.

Ported from ``hpbandster_tpu/core/master.py``, the local loop: the Master
owns an executor, a config generator and the list of iteration objects;
``run()`` pulls ready runs from the active iterations, creates new
iterations up to ``n_iterations`` and submits jobs; ``job_callback``
registers results, updates the model and advances brackets. Batched
executors (``parallel.BatchedExecutor``) buffer submitted jobs and evaluate
them when the Master drains its ready queue and calls ``flush()``, which
fires ``job_callback`` synchronously, under the Master's re-entrant lock.
Before the first bracket ``run()`` announces the remaining schedule to an
executor that can build programs for it (``prepare_schedule``), and
``tenant_id=`` names the serving-tier tenant each submitted ``Job`` carries
(``serve/pool.py``).

The reference logs and ignores a failed schedule announcement; the port
does so on the CPU only: where the executor runs on a card the failure
raises, so a run never quietly loses the programs it was announced for.

Every job gets a trace identity at submission; its submission, its result
(``job_finished`` / ``job_failed``, under the job's own trace) and the
bracket bookkeeping it triggers go to the event bus
(``hpbandster_tpu_torch.obs``) under the master's tenant and run, and each
result's run time feeds the ``master.job_run_s`` histogram and its
budget-keyed twin ``master.job_run_s.b<budget>``, the cost feed of Pareto
promotion (``obs.budget_cost_from_obs``). With
``obs.use_profiler_annotations()`` the drive loop is the ``hpb.master_run``
profiler range, each new bracket (its stage-0 sampling included)
``hpb.master_new_bracket`` and each result's ingestion
``hpb.master_ingest`` (``obs.annotate``: no bus record).

With ``executor=None`` the Master builds the RPC ``Dispatcher``
(``parallel/dispatcher.py``) over the workers a ``NameServer`` lists, the
reference's architecture; ``wal_path=`` journals every terminal result
before bracket bookkeeping consumes it (``core/recovery.py``) and
``resume()`` replays it after a crash; ``collector=`` serves the master's
own health endpoint and polls the fleet (``obs/collector.py``). Each
submitted job carries its idempotency key.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.core.iteration import BaseIteration
from hpbandster_tpu_torch.core.job import ConfigId, Job
from hpbandster_tpu_torch.core.recovery import ResultWAL, idempotency_key, resume_master
from hpbandster_tpu_torch.core.result import Result
from hpbandster_tpu_torch.core.warmstart import WarmStartIteration

__all__ = ["Master"]


class Master:
    def __init__(
        self,
        run_id: str,
        config_generator,
        executor=None,
        working_directory: str = ".",
        # reference-compatible nameserver kwargs; used only when no executor
        # is passed and a Dispatcher must be constructed:
        nameserver: str = "127.0.0.1",
        nameserver_port: Optional[int] = None,
        host: Optional[str] = None,
        ping_interval: float = 60.0,
        shutdown_workers: bool = True,
        logger: Optional[logging.Logger] = None,
        result_logger=None,
        previous_result: Optional[Result] = None,
        job_queue_sizes: Tuple[int, int] = (-1, 0),
        dynamic_queue_size: bool = True,
        checkpoint_path: Optional[str] = None,
        checkpoint_interval: float = 30.0,
        wal_path: Optional[str] = None,
        collector: Any = None,
        tenant_id: Optional[str] = None,
    ):
        self.run_id = run_id
        self.config_generator = config_generator
        #: serving-tier identity: stamped on every submitted Job
        self.tenant_id = tenant_id
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

        # write-ahead result journal: every terminal result is journaled
        # before bracket bookkeeping consumes it, so a checkpoint and the
        # WAL's tail together lose no work across a crash (resume()). The
        # WAL truncates after each checkpoint, and is stamped with the
        # run id: a reused path's leftovers neither dedup nor replay.
        self.wal_path = wal_path
        self._wal = None
        if wal_path is not None:
            self._wal = ResultWAL(wal_path, run_id=run_id)

        # re-entrant: batched executors fire job_callback synchronously from
        # inside flush(), which runs under this same condition
        self.thread_cond = threading.Condition(threading.RLock())

        self.warmstart_iteration: List[Any] = []
        if previous_result is not None:
            self.warmstart_iteration = [
                WarmStartIteration(previous_result, self.config_generator)
            ]

        if executor is None:
            from hpbandster_tpu_torch.parallel.dispatcher import Dispatcher

            executor = Dispatcher(
                run_id=run_id,
                nameserver=nameserver,
                nameserver_port=nameserver_port,
                host=host,
                ping_interval=ping_interval,
            )
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

        # the fleet observatory: collector=True (defaults) or a dict of
        # FleetCollector kwargs serves this master's own health endpoint
        # and polls master, dispatcher and every discovered worker
        self.health_server = None
        self.fleet_collector = None
        if collector:
            self._start_collector(collector if isinstance(collector, dict) else {})

    # ------------------------------------------------------ fleet observatory
    def _start_collector(self, options: Dict[str, Any]) -> None:
        """Serve this master's ``obs_snapshot`` endpoint and start a
        :class:`~hpbandster_tpu_torch.obs.collector.FleetCollector` over
        the whole fleet (the endpoint listing is re-read every round, so
        an elastic pool is tracked as it churns)."""
        from hpbandster_tpu_torch.obs.collector import FleetCollector
        from hpbandster_tpu_torch.parallel.rpc import RPCServer

        server = RPCServer(getattr(self.executor, "host", None) or "127.0.0.1", 0)
        obs.HealthEndpoint(
            component="master",
            identity=obs.process_identity(run_id=self.run_id),
            in_flight=self._health_in_flight,
        ).register(server)
        server.start()
        self.health_server = server
        self.fleet_collector = FleetCollector(
            endpoints=self._fleet_endpoints, **options
        ).start()

    def _health_in_flight(self) -> Dict[str, Any]:
        with self.thread_cond:
            return {
                "running_jobs": self.num_running_jobs,
                "iterations": len(self.iterations),
                "active_iterations": len(self.active_iterations()),
            }

    def _fleet_endpoints(self) -> Dict[str, str]:
        """The collector's endpoint listing for one round: every fleet
        process that answers ``obs_snapshot`` now."""
        eps: Dict[str, str] = {}
        if self.health_server is not None:
            eps["master"] = self.health_server.uri
        uri = getattr(getattr(self.executor, "_server", None), "uri", None)
        if uri:
            eps["dispatcher"] = uri
        workers = getattr(self.executor, "workers", None)
        if isinstance(workers, dict):
            for name, w in list(workers.items()):
                w_uri = getattr(w, "uri", None)
                if w_uri:
                    eps[name] = w_uri
        return eps

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
        executors). The whole ingestion is the ``hpb.master_ingest``
        profiler range (``obs.annotate``)."""
        with obs.annotate("master_ingest"):
            # every tier funnels its results through here, so job_finished /
            # job_failed are emitted here, before the lock (sinks do I/O), and
            # under the job's own trace: a batched executor delivers many jobs
            # from one thread
            loss = job.loss
            run_s = job.mono_duration("started", "finished")
            with obs.use_tenant(self.tenant_id), obs.use_trace(job.trace):
                obs.emit(
                    obs.JOB_FAILED if job.exception is not None else obs.JOB_FINISHED,
                    config_id=list(job.id),
                    budget=job.kwargs.get("budget"),
                    worker=job.worker_name,
                    queue_s=job.mono_duration("submitted", "started"),
                    run_s=run_s,
                    # non-finite losses journal as null (strict JSON)
                    loss=loss if math.isfinite(loss) else None,
                )
            if isinstance(run_s, (int, float)):
                obs.get_metrics().histogram("master.job_run_s").observe(run_s)
                # the budget-keyed twin: the per-budget cost aggregate Pareto
                # promotion ranks by (obs.budget_cost_from_obs)
                budget = job.kwargs.get("budget")
                if isinstance(budget, (int, float)):
                    obs.get_metrics().histogram(
                        f"master.job_run_s.b{float(budget):g}"
                    ).observe(run_s)
            # the promotion records process_results() emits carry the tenant;
            # the run scopes the straggler-ledger drain to this sweep
            with obs.use_tenant(self.tenant_id), obs.use_run(self.run_id), self.thread_cond:
                self.num_running_jobs -= 1
                if self._wal is not None:
                    # write-ahead: on disk before any in-memory consumption, so
                    # a crash after this line re-joins the result from the WAL
                    # instead of re-running the evaluation
                    budget = job.kwargs.get("budget", 0.0)
                    self._wal.append(
                        job.idem_key or idempotency_key(job.id, budget),
                        job.id, budget, job.result, job.exception, job.timestamps,
                    )
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
        job.tenant_id = self.tenant_id
        # the job's trace identity: every event of its story carries it
        job.trace = obs.new_trace(self.run_id)
        # its exactly-once identity: requeues, late dead letters and
        # delivery retries all resolve to this one key
        job.idem_key = idempotency_key(config_id, budget)
        job.time_it("submitted")
        with obs.use_tenant(self.tenant_id), obs.use_trace(job.trace):
            obs.emit(obs.JOB_SUBMITTED, config_id=list(config_id), budget=budget)
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
        self._announce_schedule(n_remaining)
        # the drive loop runs under the tenant: config_sampled and
        # bracket_created records carry it
        with obs.use_tenant(self.tenant_id), obs.annotate("master_run"):
            return self._run_loop(n_remaining, iteration_kwargs)

    def _announce_schedule(self, n_remaining: int) -> None:
        """Hand the remaining brackets' shapes (``iteration_plan``) to an
        executor that builds programs for them (``prepare_schedule``), so
        the build overlaps the stage-0 sampling that follows."""
        plan_of = getattr(self, "iteration_plan", None)
        prepare = getattr(self.executor, "prepare_schedule", None)
        if not (callable(plan_of) and callable(prepare) and n_remaining > 0):
            return
        start = len(self.iterations)
        try:
            prepare([plan_of(i) for i in range(start, start + n_remaining)])
        except Exception:
            device = getattr(self.executor, "device", None)
            if device is not None and device.type == "cuda":
                raise
            self.logger.exception(
                "executor schedule preparation failed; continuing with "
                "per-shape programs")

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
                    self._new_bracket(iteration_kwargs)
                    n_remaining -= 1
                    continue

                # nothing ready: let a batched executor evaluate its buffer
                # (it fires job_callback under this RLock) before any new
                # bracket samples, so fresh proposals see the latest model
                if hasattr(self.executor, "flush") and self.executor.flush():
                    continue

                if n_remaining > 0:
                    self._new_bracket(iteration_kwargs)
                    n_remaining -= 1
                    continue

                if not self.active_iterations() and self.num_running_jobs == 0:
                    break

                self.thread_cond.wait(0.5)

        return Result(
            [i for i in self.iterations] + self.warmstart_iteration, self.config
        )

    def _new_bracket(self, iteration_kwargs: Dict[str, Any]) -> None:
        """Append the next bracket, its stage-0 sampling included, as the
        ``hpb.master_new_bracket`` profiler range."""
        with obs.annotate("master_new_bracket"):
            self.iterations.append(
                self.get_next_iteration(len(self.iterations), iteration_kwargs)
            )

    def shutdown(self, shutdown_workers: bool = False) -> None:
        if self.fleet_collector is not None:
            self.fleet_collector.stop()
            self.fleet_collector = None
        if self.health_server is not None:
            self.health_server.shutdown()
            self.health_server = None
        if self._wal is not None:
            self._wal.close()
        self.executor.shutdown(shutdown_workers)

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, path: str) -> None:
        """Snapshot the full optimizer state (brackets and model) to
        ``path``."""
        from hpbandster_tpu_torch.core.checkpoint import save_checkpoint

        t0 = time.monotonic()
        # the lock covers the snapshot and the WAL's truncation: a result
        # ingested between the two would be in neither
        with self.thread_cond:
            save_checkpoint(self, path)
            if self._wal is not None:
                self._wal.truncate()
        self._last_checkpoint_mono = time.monotonic()
        obs.emit(obs.CHECKPOINT_WRITTEN, path=path,
                 duration_s=round(time.monotonic() - t0, 6))

    def load_checkpoint(self, path: str) -> None:
        """Restore state saved by :meth:`save_checkpoint` into this (fresh)
        optimizer; a later ``run(n_iterations=<same total>)`` resumes
        mid-bracket."""
        from hpbandster_tpu_torch.core.checkpoint import load_checkpoint

        load_checkpoint(self, path)

    def resume(self, checkpoint_path: str, wal_path: Optional[str] = None) -> Dict[str, int]:
        """Crash-restart: restore ``checkpoint_path``, then replay the
        write-ahead journal's tail so results that arrived after the last
        checkpoint join back without re-running (core/recovery.py).
        Returns the replay stats; ``run(n_iterations=<same total>)`` then
        dispatches only unfinished configs."""
        return resume_master(self, checkpoint_path, wal_path)
