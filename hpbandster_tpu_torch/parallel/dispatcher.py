"""Dispatcher — master-side job broker for the elastic host worker pool.

Ported from ``hpbandster_tpu/parallel/dispatcher.py``, a copy; it dispatches
to port and reference workers alike.

Reference: ``core/dispatcher.py`` (SURVEY.md §2/§3): a discovery loop polls
the nameserver ~1/s for worker registrations (elastic join/leave), a job
runner matches queued jobs to idle workers, results arrive via RPC from
workers and are forwarded to the Master's callback. Vanished workers are
dropped and their in-flight jobs requeued — the reference's failure
semantics (SURVEY.md §5 "Failure detection" row).

Implements the same executor seam as ``parallel.BatchedExecutor``, so the
identical Master drives either tier.

Observability (docs/observability.md): jobs are dispatched under their
:class:`~hpbandster_tpu_torch.obs.trace.TraceContext` (the ``_obs`` RPC envelope
carries it to the worker), ``job_started`` reports ``queue_wait_s`` /
``dispatch_s``, queue-depth and in-flight gauges track scheduling
pressure, the ping loop doubles as the fleet heartbeat collector
(``obs_snapshot`` per worker, ``dispatcher.workers_alive`` / last-seen-age
gauges), and the dispatcher's own RPC server answers ``obs_snapshot``.

Elastic recovery (docs/fault_tolerance.md): result ingestion is
exactly-once — every copy of a result (late arrivals from presumed-dead
workers, worker delivery retries racing a slow ack, chaos-duplicated
frames) resolves through the job's idempotency key, the first copy joins
the run, later copies are counted and acked. A late result for a
requeued-but-not-yet-redispatched job claims it straight from the
waiting queue (work is never redone just because the ack was lost), and
dead letters are keyed so a resubmitted job joins its stranded payload
back on submit. Requeues carry a capped-backoff retry budget; exhausting
it fails the job instead of hot-looping it through the pool. When an
attached anomaly detector fires ``worker_flapping``, the named worker is
quarantined — dropped AND banned from rediscovery until the quarantine
expires — instead of being rediscovered into the same crash loop.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.core.job import Job
from hpbandster_tpu_torch.core.recovery import (
    DeadLetterBox,
    ExactlyOnceGate,
    idempotency_key,
)
from hpbandster_tpu_torch.obs.health import HealthEndpoint
from hpbandster_tpu_torch.parallel.rpc import (
    CommunicationError,
    RPCError,
    RPCProxy,
    RPCServer,
    format_uri,
)

__all__ = ["Dispatcher", "WorkerProxy"]


class WorkerProxy:
    """Master-side record of one discovered worker."""

    def __init__(self, name: str, uri: str):
        self.name = name
        self.uri = uri
        self.proxy = RPCProxy(uri, timeout=30)
        self.runs_job: Optional[Any] = None  # config_id or None
        #: heartbeat state (written only by the ping loop / discovery)
        self.last_seen_mono: float = time.monotonic()
        self.last_snapshot: Optional[Dict[str, Any]] = None
        self._supports_obs_snapshot = True  # optimistic until an RPCError

    def is_alive(self) -> bool:
        try:
            self.proxy.call("ping")
        except (CommunicationError, RPCError):
            return False
        self.last_seen_mono = time.monotonic()
        return True

    def heartbeat(self) -> bool:
        """One liveness probe, preferring the ``obs_snapshot`` fleet-health
        endpoint (worker metrics + ring tail + in-flight job retained on
        :attr:`last_snapshot`); falls back to plain ``ping`` for older
        peers that predate the endpoint."""
        try:
            if self._supports_obs_snapshot:
                try:
                    self.last_snapshot = self.proxy.call("obs_snapshot")
                except RPCError:
                    # older worker without the endpoint: remember, fall back
                    self._supports_obs_snapshot = False
                    self.proxy.call("ping")
            else:
                self.proxy.call("ping")
        except (CommunicationError, RPCError):
            return False
        self.last_seen_mono = time.monotonic()
        return True

    def shutdown(self) -> None:
        try:
            self.proxy.call("shutdown")
        except (CommunicationError, RPCError):
            pass


class Dispatcher:
    def __init__(
        self,
        run_id: str,
        nameserver: str = "127.0.0.1",
        nameserver_port: Optional[int] = None,
        host: Optional[str] = None,
        ping_interval: float = 10.0,
        discover_interval: float = 1.0,
        logger: Optional[logging.Logger] = None,
        anomaly: Any = None,
        dead_letter_capacity: int = 64,
        max_job_requeues: int = 8,
        requeue_backoff: float = 0.25,
        requeue_backoff_cap: float = 8.0,
        quarantine_s: float = 60.0,
    ):
        self.run_id = run_id
        self.nameserver_uri = format_uri(nameserver, nameserver_port)
        self.host = host or "127.0.0.1"
        self.ping_interval = ping_interval
        self.discover_interval = discover_interval
        self.logger = logger or logging.getLogger("hpbandster_tpu_torch.dispatcher")

        self.prefix = f"hpbandster.run_{run_id}.worker."
        self.workers: Dict[str, WorkerProxy] = {}
        self.waiting_jobs: List[Job] = []
        self.running_jobs: Dict[Any, Job] = {}

        #: dead-letter trail for results that arrive for unknown jobs (the
        #: worker already computed them — the payload must not vanish):
        #: counted in obs metrics, retained for post-mortems, and KEYED so
        #: a resubmitted job can claim its stranded payload on submit.
        #: Capacity is a knob; overflow counts dispatcher.dead_letters_dropped
        #: instead of silently discarding computed work
        self.dead_letters = DeadLetterBox(capacity=dead_letter_capacity)
        #: exactly-once result ingestion: first copy of each idempotency
        #: key joins the run, every later copy is a counted duplicate
        self._gate = ExactlyOnceGate()

        #: requeue retry budget (capped exponential backoff): a job whose
        #: workers keep dying redispatches at most this many times before
        #: it fails with an exception result instead of looping forever
        self.max_job_requeues = int(max_job_requeues)
        self.requeue_backoff = float(requeue_backoff)
        self.requeue_backoff_cap = float(requeue_backoff_cap)

        #: quarantine ledger: worker name -> monotonic expiry. Quarantined
        #: names are skipped by discovery until expiry, so a flapping host
        #: cannot rejoin the pool faster than it crashes out of it
        self.quarantine_s = float(quarantine_s)
        self._quarantined: Dict[str, float] = {}

        self._cond = threading.Condition()
        self._shutdown_event = threading.Event()
        self._server: Optional[RPCServer] = None
        self._threads: List[threading.Thread] = []
        self._new_result_callback: Optional[Callable[[Job], None]] = None
        self._new_worker_callback: Optional[Callable[[int], None]] = None

        #: opt-in streaming anomaly detection (obs/anomaly.py): truthy
        #: subscribes a detector to the process bus for the run's lifetime
        #: and surfaces its alert tally in this dispatcher's obs_snapshot
        #: (pass AnomalyRules to tune thresholds, True for defaults)
        self.anomaly_detector = None
        self._anomaly_detach: Optional[Callable[[], None]] = None
        self._alert_detach: Optional[Callable[[], None]] = None
        if anomaly:
            from hpbandster_tpu_torch.obs.anomaly import AnomalyDetector, AnomalyRules

            self.anomaly_detector = AnomalyDetector(
                rules=anomaly if isinstance(anomaly, AnomalyRules) else None,
                bus=obs.get_bus(),
            )

    # --------------------------------------------------------- executor seam
    def start(
        self,
        new_result_callback: Callable[[Job], None],
        new_worker_callback: Callable[[int], None],
    ) -> None:
        self._new_result_callback = new_result_callback
        self._new_worker_callback = new_worker_callback

        self._server = RPCServer(self.host, 0)
        self._server.register("register_result", self._rpc_register_result)
        self._server.register("ping", lambda: "pong")
        if self.anomaly_detector is not None:
            self._anomaly_detach = obs.get_bus().subscribe(self.anomaly_detector)
            # close the loop: the detector's alerts were previously only
            # counted — now worker_flapping quarantines the worker it
            # names (drop + rediscovery ban + requeue of its job)
            self._alert_detach = obs.get_bus().subscribe(self._on_alert)
        # fleet health: the dispatcher introspects like any other process
        HealthEndpoint(
            component="dispatcher",
            identity=obs.process_identity(run_id=self.run_id),
            ring=self.dead_letters,
            in_flight=self._health_in_flight,
            anomaly=self.anomaly_detector,
        ).register(self._server)
        self._server.start()

        for target, name in (
            (self._discover_loop, "discover"),
            (self._job_runner_loop, "job-runner"),
            (self._ping_loop, "ping"),
        ):
            t = threading.Thread(
                target=target, daemon=True, name=f"dispatcher-{name}-{self.run_id}"
            )
            t.start()
            self._threads.append(t)

    def submit_job(self, job: Job) -> None:
        if job.idem_key is None:
            job.idem_key = idempotency_key(job.id, job.kwargs.get("budget", 0.0))
        # exactly-once dead-letter replay: a resubmitted job (crash-restart
        # re-dispatching its unfinished configs) whose result already
        # arrived — and was dead-lettered because nobody knew the job —
        # joins that payload back instead of re-running the evaluation
        letter = self.dead_letters.take(job.idem_key)
        if letter is not None and not self._gate.admit(job.idem_key):
            # the key was already ingested once — the letter is a stale
            # duplicate copy, not recoverable work
            obs.get_metrics().counter("recovery.duplicates_dropped").inc()
            letter = None
        if letter is not None:
            self.logger.info(
                "job %s joined its dead-lettered result on submit", job.id
            )
            obs.emit(
                obs.RESULT_REPLAYED,
                config_id=list(job.id), budget=job.kwargs.get("budget"),
                source="dead_letter", key=job.idem_key,
            )
            obs.get_metrics().counter("recovery.replayed_results").inc()
            self._deliver(job, letter.get("result") or {})
            return
        with self._cond:
            self.waiting_jobs.append(job)
            self._update_queue_gauges()
            self._cond.notify_all()

    def _deliver(self, job: Job, payload: Dict[str, Any]) -> None:
        """Hand a terminal payload to the master's callback (shared by the
        normal ingest path, dead-letter joins, and budget exhaustion)."""
        if "started" not in job.timestamps:
            job.time_it("started")
        job.time_it("finished")
        job.result = payload.get("result")
        job.exception = payload.get("exception")
        self._new_result_callback(job)

    def _update_queue_gauges(self) -> None:
        # callers hold self._cond; the gauges' own registry lock nests
        # inside it (metrics code never takes dispatcher locks, so the
        # ordering is acyclic)
        m = obs.get_metrics()
        m.gauge("dispatcher.queue_depth").set(len(self.waiting_jobs))  # graftlint: disable=lock-coverage — every caller holds self._cond
        m.gauge("dispatcher.jobs_in_flight").set(len(self.running_jobs))  # graftlint: disable=lock-coverage — every caller holds self._cond

    def _health_in_flight(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "running": [list(cid) for cid in self.running_jobs],
                "waiting": len(self.waiting_jobs),
                "workers": len(self.workers),
                "quarantined": sorted(self._quarantined),
            }

    def number_of_workers(self) -> int:
        with self._cond:
            return len(self.workers)

    def n_waiting(self) -> int:
        with self._cond:
            return len(self.waiting_jobs)

    def shutdown(self, shutdown_workers: bool = False) -> None:
        self._shutdown_event.set()
        if shutdown_workers:
            with self._cond:
                targets = list(self.workers.values())
            for w in targets:
                w.shutdown()
        with self._cond:
            self._cond.notify_all()
        if self._anomaly_detach is not None:
            self._anomaly_detach()
            self._anomaly_detach = None
        if self._alert_detach is not None:
            self._alert_detach()
            self._alert_detach = None
        if self._server is not None:
            self._server.shutdown()
            self._server = None

    # ------------------------------------------------------------- discovery
    def _discover_loop(self) -> None:
        ns = RPCProxy(self.nameserver_uri, timeout=5)
        while not self._shutdown_event.wait(0.0):
            try:
                listing: Dict[str, str] = ns.call("list", prefix=self.prefix)
            except (CommunicationError, RPCError) as e:
                self.logger.debug("nameserver unreachable: %r", e)
                listing = None
            if listing is not None:
                self._sync_workers(listing)
            if self._shutdown_event.wait(self.discover_interval):
                return

    def _sync_workers(self, listing: Dict[str, str]) -> None:
        with self._cond:
            known = set(self.workers)
            now = time.monotonic()
            # expire served quarantines; anything still listed is banned
            self._quarantined = {
                n: t for n, t in self._quarantined.items() if t > now
            }
            quarantined = set(self._quarantined)
        added = 0
        for name, uri in listing.items():
            if name in known:
                continue
            if name in quarantined:
                self.logger.debug(
                    "worker %s still quarantined; not rediscovering", name
                )
                continue
            w = WorkerProxy(name, uri)
            if not w.is_alive():
                self.logger.debug("listed worker %s unreachable; skipping", name)
                continue
            with self._cond:
                self.workers[name] = w
            added += 1
            obs.emit(obs.WORKER_DISCOVERED, worker=name, uri=uri)
            obs.get_metrics().counter("dispatcher.workers_discovered").inc()
            self.logger.info("discovered worker %s at %s", name, uri)
        vanished = known - set(listing)
        for name in vanished:
            self._drop_worker(name, reason="unregistered")
        if added or vanished:
            with self._cond:
                n = len(self.workers)
                self._cond.notify_all()
            self._new_worker_callback(n)

    # ------------------------------------------------- bounded retry budget
    def _stamp_requeue(self, job: Job) -> bool:
        """Consume one requeue attempt: True = still within budget (the
        job now carries its capped-exponential-backoff eligibility
        instant), False = budget exhausted (the caller must fail the job
        via :meth:`_fail_exhausted`). ONE implementation for the
        worker-death and dispatch-failure paths — the retry contract
        (docs/fault_tolerance.md) must not be able to diverge."""
        job.requeue_count += 1
        if job.requeue_count > self.max_job_requeues:
            return False
        job.not_before_mono = time.monotonic() + min(
            self.requeue_backoff * (2.0 ** (job.requeue_count - 1)),
            self.requeue_backoff_cap,
        )
        return True

    def _note_requeued(self, job: Job, worker: str, reason: str) -> None:
        obs.emit(
            obs.JOB_REQUEUED,
            config_id=list(job.id), worker=worker, reason=reason,
            attempt=job.requeue_count, max_attempts=self.max_job_requeues,
        )
        obs.get_metrics().counter("recovery.requeues").inc()

    def _fail_exhausted(self, job: Job, worker: str, reason: str) -> None:
        """Terminal failure once the retry budget is gone — through the
        exactly-once gate, so a genuinely-late result arriving after the
        failure reads as a duplicate, never a double registration."""
        obs.get_metrics().counter("recovery.requeue_budget_exhausted").inc()
        self.logger.error(
            "job %s exhausted its requeue budget (%d attempts); failing",
            job.id, job.requeue_count,
        )
        if self._gate.admit(job.idem_key or ""):
            self._deliver(job, {
                "result": None,
                "exception": (
                    f"requeue budget exhausted: {job.requeue_count} "
                    f"dispatch attempts all failed "
                    f"(last: {worker}, {reason})"
                ),
            })

    def _drop_worker(self, name: str, reason: str) -> None:
        failed_job: Optional[Job] = None
        with self._cond:
            w = self.workers.pop(name, None)
            if w is None:
                return
            job = self.running_jobs.pop(tuple(w.runs_job), None) if w.runs_job else None
            if job is not None:
                if self._stamp_requeue(job):
                    # elastic failure handling: requeue the orphaned job
                    # under capped backoff (a config that kills its
                    # workers must not hot-loop the survivors)
                    self.logger.warning(
                        "worker %s vanished (%s); requeueing job %s "
                        "(attempt %d/%d)",
                        name, reason, job.id,
                        job.requeue_count, self.max_job_requeues,
                    )
                    self.waiting_jobs.insert(0, job)
                else:
                    # retry budget exhausted: fail the job instead of
                    # cycling it through the pool forever — the bracket
                    # records it crashed-as-worst and moves on
                    failed_job = job
                self._update_queue_gauges()
            else:
                self.logger.info("worker %s dropped (%s)", name, reason)
            self._cond.notify_all()
        obs.emit(
            obs.WORKER_DROPPED,
            worker=name, reason=reason,
            # only report a requeue that actually happened: a job failed
            # for exhausting its retry budget was NOT requeued
            requeued=(
                list(job.id)
                if job is not None and failed_job is None else None
            ),
        )
        obs.get_metrics().counter("dispatcher.workers_dropped").inc()
        if job is not None and failed_job is None:
            self._note_requeued(job, name, reason)
        # a departed worker's last-seen-age gauge must leave with it, or
        # elastic churn leaks stale frozen metrics without bound
        obs.get_metrics().remove(f"dispatcher.worker_last_seen_age_s.{name}")
        if failed_job is not None:
            self._fail_exhausted(failed_job, name, reason)

    def _ping_loop(self) -> None:
        """Heartbeat collector: detect dying workers (requeue their jobs)
        and keep the fleet-health gauges current."""
        while not self._shutdown_event.wait(self.ping_interval):
            self._heartbeat_round()

    def _heartbeat_round(self) -> None:
        """One sweep over every known worker: ``obs_snapshot`` (or ``ping``
        for older peers) each one, drop the unreachable — a dead idle
        worker must leave the pool, not just a dead busy one — and feed
        the ``dispatcher.workers_alive`` / per-worker last-seen-age
        gauges."""
        with self._cond:
            targets = list(self.workers.items())
        alive = 0
        for name, w in targets:
            if w.heartbeat():
                alive += 1
            else:
                self._drop_worker(name, reason="heartbeat failed")
        m = obs.get_metrics()
        m.gauge("dispatcher.workers_alive").set(alive)
        now = time.monotonic()
        with self._cond:
            survivors = list(self.workers.values())
        for w in survivors:
            m.gauge(f"dispatcher.worker_last_seen_age_s.{w.name}").set(
                round(now - w.last_seen_mono, 3)
            )

    # ------------------------------------------------------------ job runner
    def _idle_worker(self) -> Optional[WorkerProxy]:
        # sole caller is _job_runner_loop, inside `with self._cond:`
        for w in self.workers.values():  # graftlint: disable=lock-coverage
            if w.runs_job is None:
                return w
        return None

    def _job_runner_loop(self) -> None:
        while not self._shutdown_event.is_set():
            with self._cond:
                job = None
                worker = None
                if self.waiting_jobs:
                    worker = self._idle_worker()
                    if worker is not None:
                        # first ELIGIBLE job: requeued jobs sit out their
                        # capped backoff window while fresh jobs behind
                        # them keep the pool busy
                        now = time.monotonic()
                        for i, candidate in enumerate(self.waiting_jobs):
                            if candidate.not_before_mono <= now:
                                job = self.waiting_jobs.pop(i)
                                break
                        if job is not None:
                            worker.runs_job = job.id
                            self.running_jobs[tuple(job.id)] = job
                            self._update_queue_gauges()
                if job is None:
                    self._cond.wait(0.2)
                    continue
            # RPC outside the lock: the worker spawns a compute thread and
            # returns immediately
            job.time_it("started")
            job.worker_name = worker.name
            queue_wait = job.mono_duration("submitted", "started")
            try:
                # under the job's trace AND tenant: the RPC proxy injects
                # the _obs envelope, so the worker's half of the timeline
                # carries the same trace_id (and, in the serving tier,
                # journals under the right tenant)
                with obs.use_tenant(
                    getattr(job, "tenant_id", None)
                ), obs.use_trace(getattr(job, "trace", None)):
                    t0 = time.monotonic()
                    worker.proxy.call(
                        "start_computation",
                        callback_uri=self._server.uri,
                        id=list(job.id),
                        **job.kwargs,
                    )
                    obs.emit(
                        obs.JOB_STARTED,
                        config_id=list(job.id), worker=worker.name,
                        queue_wait_s=(
                            round(queue_wait, 6) if queue_wait is not None else None
                        ),
                        dispatch_s=round(time.monotonic() - t0, 6),
                    )
                self.logger.debug("job %s -> %s", job.id, worker.name)
            except (CommunicationError, RPCError) as e:
                self.logger.warning(
                    "dispatch of %s to %s failed (%r)", job.id, worker.name, e
                )
                with self._cond:
                    self.running_jobs.pop(tuple(job.id), None)
                    worker.runs_job = None
                if isinstance(e, CommunicationError):
                    self._drop_worker(worker.name, reason="dispatch failed")
                # same bounded-retry contract as a worker death: a job
                # whose dispatch keeps failing (e.g. a kwargs payload the
                # server rejects every time) must back off and eventually
                # fail, not hot-loop through the next idle worker
                self._requeue_or_fail(
                    job, worker.name, reason=f"dispatch failed: {e!r}"
                )

    def _requeue_or_fail(self, job: Job, worker: str, reason: str) -> None:
        """Bounded requeue for a job whose dispatch attempt failed: the
        same budget/backoff contract as the worker-death path in
        ``_drop_worker`` (shared via ``_stamp_requeue``/``_fail_exhausted``)."""
        if not self._stamp_requeue(job):
            self._fail_exhausted(job, worker, reason)
            return
        with self._cond:
            self.waiting_jobs.insert(0, job)
            self._update_queue_gauges()
            self._cond.notify_all()
        self._note_requeued(job, worker, reason)

    # ---------------------------------------------------------- result inflow
    def _rpc_register_result(
        self, id: Any, result: Dict[str, Any], key: Optional[str] = None
    ) -> bool:
        """Exactly-once result ingestion.

        ``key`` is the job's idempotency key, stamped by the worker
        (``core/worker.py`` sends it on every delivery attempt; older
        workers omit it and the dispatcher recovers it from its own job
        records). Resolution order:

        1. job running under this cid AND matching this key -> gate-admit,
           deliver (duplicates counted + ACKED so the delivering worker
           stops retrying);
        2. matching job requeued and still WAITING -> claim it from the
           queue and deliver (a late result from a presumed-dead worker
           means the work is done — never redo it);
        3. no matching job, key already ingested -> duplicate, acked;
        4. no matching job, unknown key -> dead-letter (keyed, bounded,
           overflow counted), awaiting a resubmit to join back.

        The claim is KEY-aware, not just cid-aware: a config re-runs at
        every rung with the same cid, so a late duplicate of its
        budget-1 delivery must never claim (and discard) its live
        budget-3 job — a cross-budget copy falls through to 3/4 instead.
        A keyless delivery (old worker) matches by cid alone, the
        pre-key behavior.
        """

        def matches(candidate: Job) -> bool:
            return (
                key is None
                or candidate.idem_key is None
                or key == candidate.idem_key
            )

        cid = tuple(id)
        duplicate = False
        with self._cond:
            job = self.running_jobs.get(cid)
            if job is not None and matches(job):
                del self.running_jobs[cid]
            else:
                job = None
                # a requeued-but-not-redispatched job can still claim its
                # late result: the evaluation is DONE, drop it from the
                # queue instead of re-running it
                for i, waiting in enumerate(self.waiting_jobs):
                    if tuple(waiting.id) == cid and matches(waiting):
                        job = self.waiting_jobs.pop(i)
                        break
            if job is not None:
                if job.idem_key is None:
                    job.idem_key = idempotency_key(
                        job.id, job.kwargs.get("budget", 0.0)
                    )
                # admit under the SAME lock as the claim: a concurrent
                # copy of this delivery either still sees the job (and
                # queues behind this claim) or sees the admitted key —
                # never the neither-window that would dead-letter an
                # already-ingested payload as a phantom unknown result
                admitted = self._gate.admit(
                    key if key is not None else job.idem_key
                )
                for w in self.workers.values():
                    if w.runs_job is not None and tuple(w.runs_job) == cid:
                        w.runs_job = None
                self._update_queue_gauges()
                self._cond.notify_all()
            else:
                # late retry of an already-ingested delivery (e.g. the
                # ack of the first copy was lost): duplicate, acked,
                # never re-joined. Checked under _cond for the same
                # race-closure as the admit above.
                duplicate = key is not None and self._gate.seen(key)
        if job is not None:
            if not admitted:
                self._note_duplicate(cid, key or job.idem_key)
                return True  # ACK: the result is ingested, stop retrying
            self._deliver(job, result)
            return True
        if duplicate:
            self._note_duplicate(cid, key)
            return True
        # dead-letter, don't drop: a worker computed this (e.g. a late
        # result landing after its worker was declared dead, requeued,
        # and re-discovered) — count it and retain the payload for
        # post-mortems AND replay: a later submit of the same key joins
        # it back exactly once. Outside the lock: sinks do I/O, and a
        # journal write must not stall the job-runner loop on self._cond.
        # The delivering worker's trace and tenant (the _obs envelope on
        # this very RPC) are retained with it, so the dead letter joins
        # back onto the merged timeline — and a multi-tenant post-mortem
        # can attribute the orphaned payload to the sweep that paid for it.
        tc = obs.current_trace()
        self.dead_letters.append({
            "config_id": list(cid), "result": result, "key": key,
            "trace_id": tc.trace_id if tc is not None else None,
            "tenant_id": obs.current_tenant() or obs.DEFAULT_TENANT,
        })
        obs.get_metrics().counter("dispatcher.unknown_results").inc()
        obs.emit(obs.UNKNOWN_RESULT, config_id=list(cid))
        self.logger.warning(
            "result for unknown job %s dead-lettered (%d retained)",
            cid, len(self.dead_letters),
        )
        return False

    def _note_duplicate(self, cid: Any, key: Optional[str]) -> None:
        obs.get_metrics().counter("recovery.duplicates_dropped").inc()
        obs.emit(obs.DUPLICATE_RESULT, config_id=list(cid), key=key)
        self.logger.info("duplicate result for %s (key %s) dropped", cid, key)

    # ------------------------------------------------------------ quarantine
    def _on_alert(self, event: Any) -> None:
        """Bus sink closing the anomaly loop: a ``worker_flapping`` alert
        quarantines the worker it names (this dispatcher's prefix only —
        a foreign journal's worker ids are not ours to act on)."""
        try:
            if getattr(event, "name", None) != "alert":
                return
            fields = getattr(event, "fields", None) or {}
            if fields.get("rule") != "worker_flapping":
                return
            subject = str(fields.get("subject") or "")
            if subject.startswith(self.prefix):
                self.quarantine_worker(subject, reason="worker_flapping")
        except Exception:
            # bus sinks must never raise (events.py contract)
            self.logger.exception("alert-driven quarantine failed")

    def quarantine_worker(
        self, name: str, reason: str, duration_s: Optional[float] = None
    ) -> None:
        """Drop ``name`` (its in-flight job requeues under the normal
        retry budget) and ban it from rediscovery for ``duration_s``
        (default ``quarantine_s``) — a flapping host must sit out, not
        cycle through discover/crash/requeue."""
        duration = self.quarantine_s if duration_s is None else float(duration_s)
        with self._cond:
            already = name in self._quarantined
            self._quarantined[name] = time.monotonic() + duration
        self._drop_worker(name, reason=f"quarantined ({reason})")
        if not already:
            obs.emit(
                obs.WORKER_QUARANTINED,
                worker=name, reason=reason, duration_s=duration,
            )
            obs.get_metrics().counter("recovery.quarantines").inc()
            self.logger.warning(
                "worker %s quarantined for %.1fs (%s)", name, duration, reason
            )
