"""Worker — the user-code evaluation plugin, host tier.

Ported from ``hpbandster_tpu/core/worker.py``, a copy; its persistent
compile cache is the port's kernel cache (``utils/compile_cache.py``), which
holds the nvcc libraries of the kernels.

API-compatible with the reference's ``core/worker.py`` (SURVEY.md §2):
subclass, implement ``compute(config_id, config, budget,
working_directory) -> {'loss': float, 'info': ...}``, then ``run()`` either
in-process (``background=True``, the test/examples fixture) or as a
standalone (possibly remote) process that discovers the master through the
nameserver or a shared-directory credentials file.

Transport is the stdlib TCP RPC layer instead of Pyro4; semantics kept:
one job at a time, exceptions captured as traceback strings, results pushed
back to the dispatcher's callback URI, optional idle-timeout self-shutdown.

Worker-side observability (docs/observability.md "Trace propagation"):
the dispatcher's ``start_computation`` call carries the job's trace in the
``_obs`` envelope; the RPC handler enters it, :meth:`_rpc_start_computation`
captures it (threads do NOT inherit contextvars) and the compute thread
re-enters it — so every worker event carries the same ``trace_id`` the
master minted. Pass ``journal_path`` to give the worker its OWN journal,
stamped with ``{host, pid, worker_id}``: merged with the master's via
``python -m hpbandster_tpu_torch.obs summarize a.jsonl b.jsonl`` it yields the
cross-host per-job timeline. Result delivery retries with capped
exponential backoff before a computed result is ever abandoned.
"""

from __future__ import annotations

import logging
import os
import pickle
import socket
import threading
import time
import traceback
from typing import Any, Dict, Optional

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.obs.events import make_event
from hpbandster_tpu_torch.obs.journal import event_to_record
from hpbandster_tpu_torch.parallel.rpc import RPCProxy, RPCServer, format_uri

__all__ = ["Worker"]


class Worker:
    def __init__(
        self,
        run_id: str,
        nameserver: Optional[str] = None,
        nameserver_port: Optional[int] = None,
        logger: Optional[logging.Logger] = None,
        host: Optional[str] = None,
        id: Optional[Any] = None,
        timeout: Optional[float] = None,
        journal_path: Optional[str] = None,
    ):
        self.run_id = run_id
        self.nameserver = nameserver
        self.nameserver_port = nameserver_port
        self.host = host or "127.0.0.1"
        self.worker_id = (
            f"hpbandster.run_{run_id}.worker.{socket.gethostname()}.{os.getpid()}"
            f".{threading.get_native_id()}"
        )
        if id is not None:
            self.worker_id += f".{id}"
        self.logger = logger or logging.getLogger(
            f"hpbandster_tpu_torch.worker.{os.getpid()}"
        )
        self.timeout = timeout

        self._server: Optional[RPCServer] = None
        self._busy_lock = threading.Lock()
        self._shutdown_event = threading.Event()
        # monotonic: the idle watchdog computes durations from this, and
        # a host clock step must not self-shutdown a healthy worker
        self._last_active = time.monotonic()
        self._timeout_thread: Optional[threading.Thread] = None

        # ---- observability: worker-local journal / ring / health -------
        #: result-delivery retry policy (capped exponential backoff) — a
        #: computed result is only abandoned after every attempt fails
        self.result_delivery_attempts = 4
        self.result_delivery_backoff = 0.5
        self.result_delivery_backoff_cap = 8.0
        self.journal_path = journal_path
        self._journal: Optional[obs.JsonlJournal] = None
        self._ring = obs.RingBuffer(capacity=64)
        self._current_job: Optional[Any] = None  # config_id while computing

    # -------------------------------------------------------------- bootstrap
    def load_nameserver_credentials(
        self, working_directory: str, num_tries: int = 60, interval: float = 1.0
    ) -> None:
        """Poll the shared directory for the nameserver credentials file
        (cluster bootstrap path, reference §2 NameServer row)."""
        fn = os.path.join(working_directory, f"HPB_run_{self.run_id}_pyro.pkl")
        for attempt in range(num_tries):
            try:
                with open(fn, "rb") as fh:
                    self.nameserver, self.nameserver_port = pickle.load(fh)
                return
            except FileNotFoundError:
                self.logger.warning(
                    "config file %s not found (trying %d/%d)", fn, attempt + 1, num_tries
                )
                time.sleep(interval)
        raise RuntimeError(f"could not find nameserver credentials in {working_directory}")

    # -------------------------------------------------------------- lifecycle
    def run(self, background: bool = False) -> None:
        """Serve jobs. ``background=True`` returns immediately (daemon
        threads), the in-process mode the test suite uses; otherwise blocks
        until shutdown."""
        if self.nameserver is None:
            raise RuntimeError("no nameserver specified (or credentials loaded)")
        # compute() may launch the port's kernels: point their builds at the
        # shared kernel cache first, so a restarted worker runs no nvcc
        # (HPB_XLA_CACHE=0 opts out)
        from hpbandster_tpu_torch.utils.compile_cache import (
            enable_persistent_compile_cache,
        )

        enable_persistent_compile_cache()
        if self.journal_path is not None and self._journal is None:
            # the worker's own half of the distributed story: every record
            # stamped with this process's identity (merge-ready)
            self._journal = obs.JsonlJournal(
                self.journal_path, static_fields=self.identity()
            )
        self._server = RPCServer(self.host, 0)
        self._server.register("start_computation", self._rpc_start_computation)
        self._server.register("is_busy", self._rpc_is_busy)
        self._server.register("shutdown", self._rpc_shutdown)
        self._server.register("ping", lambda: "pong")
        obs.HealthEndpoint(
            component="worker",
            identity=self.identity(),
            ring=self._ring,
            in_flight=self._health_in_flight,
        ).register(self._server)
        self._extra_rpc(self._server)
        self._server.start()

        ns = RPCProxy(format_uri(self.nameserver, self.nameserver_port))
        ns.call("register", name=self.worker_id, uri=self._server.uri)
        self.logger.info(
            "worker %s serving at %s", self.worker_id, self._server.uri
        )

        if self.timeout is not None:
            self._timeout_thread = threading.Thread(
                target=self._timeout_watchdog, daemon=True
            )
            self._timeout_thread.start()

        if not background:
            self._shutdown_event.wait()
            self._teardown()

    def _timeout_watchdog(self) -> None:
        while not self._shutdown_event.wait(min(self.timeout, 1.0)):
            idle = time.monotonic() - self._last_active
            if not self._busy_lock.locked() and idle > self.timeout:
                self.logger.info("worker idle for %.1fs; self-shutdown", idle)
                self.shutdown()
                return

    def _teardown(self) -> None:
        try:
            ns = RPCProxy(format_uri(self.nameserver, self.nameserver_port), timeout=2)
            ns.call("unregister", name=self.worker_id)
        except Exception as e:
            # best-effort: the nameserver may already be gone at teardown
            self.logger.debug("unregister from nameserver failed: %r", e)
        if self._server is not None:
            self._server.shutdown()
            self._server = None
        if self._journal is not None:
            self._journal.close()

    def shutdown(self) -> None:
        self._shutdown_event.set()
        # when running in background mode nobody waits on the event; tear
        # down from here (idempotent)
        if self._server is not None:
            threading.Thread(target=self._teardown, daemon=True).start()

    # ------------------------------------------------------------ rpc surface
    def _extra_rpc(self, server: RPCServer) -> None:
        """Hook for subclasses to register additional RPC methods before the
        server starts (e.g. TPUBatchedWorker's ``evaluate_batch``)."""

    def _rpc_is_busy(self) -> bool:
        return self._busy_lock.locked()

    def _rpc_shutdown(self) -> bool:
        self.logger.debug("shutdown requested via RPC")
        self.shutdown()
        return True

    # ------------------------------------------------------- observability
    def identity(self) -> Dict[str, Any]:
        """This worker process's static identity stamp (journal records,
        health snapshots): ``{host, pid, worker_id}``."""
        return obs.process_identity(worker_id=self.worker_id)

    def _health_in_flight(self) -> Optional[list]:
        cj = self._current_job  # one read: the compute thread may clear it
        return list(cj) if cj is not None else None

    def _emit(self, name: str, **fields: Any) -> None:
        """Worker-side event emission: into the worker's own journal when
        one is configured (its half of a merged cross-host timeline, with
        the current trace_id stamped by ``make_event``), otherwise onto
        the process bus; the health ring always keeps the newest few.

        Never raises: a full disk or closed journal must not wedge the
        busy lock or strand a computed result — the same shielding the
        EventBus gives its sinks."""
        if not obs.enabled():
            return
        try:
            ev = make_event(name, fields)
            self._ring.append(event_to_record(ev))
            if self._journal is not None:
                self._journal(ev)
            else:
                obs.get_bus().publish(ev)
        except Exception:
            self.logger.exception("worker obs emit %s failed", name)

    # ------------------------------------------------------------- compute
    def _rpc_start_computation(
        self, callback_uri: str, id: Any, **job_kwargs: Any
    ) -> bool:
        if not self._busy_lock.acquire(blocking=False):
            raise RuntimeError("worker is busy")
        self._last_active = time.monotonic()
        self._current_job = tuple(id)
        # threads do not inherit contextvars: capture the trace AND the
        # tenant the RPC handler extracted from the _obs envelope and
        # hand them to the compute thread explicitly
        thread = threading.Thread(
            target=self._run_job,
            args=(callback_uri, tuple(id), job_kwargs, obs.current_trace(),
                  obs.current_tenant()),
            daemon=True,
            name=f"compute-{id}",
        )
        thread.start()
        return True

    def _run_job(
        self,
        callback_uri: str,
        config_id: Any,
        job_kwargs: Dict[str, Any],
        trace_ctx: Optional[obs.TraceContext] = None,
        tenant: Optional[str] = None,
    ) -> None:
        # under both identities: worker-side journal twins carry the
        # master's trace_id AND (serving tier) its tenant_id, and the
        # register_result RPC ships them back in its own envelope
        with obs.use_tenant(tenant), obs.use_trace(trace_ctx):
            self._emit(
                obs.JOB_STARTED,
                config_id=list(config_id), budget=job_kwargs.get("budget"),
            )
            result: Optional[Dict[str, Any]] = None
            exception: Optional[str] = None
            t0 = time.monotonic()
            try:
                result = self.compute(config_id=config_id, **job_kwargs)
                if not isinstance(result, dict) or "loss" not in result:
                    raise TypeError(
                        "compute() must return a dict with a 'loss' key, got "
                        f"{type(result).__name__}"
                    )
            except Exception:
                result = None
                exception = traceback.format_exc()
                self.logger.warning("compute crashed:\n%s", exception)
            finally:
                compute_s = time.monotonic() - t0
                self._last_active = time.monotonic()
                # guarded: once the busy lock is released a NEW job may
                # already own the marker while this thread is still in
                # delivery backoff — never clobber it
                if self._current_job == tuple(config_id):
                    self._current_job = None
                self._busy_lock.release()
            self._emit(
                obs.JOB_FAILED if exception is not None else obs.JOB_FINISHED,
                config_id=list(config_id), budget=job_kwargs.get("budget"),
                compute_s=round(compute_s, 6),
            )
            # feeds this worker's obs_snapshot `latency` section — what
            # `watch --snapshot <worker>` renders with no journal on disk
            obs.get_metrics().histogram("worker.compute_s").observe(compute_s)
            self._deliver_result(
                callback_uri, config_id,
                {"result": result, "exception": exception},
                budget=job_kwargs.get("budget"),
            )

    def _deliver_result(
        self,
        callback_uri: str,
        config_id: Any,
        payload: Dict[str, Any],
        budget: Any = None,
    ) -> bool:
        """Push the result to the dispatcher, retrying transient failures
        with capped exponential backoff — a single failed RPC must not
        strand a result the worker already paid to compute.

        Every attempt carries the job's idempotency key
        (``core/recovery.py``): a retry racing a slow ack of the first
        attempt used to deliver TWICE (the second copy dead-lettered or,
        worse, double-registered after a requeue) — the dispatcher's
        exactly-once gate now recognizes the key and acks the duplicate
        without re-ingesting it.
        """
        from hpbandster_tpu_torch.core.recovery import idempotency_key

        key = (
            idempotency_key(config_id, budget)
            if isinstance(budget, (int, float)) else None
        )
        t0 = time.monotonic()
        delay = self.result_delivery_backoff
        attempts = max(int(self.result_delivery_attempts), 1)
        for attempt in range(1, attempts + 1):
            try:
                RPCProxy(callback_uri, timeout=30).call(
                    "register_result", id=list(config_id), result=payload,
                    key=key,
                )
            # broad on purpose (matches the pre-retry behavior): a
            # serialization TypeError must be logged and counted like any
            # transport failure, not kill the compute thread silently —
            # the attempt cap bounds pointless retries either way
            except Exception as e:
                if attempt >= attempts:
                    obs.get_metrics().counter(
                        "worker.result_delivery_failures"
                    ).inc()
                    self.logger.error(
                        "could not deliver result for %s after %d attempts:\n%s",
                        config_id, attempt, traceback.format_exc(),
                    )
                    return False
                obs.get_metrics().counter("worker.result_delivery_retries").inc()
                self._emit(
                    obs.RPC_RETRY,
                    config_id=list(config_id), attempt=attempt,
                    max_attempts=attempts, error=type(e).__name__,
                )
                self.logger.warning(
                    "register_result %d/%d for %s failed (%r); retrying in %.2fs",
                    attempt, attempts, config_id, e, delay,
                )
                time.sleep(delay)
                delay = min(delay * 2.0, self.result_delivery_backoff_cap)
            else:
                self._emit(
                    obs.RESULT_DELIVERED,
                    config_id=list(config_id),
                    delivery_s=round(time.monotonic() - t0, 6),
                    attempts=attempt,
                )
                return True
        return False

    # --------------------------------------------------------------- user API
    def compute(
        self,
        config_id: Any,
        config: Dict[str, Any],
        budget: float,
        working_directory: str,
    ) -> Dict[str, Any]:
        """Evaluate ``config`` at ``budget``; MUST return
        ``{'loss': float, 'info': <json-serializable>}``."""
        raise NotImplementedError(
            "subclass hpbandster_tpu_torch.Worker and implement compute()"
        )
