"""TPUBatchedWorker + RPCBatchBackend — the multi-host batched tier.

Ported from ``hpbandster_tpu/parallel/batched_worker.py``: the worker's
backend is the port's ``VmapBackend`` on one device (``device=``):
``capabilities`` reports ``devices: 1``; there is no ``static_budget=``.
The compile-cache call points the kernels' builds at the port's kernel
cache (``utils/compile_cache.py``).

This is the bridge named in the north star (SURVEY.md §0 / §2 "Task
parallel" row): where the reference evaluates strictly one config per
worker per RPC round-trip, a ``TPUBatchedWorker`` is one host process per
card that evaluates a whole *vector* of configurations per job — the
batch runs as one batched call on the worker's device, and only the loss
vector rides the RPC link back.

Two halves:

* :class:`TPUBatchedWorker` — a :class:`~hpbandster_tpu_torch.core.worker.Worker`
  subclass that owns a :class:`~hpbandster_tpu_torch.parallel.backends.VmapBackend`
  on its device and exposes an ``evaluate_batch`` RPC. It remains
  fully compatible with the plain dispatcher: single-config jobs submitted
  through ``start_computation`` are evaluated as a batch of one, so a pool
  may mix CPU dict-workers and batched card workers behind one nameserver.
* :class:`RPCBatchBackend` — the master-side counterpart implementing the
  same ``evaluate(vectors, budget) -> losses`` protocol as ``VmapBackend``,
  so it plugs straight into ``BatchedExecutor`` (stage batching, bracket
  interleaving, crashed-as-NaN semantics all carry over). Each wave is
  split across the registered batched workers proportional to their device
  counts; worker death mid-wave retries the shard on the survivors and only
  NaN-fills when nobody is left (the reference's elastic requeue behavior,
  SURVEY.md §5, lifted to shard granularity).

Elasticity note: each worker's device is local to its process, so workers can
join/leave between waves without any global SPMD membership change — the
SURVEY §7 "confine elasticity to the host tier" rule.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.core.worker import Worker
from hpbandster_tpu_torch.parallel.mesh import config_mesh
from hpbandster_tpu_torch.parallel.rpc import (
    CommunicationError,
    RPCError,
    RPCProxy,
    RPCServer,
    format_uri,
)

__all__ = ["TPUBatchedWorker", "RPCBatchBackend"]


class TPUBatchedWorker(Worker):
    """A worker that evaluates a vector of configs per job on its device.

    ``eval_fn(vectors: f32[n, d], budget: float) -> f32[n]`` is the port's
    batched contract (the same as ``VmapBackend``'s and ``FusedBOHB``'s).
    ``configspace`` supplies the dict -> unit-hypercube codec for
    single-config (plain dispatcher) jobs.

    The backend runs each wave on ``device`` (``None`` means ``cuda``,
    which raises where there is none). ``mesh="auto"`` (the reference's
    default) with ``device=None`` is a config mesh over every visible card
    when there are several (``parallel.mesh.config_mesh()``), else that one
    card; with a named device, that device alone. An explicit mesh shards
    each wave over its config axis. ``capabilities`` reports the number of
    devices the waves run on.
    """

    def __init__(
        self,
        run_id: str,
        eval_fn: Callable,
        configspace=None,
        mesh: Any = "auto",
        min_pad: int = 8,
        device=None,
        **worker_kwargs: Any,
    ):
        super().__init__(run_id, **worker_kwargs)
        from hpbandster_tpu_torch.parallel.backends import VmapBackend
        from hpbandster_tpu_torch.utils.compile_cache import (
            enable_persistent_compile_cache,
        )

        # this worker launches the kernels on every batch: point their
        # builds at the shared kernel cache first
        enable_persistent_compile_cache()
        self.configspace = configspace
        if mesh == "auto":
            mesh = (config_mesh() if device is None and torch.cuda.is_available()
                    and torch.cuda.device_count() > 1 else None)
        self.backend = VmapBackend(eval_fn, mesh=mesh, min_pad=min_pad, device=device)

    # ------------------------------------------------------------ rpc surface
    def _extra_rpc(self, server: RPCServer) -> None:
        server.register("evaluate_batch", self._rpc_evaluate_batch)
        server.register("capabilities", self._rpc_capabilities)

    def _rpc_capabilities(self) -> Dict[str, Any]:
        return {"batch": True, "devices": int(self.backend.parallelism)}

    def _rpc_evaluate_batch(
        self, vectors: List[List[float]], budget: float
    ) -> Dict[str, Any]:
        """One wave: ``f32[n, d]`` unit-hypercube vectors -> ``f32[n]`` losses.

        Per-config crashes surface as non-finite losses (the caller maps
        them to crashed jobs); a backend-level failure raises and is
        marshalled back as an RPCError for the master to retry elsewhere.
        Holds the busy lock for the duration: concurrent waves serialize on
        the local devices, the dispatcher's ``is_busy`` probe reports the
        truth, and the idle-timeout watchdog cannot fire mid-evaluation.
        """
        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim != 2:
            raise ValueError(f"vectors must be [n, d], got shape {arr.shape}")
        with self._busy_lock:
            self._last_active = time.monotonic()
            t0 = time.perf_counter()
            with obs.span("worker_evaluate_batch", n=len(arr), budget=float(budget)):
                # the busy lock is held over the wave and its fetch by design
                # (see above): waves serialize on the local devices
                losses = self.backend.evaluate(arr, float(budget))  # graftlint: disable=lock-blocking — busy for the wave
            elapsed = time.perf_counter() - t0
            # each wave's evaluate span, readable over RPC (obs_snapshot)
            obs.get_metrics().histogram("worker.evaluate_batch_s").observe(elapsed)
            self.logger.debug(
                "evaluate_batch: %d configs at budget %g in %.3fs",
                len(arr), budget, elapsed,
            )
            self._last_active = time.monotonic()
        # stdlib json round-trips NaN/Infinity literals exactly, so crashed
        # (NaN) and diverged (+/-inf) losses survive the wire unchanged and
        # both backends agree on identical inputs
        return {"losses": [float(x) for x in losses]}

    # --------------------------------------------------------------- user API
    def compute(
        self,
        config_id: Any,
        config: Dict[str, Any],
        budget: float,
        working_directory: str,
    ) -> Dict[str, Any]:
        """Plain-dispatcher compatibility: one config = a batch of one."""
        if self.configspace is None:
            raise RuntimeError(
                "single-config jobs need configspace= for the dict->vector codec"
            )
        vec = np.nan_to_num(
            self.configspace.to_vector(config), nan=0.0
        ).astype(np.float32)
        loss = float(self.backend.evaluate(vec[None, :], float(budget))[0])
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss!r} at budget {budget}")
        return {"loss": loss, "info": {"batched": True}}


class _BatchWorkerProxy:
    """Master-side record of one batched worker."""

    def __init__(self, name: str, uri: str, devices: int):
        self.name = name
        self.uri = uri
        self.devices = max(int(devices), 1)

    def evaluate(self, vectors: np.ndarray, budget: float, timeout: float) -> np.ndarray:
        reply = RPCProxy(self.uri, timeout=timeout).call(
            "evaluate_batch",
            vectors=[[float(x) for x in row] for row in vectors],
            budget=float(budget),
        )
        # None tolerated defensively for non-stdlib peers that cannot emit
        # NaN/Infinity literals
        losses = np.array(
            [np.nan if x is None else x for x in reply["losses"]], dtype=np.float32
        )
        if losses.shape != (len(vectors),):
            raise CommunicationError(
                f"worker {self.name} returned {losses.shape[0]} losses for "
                f"{len(vectors)} configs"
            )
        return losses


class RPCBatchBackend:
    """``evaluate(vectors, budget) -> losses`` over a pool of batched workers.

    Discovery mirrors the dispatcher (SURVEY.md §2 "Dispatcher" row): the
    nameserver is polled for ``hpbandster.run_<id>.worker.*`` registrations
    and each candidate is probed once for the ``capabilities`` RPC — only
    batch-capable workers join the pool, so plain dict-workers behind the
    same nameserver are simply ignored. Waves are split proportionally to
    per-worker device counts and issued concurrently; a failed shard is
    retried on the surviving workers before NaN-filling.
    """

    def __init__(
        self,
        run_id: str,
        nameserver: str,
        nameserver_port: int,
        logger: Optional[logging.Logger] = None,
        rpc_timeout: float = 600.0,
        refresh_interval: float = 1.0,
        max_retries: int = 2,
    ):
        self.run_id = run_id
        self.nameserver = nameserver
        self.nameserver_port = nameserver_port
        self.logger = logger or logging.getLogger("hpbandster_tpu_torch.rpc_batch_backend")
        self.rpc_timeout = float(rpc_timeout)
        self.refresh_interval = float(refresh_interval)
        self.max_retries = int(max_retries)
        self._workers: Dict[str, _BatchWorkerProxy] = {}
        self._probed_not_batch: set = set()
        #: names with an in-flight capability probe (don't re-probe)
        self._probing: set = set()
        #: name -> earliest next-probe time after a transient failure, so an
        #: unreachable candidate doesn't get re-probed every refresh.
        #: MONOTONIC clock throughout the backoff/deadline math here: a
        #: wall-clock jump (NTP step, suspend/resume) must not expire — or
        #: indefinitely extend — a backoff window (Job.timestamps stays
        #: wall-clock verbatim; only internal arithmetic is monotonic)
        self._probe_backoff: Dict[str, float] = {}
        self.probe_backoff_s = 5.0
        self._last_refresh = 0.0
        self._lock = threading.Lock()

    # ------------------------------------------------------------- discovery
    @property
    def _prefix(self) -> str:
        return f"hpbandster.run_{self.run_id}.worker."

    def refresh_workers(self, force: bool = False) -> None:
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_refresh < self.refresh_interval:
                return
            # claim the slot before the (slow, unlocked) nameserver RPC so a
            # concurrent caller inside the same tick skips instead of issuing
            # a duplicate listing; an unreachable nameserver then also backs
            # off for one interval rather than re-stalling the hot path
            self._last_refresh = now
        try:
            listing = RPCProxy(
                format_uri(self.nameserver, self.nameserver_port), timeout=5
            ).call("list", prefix=self._prefix)
        except (CommunicationError, RPCError) as e:
            self.logger.warning("nameserver unreachable: %r", e)
            return
        with self._lock:
            gone = set(self._workers) - set(listing)
            for name in gone:
                self.logger.info("batched worker %s left the pool", name)
                obs.emit(obs.WORKER_DROPPED, worker=name, reason="unregistered")
                del self._workers[name]
            to_probe = []
            for name, uri in listing.items():
                if name in self._workers:
                    if self._workers[name].uri != uri:
                        self._workers[name].uri = uri
                elif (
                    name not in self._probed_not_batch
                    and name not in self._probing
                    and now >= self._probe_backoff.get(name, 0.0)
                ):
                    self._probing.add(name)
                    to_probe.append((name, uri))

        # Probe OUTSIDE the lock, concurrently, and WITHOUT joining:
        # refresh runs on the evaluate() hot path, so one unreachable-but-
        # registered candidate must never stall a wave behind its 5 s
        # connect timeout. A confirmed worker folds itself into the pool
        # when its probe lands; wait_for_workers()'s poll loop picks it up.
        def probe(name: str, uri: str) -> None:
            try:
                try:
                    caps = RPCProxy(uri, timeout=5).call("capabilities")
                except RPCError:
                    # a live worker without the method is definitively not
                    # batch-capable — cache the verdict
                    with self._lock:
                        self._probed_not_batch.add(name)
                    return
                except (CommunicationError, OSError):
                    # transient (connect timeout, mid-restart): don't
                    # blacklist, but back off so the stall can't recur on
                    # every refresh tick
                    with self._lock:
                        self._probe_backoff[name] = (
                            time.monotonic() + self.probe_backoff_s
                        )
                    return
                if not isinstance(caps, dict) or not caps.get("batch"):
                    with self._lock:
                        self._probed_not_batch.add(name)
                    return
                proxy = _BatchWorkerProxy(name, uri, caps.get("devices", 1))
                with self._lock:
                    self._workers[name] = proxy
                    self._probe_backoff.pop(name, None)
                obs.emit(
                    obs.WORKER_DISCOVERED, worker=name, devices=proxy.devices
                )
                self.logger.info(
                    "batched worker %s joined (%d devices)", name, proxy.devices
                )
            finally:
                with self._lock:
                    self._probing.discard(name)

        for c in to_probe:
            threading.Thread(target=probe, args=c, daemon=True).start()

    @property
    def parallelism(self) -> int:
        """Total devices across the pool (BatchedExecutor's worker count)."""
        self.refresh_workers()
        with self._lock:
            return sum(w.devices for w in self._workers.values()) or 0

    def wait_for_workers(self, min_n_workers: int = 1, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.refresh_workers(force=True)
            with self._lock:
                if len(self._workers) >= min_n_workers:
                    return
            time.sleep(0.1)
        raise TimeoutError(
            f"fewer than {min_n_workers} batched workers after {timeout}s"
        )

    # ------------------------------------------------------------ evaluation
    @staticmethod
    def _split(
        n: int, workers: List[_BatchWorkerProxy]
    ) -> List[Tuple[_BatchWorkerProxy, int, int]]:
        """Contiguous shard bounds over ``range(n)``, proportional to device
        counts — at most ONE shard per worker."""
        total = sum(w.devices for w in workers)
        bounds, acc = [], 0
        for w in workers:
            share = round(n * w.devices / total)
            bounds.append((w, acc, min(acc + share, n)))
            acc = min(acc + share, n)
        # remainder (rounding) goes to the last worker
        if bounds and acc < n:
            w, lo, _ = bounds[-1]
            bounds[-1] = (w, lo, n)
        return [(w, lo, hi) for w, lo, hi in bounds if hi > lo]

    def evaluate(self, vectors: np.ndarray, budget: float) -> np.ndarray:
        with obs.span("wave_evaluate", n=len(vectors), budget=float(budget)):
            return self._evaluate(vectors, budget)

    def _evaluate(self, vectors: np.ndarray, budget: float) -> np.ndarray:
        vectors = np.asarray(vectors, dtype=np.float32)
        n = len(vectors)
        losses = np.full(n, np.nan, dtype=np.float32)
        #: global indices still awaiting a result; retry rounds re-split this
        #: merged set so each worker receives at most one RPC per attempt
        pending = np.arange(n)
        #: workers that failed DURING this wave: excluded from its retries
        #: even if a forced refresh re-discovers them (a straggler would just
        #: block the retry behind its busy lock and time out again)
        failed_names: set = set()

        for attempt in range(self.max_retries + 1):
            self.refresh_workers(force=attempt > 0)
            with self._lock:
                workers = [
                    w for w in self._workers.values() if w.name not in failed_names
                ]
            if not workers:
                # probes are async now — if one is in flight (e.g. a fresh
                # worker replacing the crashed pool), give it a moment to
                # land before declaring the wave dead
                deadline = time.monotonic() + self.probe_backoff_s
                while time.monotonic() < deadline:
                    with self._lock:
                        probing = bool(self._probing)
                        workers = [
                            w
                            for w in self._workers.values()
                            if w.name not in failed_names
                        ]
                    if workers or not probing:
                        break
                    time.sleep(0.05)
            if not workers:
                self.logger.error("no batched workers alive; wave crashes as NaN")
                obs.get_metrics().counter("rpc.batch_nan_filled").inc(len(pending))
                return losses

            shards = [
                (w, pending[lo:hi])
                for w, lo, hi in self._split(len(pending), workers)
            ]
            failed: List[np.ndarray] = []
            failed_lock = threading.Lock()

            def run_shard(w: _BatchWorkerProxy, idx: np.ndarray) -> None:
                # broad catch: a malformed reply (KeyError/TypeError) must
                # enter the retry path exactly like a vanished peer
                try:
                    losses[idx] = w.evaluate(vectors[idx], budget, self.rpc_timeout)
                except Exception as e:
                    self.logger.warning(
                        "shard of %d configs failed on %s: %r", len(idx), w.name, e
                    )
                    obs.emit(
                        obs.WORKER_DROPPED,
                        worker=w.name, reason="shard failed", n_configs=len(idx),
                    )
                    with failed_lock:
                        failed.append(idx)
                        failed_names.add(w.name)
                    with self._lock:
                        self._workers.pop(w.name, None)

            threads = [
                threading.Thread(target=run_shard, args=s, daemon=True)
                for s in shards
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

            if not failed:
                return losses
            pending = np.concatenate(failed)
            obs.emit(
                obs.RPC_RETRY, attempt=attempt + 1,
                max_retries=self.max_retries, pending=len(pending),
            )
            obs.get_metrics().counter("rpc.batch_shard_retries").inc()
            self.logger.info(
                "retrying %d failed config(s), attempt %d/%d",
                len(pending), attempt + 1, self.max_retries,
            )
        # every retry failed: the configs still pending crash as NaN
        obs.get_metrics().counter("rpc.batch_nan_filled").inc(len(pending))
        return losses
