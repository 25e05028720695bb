"""ServePool: many tenants' sweeps sharing one device backend.

Ported from ``hpbandster_tpu/serve/pool.py``. Each tenant's optimizer (an
ordinary ``Master`` subclass with ``tenant_id=`` set) drives a
:class:`_TenantExecutor` facade that implements the executor seam (buffer
jobs, ``flush()`` when the master drains), while the device work funnels
into one shared :class:`ServePool`:

1. a flush turns the tenant's buffered jobs into work items: complete
   stage-0 bracket waves that a bucket covers, or budget-grouped stage
   batches, each stamped with its configs x budget cost;
2. items queue per tenant, and the
   :class:`~hpbandster_tpu_torch.serve.scheduler.DeficitFairScheduler`
   decides each round which items dispatch now;
3. selected bracket items of one bucket pack into one megabatch dispatch
   (``serve/megabatch.py``), a lone bracket rides the solo bucket program,
   and stage batches group by budget across tenants; with
   ``continuous=True`` bracket items ride each bucket family's resident
   lane program instead (``serve/continuous.py``);
4. results demux back to each tenant's facade, which delivers them on the
   tenant's own flush thread, under its master's re-entrant lock.

Leadership: flushing tenant threads wait on the pool's condition until
their items are done; whenever no round runs, one waiting thread becomes
the leader, runs one scheduler round (device work outside the lock), marks
the results and wakes the others.

Where the reference crashes a bracket item's jobs when its dispatch or
fetch fails, the port does so on the CPU only: on a card the tenant whose
bracket failed raises from its flush, and a failed schedule preparation
raises, so serving never quietly loses its device programs (a failed
stage batch crashes its wave on both, as in ``BatchedExecutor``). A
background build that fails keeps its error, and the next dispatch of that
program raises it. The reference's persistent compile cache is the port's
kernel cache (``utils/compile_cache.py``), called when the pool is made.

Every dispatch and fetch is a span on the event bus (``megabatch_dispatch``,
``fused_dispatch``, ``serve_fetch``, ``continuous_chunk``,
``continuous_fetch``, ``stage_batch``), each admitted item a
``serve_admission`` event, and the pool keeps the reference's metrics of
rounds, queue depth, per-tenant queue waits and finished configs, and in
continuous mode the lane census after each round
(``serve.lanes.{total,occupied,starved}``, ``serve.lane_occupancy``).
Each tenant's master emits its own job and promotion records under its
``tenant_id``.
"""

from __future__ import annotations

import logging
import threading
import time
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
    start_precompile,
)
from hpbandster_tpu_torch.parallel.mesh import shard_count
from hpbandster_tpu_torch.serve.continuous import ContinuousRunner
from hpbandster_tpu_torch.serve.megabatch import PackEntry, make_mega_runner
from hpbandster_tpu_torch.serve.scheduler import (
    AdmissionController,
    DeficitFairScheduler,
    work_cost,
)
from hpbandster_tpu_torch.space import ConfigurationSpace

__all__ = ["ServePool"]


class _WorkItem:
    """One schedulable unit: a fusable bracket wave or a stage batch."""

    __slots__ = (
        "kind", "tenant", "jobs", "cost", "info", "vectors", "bucket",
        "plan", "entry", "budget", "done", "error", "result", "enqueue_mono",
    )

    def __init__(self, kind: str, tenant: str, jobs: List[Job], cost: float):
        self.kind = kind  # "bracket" | "stage"
        self.tenant = tenant
        self.jobs = jobs
        self.cost = float(cost)
        self.info: Optional[Dict[str, Any]] = None
        self.vectors: Optional[np.ndarray] = None
        #: the BucketPlan value this bracket was placed in, kept so that a
        #: bucket-set rebuild by another tenant never re-points the item
        self.bucket = None
        self.plan = None
        self.entry = 0
        self.budget: Optional[float] = None
        self.done = False
        self.error: Optional[str] = None
        #: bracket: true-shape [(idx, losses), ...]; stage: f32[n] losses
        self.result: Any = None
        self.enqueue_mono = 0.0


class _TenantExecutor:
    """The executor seam one tenant's master drives; routes to the pool."""

    unbounded_queue = True
    prefers_batched_sampling = True
    #: one bracket at a time per tenant: each bracket's samples see all of
    #: the tenant's earlier results; the overlap comes from the pool
    preferred_parallel_brackets = 1

    def __init__(self, pool: "ServePool", tenant_id: str):
        self.pool = pool
        self.tenant_id = str(tenant_id)
        self.device = pool.device
        self.buffer: List[Job] = []
        self._new_result_callback: Optional[Callable[..., None]] = None
        self.total_evaluated = 0
        #: (config_id, budget) -> loss a fused bracket computed ahead
        self._fused_cache: Dict[Tuple[Any, float], float] = {}

    def start(self, new_result_callback, new_worker_callback) -> None:
        self._new_result_callback = new_result_callback
        new_worker_callback(self.number_of_workers())

    def number_of_workers(self) -> int:
        return max(int(getattr(self.pool.backend, "parallelism", 1)), 1)

    def submit_job(self, job: Job) -> None:
        self.buffer.append(job)

    def n_waiting(self) -> int:
        return len(self.buffer)

    def prepare_schedule(self, plans) -> None:
        self.pool.prepare(plans)

    def flush(self) -> bool:
        return self.pool.flush_tenant(self)

    def shutdown(self, shutdown_workers: bool = False) -> None:
        # the tenant leaves; the pool and its backend belong to everyone
        self.pool.release_tenant(self.tenant_id)

    def _finish(self, job: Job, loss: float) -> None:
        job.time_it("finished")
        if np.isfinite(loss):
            job.result = {"loss": float(loss), "info": {}}
        else:
            job.result = None
            job.exception = job.exception or (
                f"non-finite loss {loss!r} at budget {job.kwargs['budget']}")
        self.total_evaluated += 1
        obs.get_metrics().counter(f"serve.tenant.{self.tenant_id}.configs_done").inc()
        # burst delivery, deferred refit: BatchedExecutor._finish's contract
        self._new_result_callback(job, update_model=False)

    def _crash_wave(self, jobs: List[Job], why: str) -> None:
        for j in jobs:
            j.exception = why
            self._finish(j, float("nan"))


class ServePool:
    """The shared serving backend: fair scheduling and megabatched (or
    continuous-batched) dispatch.

    ``backend`` is a batched evaluation backend (``VmapBackend``-shaped:
    ``eval_fn``, ``evaluate(vectors, budget)``, ``device``,
    ``parallelism``, and ``mesh``/``axis`` for a meshed backend: the
    bucket set pads to the mesh's axis, and the solo and packed programs
    split over it); ``configspace`` is the pool's one search space:
    packing across tenants needs one objective and one vector width.
    ``lane_mesh=`` (``serve.continuous.make_lane_mesh``) places the
    continuous mode's lane programs on a 2-D lane x config mesh.
    """

    def __init__(
        self,
        backend,
        configspace: ConfigurationSpace,
        scheduler: Optional[DeficitFairScheduler] = None,
        admission: Optional[AdmissionController] = None,
        pack_width: int = 8,
        pack_min: int = 2,
        pack_window_s: float = 0.01,
        round_capacity: Optional[float] = None,
        continuous: bool = False,
        lane_count: int = 8,
        lane_mesh=None,
        logger: Optional[logging.Logger] = None,
    ):
        from hpbandster_tpu_torch.utils.compile_cache import (
            enable_persistent_compile_cache,
        )

        enable_persistent_compile_cache()
        self.backend = backend
        self.configspace = configspace
        self.device = getattr(backend, "device", None)
        self.scheduler = scheduler or DeficitFairScheduler()
        self.admission = admission or AdmissionController()
        #: static lanes per packed program
        self.pack_width = max(int(pack_width), 1)
        #: packing engages at this group size; below it the solo program runs
        self.pack_min = max(int(pack_min), 2)
        self.pack_window_s = max(float(pack_window_s), 0.0)
        #: max cost one round may dispatch (None = everything selectable)
        self.round_capacity = round_capacity
        #: bracket items ride one resident lane program per bucket family
        self.continuous = bool(continuous)
        self.lane_count = max(int(lane_count), 1)
        #: optional 2-D lane x config mesh of the lane programs (None:
        #: unsharded lanes)
        self.lane_mesh = lane_mesh
        self._continuous_runners: Dict[Any, ContinuousRunner] = {}
        self.logger = logger or logging.getLogger("hpbandster_tpu_torch.serve")

        self._cond = threading.Condition()
        self._queues: Dict[str, List[_WorkItem]] = {}
        self._weights: Dict[str, float] = {}
        self._leader: Optional[str] = None
        self._rounds = 0
        self._bucket_plans: List[BracketPlan] = []
        self._bucket_shapes: set = set()
        self._bucket_set = None
        #: the latest background build's handle (ops.buckets._Precompile)
        self.precompile = None
        #: active facade count per tenant (several sweeps of one tenant each
        #: drive their own facade; fairness stays per tenant)
        self._tenants: Dict[str, int] = {}
        #: every bucket, megabatch and lane program this pool built or ran
        self._programs: Dict[int, Any] = {}
        #: dispatch counts, written by the round leader
        self.dispatches = {"packed_dispatches": 0, "packed_brackets": 0,
                           "pad_lanes": 0, "solo_brackets": 0,
                           "continuous_chunks": 0, "continuous_brackets": 0,
                           "stage_batches": 0}

    def _strict(self) -> bool:
        """On a card device-program failures raise."""
        return self.device is not None and self.device.type == "cuda"

    # ------------------------------------------------------------- tenants
    def executor_for(self, tenant_id: str, weight: Optional[float] = None):
        """A fresh executor facade for one sweep of ``tenant_id``."""
        tenant = str(tenant_id)
        with self._cond:
            self._tenants[tenant] = self._tenants.get(tenant, 0) + 1
            self._queues.setdefault(tenant, [])
            self._weights[tenant] = float(
                weight if weight is not None else self.admission.quota(tenant).weight)
        return _TenantExecutor(self, tenant)

    def release_tenant(self, tenant_id: str) -> None:
        tenant = str(tenant_id)
        runners = []
        with self._cond:
            n = self._tenants.get(tenant, 0) - 1
            if n > 0:
                self._tenants[tenant] = n
            else:
                self._tenants.pop(tenant, None)
                if not self._queues.get(tenant):
                    # fully gone: prune its bookkeeping, and in continuous
                    # mode free its lanes for the next chunk's newcomers
                    self._queues.pop(tenant, None)
                    self._weights.pop(tenant, None)
                    self.scheduler.forget(tenant)
                    runners = list(self._continuous_runners.values())
            self._cond.notify_all()
        for r in runners:
            r.release_tenant(tenant)

    def tenants(self) -> List[str]:
        with self._cond:
            return sorted(self._tenants)

    # ------------------------------------------------------------ schedule
    def prepare(self, plans) -> None:
        """A tenant master announced its remaining schedule: widen the
        shared bucket set over every tenant's plans and build its programs
        in the background (the solo bucket programs, or in continuous mode
        the resident lane programs)."""
        fusable = [p for p in plans if len(p.num_configs) >= 2]
        if not fusable:
            return
        with self._cond:
            fresh = []
            for p in fusable:
                sig = (tuple(p.num_configs), tuple(p.budgets))
                if sig not in self._bucket_shapes:
                    self._bucket_shapes.add(sig)
                    fresh.append(p)
            if not fresh:
                return
            self._bucket_plans.extend(fresh)
            mesh, axis = self._backend_mesh()
            mesh_size = shard_count(mesh, axis)
            if self.continuous and self.lane_mesh is not None:
                # the lane programs split each lane's rows over the lane
                # mesh's config axis: the widths must be multiples of it
                mesh_size = max(mesh_size, shard_count(self.lane_mesh, "config"))
            self._bucket_set = build_bucket_set(self._bucket_plans, mesh_size=mesh_size)
            bucket_set = self._bucket_set
        try:
            d = self.configspace.dim
            if self.continuous:
                self.precompile = start_precompile(
                    [self._continuous_runner(b) for b in bucket_set.buckets], d,
                    True, "continuous-precompile")
            else:
                self.precompile = precompile_buckets(
                    self.backend.eval_fn, bucket_set, d=d, mesh=mesh, axis=axis,
                    device=self.device)
            for r in self.precompile._runners:
                self._note_program(r)
        except Exception:
            if self._strict():
                raise
            self.logger.exception("bucket precompile failed; continuing")

    def _backend_mesh(self):
        """The backend's mesh and axis (``(None, "config")`` unmeshed)."""
        return getattr(self.backend, "mesh", None), getattr(self.backend, "axis", "config")

    def _note_program(self, runner) -> None:
        with self._cond:
            self._programs[id(runner)] = runner

    def programs(self) -> List[Any]:
        """The runners (``ops.buckets._BucketRunner``,
        ``serve.megabatch.MegaRunner``, ``serve.continuous.ContinuousRunner``)
        this pool built or dispatched to; each one's ``program.graph`` holds
        its capture and replay times on a card."""
        with self._cond:
            return list(self._programs.values())

    def _continuous_runner(self, bucket) -> ContinuousRunner:
        """The pool's resident lane program for one bucket family, made
        once per family."""
        with self._cond:
            runner = self._continuous_runners.get(bucket)
            if runner is None:
                runner = ContinuousRunner(
                    self.backend.eval_fn, bucket, lane_count=self.lane_count,
                    mesh=self.lane_mesh, family=len(self._continuous_runners),
                    device=self.device if self.lane_mesh is None else None)
                self._continuous_runners[bucket] = runner
            return runner

    def _placement(self, info) -> Optional[Tuple[Any, BracketPlan, int]]:
        """``(bucket, member plan, entry)`` for a bracket shape, or None."""
        with self._cond:
            bucket_set = self._bucket_set
        if bucket_set is None:
            return None
        placed = bucket_set.lookup(info["num_configs"], info["budgets"])
        if placed is None:
            return None
        bucket_idx, entry = placed
        plan = BracketPlan(num_configs=tuple(info["num_configs"]),
                           budgets=tuple(info["budgets"]))
        return bucket_set.buckets[bucket_idx], plan, entry

    # --------------------------------------------------------------- flush
    def flush_tenant(self, facade: _TenantExecutor) -> bool:
        """One tenant's flush: serve cached results, queue fresh work, wait
        (leading rounds when no one else does) until it is done, deliver."""
        if not facade.buffer and not facade._fused_cache:
            return False
        jobs, facade.buffer = facade.buffer, []
        served = False
        remaining: List[Job] = []
        for job in jobs:
            key = (job.id, float(job.kwargs["budget"]))
            if key in facade._fused_cache:
                job.time_it("started")
                facade._finish(job, facade._fused_cache.pop(key))
                served = True
            else:
                remaining.append(job)
        if not remaining:
            return served
        items = self._build_items(facade.tenant_id, remaining)
        self._enqueue_and_wait(facade.tenant_id, items)
        self._deliver(facade, items)
        return True

    def _build_items(self, tenant: str, jobs: List[Job]) -> List[_WorkItem]:
        """Buffered jobs -> cost-stamped work items: complete stage-0
        bracket waves a bucket covers fuse; the rest stage-batch by budget."""
        groups: Dict[int, List[Job]] = {}
        leftovers: List[Job] = []
        for j in jobs:
            info = getattr(j, "bracket_info", None)
            if info is None or info["stage"] != 0 or len(info["num_configs"]) < 2:
                leftovers.append(j)
            else:
                groups.setdefault(j.id[0], []).append(j)

        items: List[_WorkItem] = []
        for _iteration, gjobs in sorted(groups.items()):
            info = gjobs[0].bracket_info
            complete = (
                all(getattr(j, "bracket_info", None) == info for j in gjobs)
                and len(gjobs) == info["num_configs"][0]
            )
            placed = self._placement(info) if complete else None
            if placed is None:
                leftovers.extend(gjobs)
                continue
            bucket, plan, entry = placed
            jobs_sorted = sorted(gjobs, key=lambda j: j.id)
            item = _WorkItem("bracket", tenant, jobs_sorted,
                             cost=work_cost(plan.num_configs, plan.budgets))
            item.info = info
            item.vectors = self._vectors(jobs_sorted)
            item.bucket = bucket
            item.plan = plan
            item.entry = entry
            items.append(item)

        by_budget: Dict[float, List[Job]] = {}
        for j in leftovers:
            by_budget.setdefault(float(j.kwargs["budget"]), []).append(j)
        for budget, group in sorted(by_budget.items()):
            item = _WorkItem("stage", tenant, group, cost=len(group) * float(budget))
            item.budget = budget
            item.vectors = self._vectors(group)
            items.append(item)
        return items

    def _vectors(self, jobs: Sequence[Job]) -> np.ndarray:
        return np.stack([
            np.nan_to_num(self.configspace.to_vector(j.kwargs["config"]), nan=0.0)
            for j in jobs
        ]).astype(np.float32)

    # ------------------------------------------------------ rounds/waiting
    def _enqueue_and_wait(self, tenant: str, items: List[_WorkItem]) -> None:
        if not items:
            return
        now = time.monotonic()
        with self._cond:
            q = self._queues.setdefault(tenant, [])
            for it in items:
                it.enqueue_mono = now
            q.extend(items)
            obs.get_metrics().gauge("serve.queue_items").set(
                sum(len(qq) for qq in self._queues.values()))
            self._cond.notify_all()

        first_wait = True
        while True:
            with self._cond:
                if all(it.done for it in items):
                    return
                if self._leader is not None:
                    self._cond.wait(0.05)
                    continue
                self._leader = tenant
            try:
                if first_wait and self.pack_window_s:
                    # let co-arriving tenants' waves land before the first
                    # round of this leadership, so they pack
                    time.sleep(self.pack_window_s)
                    first_wait = False
                self._round()
            finally:
                with self._cond:
                    self._leader = None
                    self._cond.notify_all()

    def _round(self) -> None:
        """One scheduling round: fair-select queued items, dispatch them
        (megabatched where a bucket is shared), mark the results."""
        with self._cond:
            queues = {t: list(q) for t, q in self._queues.items() if q}
            if not queues:
                return
            selected = self.scheduler.select(
                queues, capacity=self.round_capacity, weights=self._weights)
            for tenant, item in selected:
                self._queues[tenant].remove(item)
            self._rounds += 1
            m = obs.get_metrics()
            m.counter("serve.rounds").inc()
            m.gauge("serve.queue_items").set(
                sum(len(qq) for qq in self._queues.values()))
        wait_now = time.monotonic()
        bus_active = obs.get_bus().active
        for tenant, item in selected:
            wait_s = max(wait_now - item.enqueue_mono, 0.0)
            m.histogram("serve.queue_wait_s").observe(wait_s)
            m.histogram(f"serve.tenant.{tenant}.queue_wait_s").observe(wait_s)
            if bus_active:
                obs.emit("serve_admission", wait_s=round(wait_s, 6), tenant=tenant)
        try:
            self._run_items([item for _, item in selected])
        finally:
            with self._cond:
                for _, item in selected:
                    item.done = True
                    if item.error is None and item.result is None:
                        item.error = "round aborted before results landed"
                self._cond.notify_all()

    # ------------------------------------------------------------ dispatch
    def _run_items(self, items: List[_WorkItem]) -> None:
        """Evaluate one round's selection. Bracket items group by bucket:
        groups of at least ``pack_min`` become packed dispatches (chunked at
        ``pack_width``), smaller ones ride the solo bucket program; stage
        items batch by budget across tenants. Every dispatch launches
        before the first fetch. A failure stays with its items."""
        brackets = [it for it in items if it.kind == "bracket"]
        stages = [it for it in items if it.kind == "stage"]

        if self.continuous and brackets:
            self._run_brackets_continuous(brackets)
        elif brackets:
            by_bucket: Dict[Any, List[_WorkItem]] = {}
            for it in brackets:
                by_bucket.setdefault(it.bucket, []).append(it)
            d = self.configspace.dim
            pending: List[Tuple[Callable[[], None], List[_WorkItem]]] = []
            for bucket, group in sorted(by_bucket.items(), key=lambda kv: kv[0]):
                if len(group) >= self.pack_min:
                    chunks = [group[i:i + self.pack_width]
                              for i in range(0, len(group), self.pack_width)]
                else:
                    chunks = [[it] for it in group]
                for chunk in chunks:
                    if len(chunk) >= self.pack_min:
                        pending.append(self._dispatch_packed(chunk, bucket, d))
                    else:
                        pending.append(self._dispatch_solo(chunk[0], bucket))
            for fetch, chunk_items in pending:
                try:
                    with obs.span("serve_fetch", n_brackets=len(chunk_items)):
                        fetch()
                except Exception as e:
                    self.logger.exception("serve fetch failed")
                    for it in chunk_items:
                        it.error = f"serve fetch failed: {e!r}"

        for budget_group in self._stage_groups(stages):
            self._run_stage_group(budget_group)

    def _run_brackets_continuous(self, brackets: List[_WorkItem]) -> None:
        """One round's bracket items through the resident lane programs:
        per bucket family, items board chunks of ``lane_count`` in deficit
        order (the most owed tenants first; the rest ride the next chunk of
        the same round), and every chunk launches before the first fetch,
        chaining through the device-resident carry."""
        by_bucket: Dict[Any, List[_WorkItem]] = {}
        for it in brackets:
            by_bucket.setdefault(it.bucket, []).append(it)
        rank = self.scheduler.deficit_order([it.tenant for it in brackets])
        d = self.configspace.dim
        pending: List[Tuple[Callable[[], Any], List[_WorkItem]]] = []
        for bucket, group in sorted(by_bucket.items(), key=lambda kv: kv[0]):
            runner = self._continuous_runner(bucket)
            group = sorted(group, key=lambda it: (rank.get(it.tenant, len(rank)),
                                                  it.enqueue_mono))
            for i in range(0, len(group), runner.lane_count):
                chunk = group[i:i + runner.lane_count]
                entries = [PackEntry(it.tenant, it.vectors, it.plan, it.entry)
                           for it in chunk]
                try:
                    with obs.span("continuous_chunk", n_brackets=len(chunk),
                                  family=runner.family,
                                  tenants=len({it.tenant for it in chunk})):
                        fetch = runner.dispatch_chunk(
                            entries, d, waiting=len(group) - (i + len(chunk)))
                except Exception as e:
                    self.logger.exception("continuous chunk failed")
                    for it in chunk:
                        it.error = f"continuous chunk failed: {e!r}"
                    continue
                self.dispatches["continuous_chunks"] += 1
                self.dispatches["continuous_brackets"] += len(chunk)
                pending.append((fetch, chunk))
        for fetch, chunk in pending:
            try:
                with obs.span("continuous_fetch", n_brackets=len(chunk)):
                    results = fetch()
            except Exception as e:
                self.logger.exception("continuous fetch failed")
                for it in chunk:
                    it.error = f"continuous fetch failed: {e!r}"
                continue
            for it, member_stages in zip(chunk, results):
                it.result = member_stages
        # the pool's lane census after the round: occupancy counts owned
        # lanes (warm carries parked on the card), not only those that ran
        total = occupied = starved = 0
        with self._cond:
            runners = list(self._continuous_runners.values())
        for r in runners:
            snap = r.snapshot()
            total += snap["lane_count"]
            occupied += snap["occupied"]
            starved += snap["starved"]
        if total:
            m = obs.get_metrics()
            m.gauge("serve.lanes.total").set(total)
            m.gauge("serve.lanes.occupied").set(occupied)
            m.gauge("serve.lane_occupancy").set(round(occupied / total, 4))
            m.gauge("serve.lanes.starved").set(starved)

    def _dispatch_packed(self, chunk: List[_WorkItem], bucket, d: int):
        """Launch one packed cross-tenant dispatch; returns its fetcher."""
        entries = [PackEntry(it.tenant, it.vectors, it.plan, it.entry) for it in chunk]
        try:
            mesh, axis = self._backend_mesh()
            runner = make_mega_runner(self.backend.eval_fn, bucket, pack_width=self.pack_width,
                                      mesh=mesh, axis=axis, device=self.device)
            self._note_program(runner)
            with obs.span("megabatch_dispatch", n_brackets=len(chunk),
                          tenants=len({it.tenant for it in chunk})):
                packed = runner.dispatch(entries, d)
        except Exception as e:
            self.logger.exception("megabatch dispatch failed")
            for it in chunk:
                it.error = f"megabatch dispatch failed: {e!r}"
            return (lambda: None), chunk
        self.dispatches["packed_dispatches"] += 1
        self.dispatches["packed_brackets"] += len(chunk)
        self.dispatches["pad_lanes"] += self.pack_width - len(chunk)

        def fetch():
            for it, stages in zip(chunk, runner.demux(packed, entries)):
                it.result = stages

        return fetch, chunk

    def _dispatch_solo(self, item: _WorkItem, bucket):
        """A lone bracket rides the solo bucket program (the same cached
        runner every solo path in the process shares)."""
        counts = member_counts_for(bucket, item.plan, item.entry)
        try:
            mesh, axis = self._backend_mesh()
            runner = make_bucketed_bracket_fn(self.backend.eval_fn, bucket, mesh=mesh,
                                              axis=axis, device=self.device)
            self._note_program(runner)
            with obs.span("fused_dispatch", n=len(item.jobs), bucketed=True):
                packed = runner.dispatch(item.vectors, counts)
        except Exception as e:
            self.logger.exception("solo bucket dispatch failed")
            item.error = f"solo bucket dispatch failed: {e!r}"
            return (lambda: None), [item]
        self.dispatches["solo_brackets"] += 1

        def fetch():
            item.result = slice_member_stages(runner.unpack(packed), item.plan, item.entry)

        return fetch, [item]

    @staticmethod
    def _stage_groups(stages: List[_WorkItem]) -> List[List[_WorkItem]]:
        by_budget: Dict[float, List[_WorkItem]] = {}
        for it in stages:
            by_budget.setdefault(float(it.budget), []).append(it)
        return [by_budget[b] for b in sorted(by_budget)]

    def _run_stage_group(self, group: List[_WorkItem]) -> None:
        """One budget's stage batch across tenants: one backend call on
        every item's vectors, losses split back."""
        budget = float(group[0].budget)
        vectors = np.concatenate([it.vectors for it in group])
        try:
            with obs.span("stage_batch", n=len(vectors), budget=budget,
                          tenants=len({it.tenant for it in group})):
                losses = np.asarray(self.backend.evaluate(vectors, budget))
        except Exception as e:
            self.logger.exception("serve stage batch failed at budget %g", budget)
            for it in group:
                it.error = f"stage batch failed: {e!r}"
            return
        self.dispatches["stage_batches"] += 1
        off = 0
        for it in group:
            n = len(it.jobs)
            it.result = losses[off:off + n]
            off += n

    # ------------------------------------------------------------ delivery
    def _deliver(self, facade: _TenantExecutor, items: List[_WorkItem]) -> None:
        """Hand one tenant's finished items to its master, on the tenant's
        own flush thread. On a card a failed bracket item raises here."""
        for item in items:
            for j in item.jobs:
                j.time_it("started")
            if item.error is not None or item.result is None:
                why = item.error or "no result from pool round"
                if item.kind == "bracket" and self._strict():
                    raise RuntimeError(f"tenant {item.tenant!r}: {why}")
                facade._crash_wave(item.jobs, why)
                continue
            if item.kind == "stage":
                for j, loss in zip(item.jobs, np.asarray(item.result)):
                    facade._finish(j, float(loss))
                continue
            stages = item.result
            for s, (idx, losses) in enumerate(stages[1:], start=1):
                budget = float(item.info["budgets"][s])
                for i, loss in zip(np.asarray(idx), np.asarray(losses)):
                    facade._fused_cache[(item.jobs[int(i)].id, budget)] = float(loss)
            for j, loss in zip(item.jobs, np.asarray(stages[0][1])):
                facade._finish(j, float(loss))

    # ---------------------------------------------------------- inspection
    def snapshot(self) -> Dict[str, Any]:
        """Pool introspection: tenants, queued items, rounds, buckets,
        served cost, dispatch counts, and in continuous mode the lanes."""
        with self._cond:
            out = {
                "tenants": sorted(self._tenants),
                "queued_items": {t: len(q) for t, q in self._queues.items() if q},
                "rounds": self._rounds,
                "buckets": (len(self._bucket_set.buckets)
                            if self._bucket_set is not None else 0),
                "served_cost": {t: round(c, 3) for t, c in
                                sorted(self.scheduler.served_cost.items())},
                "dispatches": dict(self.dispatches),
            }
            runners = list(self._continuous_runners.values())
        if self.continuous:
            out["lanes"] = [r.snapshot() for r in runners]
        return out
