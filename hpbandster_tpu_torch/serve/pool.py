"""ServePool: many tenants' sweeps sharing one device backend.

Ported from ``hpbandster_tpu/serve/pool.py``. Each tenant's optimizer (an
ordinary ``Master`` subclass with ``tenant_id=`` set) drives a
:class:`_TenantExecutor` facade that implements the executor seam (buffer
jobs, ``flush()`` when the master drains), while the device work funnels
into one shared :class:`ServePool`. The facade's half of the seam (the
buffer, the fused cache, result delivery, the stage-0 wave split and the
vector encode) is ``BatchedExecutor``'s, from
``parallel/batched_executor.py``; the pool adds the queueing, the fair
rounds, the pack window, leadership and the cross-tenant dispatch:

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

A tenant is present while it holds a live facade: one minted by
``executor_for`` and neither shut down nor dropped (the pool keeps its
facades weakly, so a facade no one holds lists no tenant and holds no pack
window open). ``release_tenant`` prunes a tenant's queue, weight, deficit
and lanes once no live facade of it remains; calling it again changes
nothing.

Every dispatch and fetch is a span on the event bus (``megabatch_dispatch``,
``fused_dispatch``, ``serve_fetch``, ``continuous_chunk``,
``continuous_fetch``, ``stage_batch``); a flush, its pack-window wait, a
follower's wait, a round, its dispatch and the delivery are profiler-only
ranges (``hpb.pool_flush``, ``hpb.pool_pack_wait``, ``hpb.pool_follow_wait``,
``hpb.pool_round``, ``hpb.pool_dispatch``, ``hpb.pool_deliver``; see
``obs.use_profiler_annotations``); each admitted item a
``serve_admission`` event, and the pool keeps the reference's metrics of
rounds, queue depth, per-tenant queue waits and finished configs, how
each pack window ended (``serve.pack_window.closed_early``: every live
facade was waiting; ``serve.pack_window.full``: the deadline), and in
continuous mode the lane census after each round
(``serve.lanes.{total,occupied,starved}``, ``serve.lane_occupancy``).
Each tenant's master emits its own job and promotion records under its
``tenant_id``.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
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
from hpbandster_tpu_torch.parallel.batched_executor import (
    ExecutorSeam,
    OnBackend,
    job_vectors,
    stage0_waves,
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


class _TenantExecutor(ExecutorSeam):
    """The executor seam one tenant's master drives; routes to the pool."""

    #: one bracket at a time per tenant: each bracket's samples see all of
    #: the tenant's earlier results; the overlap comes from the pool
    preferred_parallel_brackets = 1

    def __init__(self, pool: "ServePool", tenant_id: str):
        super().__init__(pool.backend, pool.configspace)
        self.pool = pool
        self.tenant_id = str(tenant_id)
        #: the items of this facade's flush while it is inside the pool
        self.waiting: Sequence[_WorkItem] = ()

    def prepare_schedule(self, plans) -> None:
        self.pool.prepare(plans)

    def flush(self) -> bool:
        return self.pool.flush_tenant(self)

    def shutdown(self, shutdown_workers: bool = False) -> None:
        # the tenant leaves; the pool and its backend belong to everyone
        self.pool._retire(self)
        self.pool.release_tenant(self.tenant_id)

    def _finish(self, job: Job, loss: float) -> None:
        obs.get_metrics().counter(f"serve.tenant.{self.tenant_id}.configs_done").inc()
        super()._finish(job, loss)


class ServePool(OnBackend):
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
        #: the longest a round leader waits for other tenants' items before
        #: its first round; the window closes as soon as every live executor
        #: facade is waiting on queued items, since no one else can join then
        #: (so a lone tenant never waits). 0: no window
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
        #: facades minted by ``executor_for`` and not yet shut down, the
        #: pool's one registry of its tenants (several sweeps of one tenant
        #: each drive their own facade; fairness stays per tenant). Weak: a
        #: facade no one holds can never flush
        self._live: "weakref.WeakSet[_TenantExecutor]" = weakref.WeakSet()
        #: every bucket, megabatch and lane program this pool built or ran
        self._programs: Dict[int, Any] = {}
        #: dispatch counts, written by the round leader
        self.dispatches = {"packed_dispatches": 0, "packed_brackets": 0,
                           "pad_lanes": 0, "solo_brackets": 0,
                           "continuous_chunks": 0, "continuous_brackets": 0,
                           "stage_batches": 0}

    # ------------------------------------------------------------- tenants
    def executor_for(self, tenant_id: str, weight: Optional[float] = None):
        """A fresh executor facade for one sweep of ``tenant_id``."""
        tenant = str(tenant_id)
        with self._cond:
            self._queues.setdefault(tenant, [])
            self._weights[tenant] = float(
                weight if weight is not None else self.admission.quota(tenant).weight)
            facade = _TenantExecutor(self, tenant)
            self._live.add(facade)
        return facade

    def _retire(self, facade: _TenantExecutor) -> None:
        """A facade shut down can join no round (idempotent)."""
        with self._cond:
            self._live.discard(facade)

    def release_tenant(self, tenant_id: str) -> None:
        """Let a tenant go once none of its sweeps is left.

        A facade from ``executor_for`` is live until its ``shutdown()``
        (which calls this) or until no one holds it. Once no live facade of
        the tenant remains and its queue is empty, its queue, weight,
        scheduler deficit and, in continuous mode, its lanes are pruned for
        the next chunk's newcomers. Idempotent: while another facade of the
        tenant is live, a repeated call changes nothing."""
        tenant = str(tenant_id)
        runners = []
        with self._cond:
            if not self._queues.get(tenant) and not any(f.tenant_id == tenant for f in self._live):
                self._queues.pop(tenant, None)
                self._weights.pop(tenant, None)
                self.scheduler.forget(tenant)
                runners = list(self._continuous_runners.values())
            self._cond.notify_all()
        for r in runners:
            r.release_tenant(tenant)

    def tenants(self) -> List[str]:
        """The tenants holding a live facade, sorted."""
        with self._cond:
            return sorted({f.tenant_id for f in self._live})

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
            mesh, axis = self._mesh()
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

    # --------------------------------------------------------------- flush
    def flush_tenant(self, facade: _TenantExecutor) -> bool:
        """One tenant's flush: serve cached results, queue fresh work, wait
        (leading rounds when no one else does) until it is done, deliver.
        The ``hpb.pool_flush`` profiler range (``obs.annotate``)."""
        if not facade.buffer and not facade._fused_cache:
            return False
        with obs.annotate("pool_flush"):
            jobs, facade.buffer = facade.buffer, []
            remaining = facade._serve_cached(jobs)
            if not remaining:
                return bool(jobs)
            items = self._build_items(facade.tenant_id, remaining)
            self._enqueue_and_wait(facade, items)
            with obs.annotate("pool_deliver"):
                self._deliver(facade, items)
            return True

    def _build_items(self, tenant: str, jobs: List[Job]) -> List[_WorkItem]:
        """Buffered jobs -> cost-stamped work items: complete stage-0
        bracket waves a bucket covers fuse; the rest stage-batch by budget."""
        waves, leftovers = stage0_waves(jobs)
        with self._cond:
            bucket_set = self._bucket_set
        items: List[_WorkItem] = []
        for _iteration, info, wave in waves:
            placed = (bucket_set.place(info["num_configs"], info["budgets"])
                      if bucket_set is not None else None)
            if placed is None:
                leftovers.extend(wave)
                continue
            bucket, plan, entry = placed
            item = _WorkItem("bracket", tenant, wave,
                             cost=work_cost(plan.num_configs, plan.budgets))
            item.info = info
            item.vectors = job_vectors(self.configspace, wave)
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
            item.vectors = job_vectors(self.configspace, group)
            items.append(item)
        return items

    # ------------------------------------------------------ rounds/waiting
    def _enqueue_and_wait(self, facade: _TenantExecutor, items: List[_WorkItem]) -> None:
        if not items:
            return
        tenant = facade.tenant_id
        now = time.monotonic()
        with self._cond:
            facade.waiting = items
            q = self._queues.setdefault(tenant, [])
            for it in items:
                it.enqueue_mono = now
            q.extend(items)
            obs.get_metrics().gauge("serve.queue_items").set(
                sum(len(qq) for qq in self._queues.values()))
            self._cond.notify_all()

        first_wait = True
        try:
            while True:
                with self._cond:
                    if all(it.done for it in items):
                        return
                    if self._leader is not None:
                        with obs.annotate("pool_follow_wait"):
                            self._cond.wait(0.05)
                        continue
                    self._leader = tenant
                try:
                    if first_wait and self.pack_window_s:
                        self._pack_window()
                        first_wait = False
                    with obs.annotate("pool_round"):
                        self._round()
                finally:
                    with self._cond:
                        self._leader = None
                        self._cond.notify_all()
        finally:
            with self._cond:
                facade.waiting = ()

    def _all_live_waiting(self) -> bool:
        """Every live facade has a flush waiting on queued items: no one
        else can join the next round. Called under ``self._cond``."""
        return all(any(not it.done for it in f.waiting) for f in self._live)

    def _pack_window(self) -> None:
        """Before the first round of a leadership, let co-arriving tenants'
        waves land so they pack: wait until every live facade is waiting,
        for at most ``pack_window_s``."""
        with self._cond:
            early = self._all_live_waiting()
            if not early:
                with obs.annotate("pool_pack_wait"):
                    early = self._cond.wait_for(self._all_live_waiting, self.pack_window_s)
        obs.get_metrics().counter(
            "serve.pack_window.closed_early" if early else "serve.pack_window.full").inc()

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
            with obs.annotate("pool_dispatch"):
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
            mesh, axis = self._mesh()
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
            mesh, axis = self._mesh()
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
            else:
                facade._fill_cache(item.jobs, item.info["budgets"], item.result)

    # ---------------------------------------------------------- inspection
    def snapshot(self) -> Dict[str, Any]:
        """Pool introspection: tenants, queued items, rounds, buckets,
        served cost, dispatch counts, and in continuous mode the lanes."""
        with self._cond:
            out = {
                "tenants": self.tenants(),
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
