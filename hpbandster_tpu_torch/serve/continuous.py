"""Continuous batching: resident lane programs that tenants join and leave.

Ported from ``hpbandster_tpu/serve/continuous.py``. Where a megabatch is
a one-shot packed dispatch, a continuous runner keeps one program per
bucket family over a fixed lane count and runs it chunk after chunk:

* each chunk evaluates one bucketed bracket per occupied lane
  (``ops.buckets.fused_sh_bracket_bucketed_packed_carry``; a lane's
  results equal a solo dispatch of its bracket), zero-count-masks the
  empty lanes, and folds each lane's incumbent into a device-resident
  carry (``ops.sweep.init_lane_state``);
* on a card the chunk is one captured CUDA graph per family: the lane
  count and the bucket are static, so tenant churn never captures again.
  The carry and the reset mask are device buffers inside the graph, and
  the carry is updated in place (``copy_``): a rebinding would leave the
  replays reading the captured address. On the CPU the same body runs
  eagerly over the same buffers;
* tenants join and leave at chunk boundaries: the pool's deficit-fair
  scheduler picks which work items board, and :class:`LaneAllocator` maps
  them to lanes, sticky per tenant (a returning tenant lands on its warm
  lane and keeps its incumbent; a stolen or released lane resets inside
  the program through the reset mask, so no tenant ever reads another's
  carry).

Each ownership change journals a ``lane_assigned`` event and each
released lane a ``lane_released`` one (warm re-boardings are silent), each
fetched chunk a span-shaped ``serve_chunk`` record, and the
``serve.continuous.{joins,leaves,chunks,masked_lanes}`` counters and
``serve.family.<f>.{chunks,warm_age_s,lanes_occupied,lanes_starved}``
gauges follow the lanes, as in the reference. With the device metrics plane
on (``device_metrics=``, default ``HPB_DEVICE_METRICS``) the chunk also
returns each lane's loss histograms and crash counts, and the fetch
publishes one decoded ``device_telemetry`` record per occupied lane.

Over a 2-D ``lane x config`` mesh (:func:`make_lane_mesh`, ``mesh=``) whole
lanes split over the ``lane`` axis and each lane's rows over the
``config`` axis: lane shard ``s`` runs its block of lanes (vectors, counts,
carry and reset mask) on its device, each stage's rows split over its row
of the config axis, and the blocks gather back on the mesh's home device,
where the carry stays in one tensor (ROADMAP C.25). A mesh that repeats
one card captures the family's one graph as before; a mesh over several
cards runs the chunk eagerly. A lane mesh lies in one process.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hpbandster_tpu_torch.obs import events as E
from hpbandster_tpu_torch.obs.metrics import get_metrics
from hpbandster_tpu_torch.ops.buckets import (
    BucketPlan,
    StaticProgram,
    _packed_row,
    fetch_packed,
    fetch_telemetry,
    fused_sh_bracket_bucketed_packed_carry,
    member_counts_for,
)
from hpbandster_tpu_torch.ops.sweep import decode_lane_state, init_lane_state
from hpbandster_tpu_torch.serve.megabatch import PackEntry, demux, publish_lane_telemetry

__all__ = ["ContinuousRunner", "LaneAllocator", "make_lane_mesh"]


def make_lane_mesh(lane_shards: int, devices=None):
    """The 2-D ``lane x config`` mesh of a continuous-batching program:
    ``lane_shards`` rows of whole lanes, the rest of the devices splitting
    each lane's rows. Over ``devices`` (which may repeat one), or every
    visible card without them (raises where there is none);
    ``lane_shards`` must divide the device count."""
    from hpbandster_tpu_torch.parallel.mesh import Mesh, _object_array, _visible_cuda

    devices = list(devices) if devices is not None else _visible_cuda()
    n, lane_shards = len(devices), int(lane_shards)
    if lane_shards < 1 or n % lane_shards:
        raise ValueError(f"lane_shards={lane_shards} must divide the {n} devices")
    return Mesh(_object_array(devices, (lane_shards, n // lane_shards)), ("lane", "config"))


def _lane_shards(mesh, lane_axis: str, config_axis: str):
    """The lane axis's split of a lane mesh (a ``parallel.mesh.RowSplit``
    over the lane shards' first devices, which run their lanes) and, per
    lane shard, its row of the config axis as a 1-D mesh (None when the
    config axis has one shard), which splits each stage's rows."""
    from hpbandster_tpu_torch.parallel.mesh import (
        Mesh,
        RowSplit,
        _by_shard,
        _object_array,
        shard_count,
    )

    if mesh.process_group is not None:
        raise ValueError("a lane mesh lies in one process; got a mesh over a process group")
    extra = set(mesh.axis_names) - {lane_axis, config_axis}
    if extra:
        raise ValueError(f"a lane mesh has the axes {lane_axis!r} and {config_axis!r} only, "
                         f"got {mesh.axis_names}")
    flat = list(mesh.devices.flat)
    rows = [[flat[p] for p in row] for row in (
        _by_shard(mesh, lane_axis) if lane_axis in mesh.axis_names
        else np.arange(mesh.size)[None])]
    split = RowSplit(n_shards=len(rows), devices=tuple(r[0] for r in rows), owners=None,
                     group=None)
    subs = [Mesh(_object_array(r, (len(r),)), (config_axis,))
            if shard_count(mesh, config_axis) > 1 else None for r in rows]
    return split, subs


class LaneAllocator:
    """Sticky per-tenant lane bookkeeping for one resident program.

    Pure host logic, called under the runner's lock. Per chunk a boarding
    entry prefers a lane its tenant already owns (warm: its incumbent
    carry survives), then an unowned lane, then steals the least recently
    used lane of an absent tenant (the steal marks the lane dirty: its
    carry resets inside the program before the chunk folds). Ownership
    persists across chunks until stolen or released.
    """

    def __init__(self, lane_count: int):
        if int(lane_count) < 1:
            raise ValueError("lane_count must be >= 1")
        self.lane_count = int(lane_count)
        self.owners: List[Optional[str]] = [None] * self.lane_count
        #: lanes whose carry must reset before the next fold
        self.dirty: set = set(range(self.lane_count))
        #: lane -> last chunk index it was used in (the steal's LRU key)
        self._last_used: Dict[int, int] = {}
        self._chunks = 0

    def assign(self, tenants: Sequence[str]) -> List[Tuple[int, bool]]:
        """Map one chunk's boarding entries to lanes: ``[(lane, warm),
        ...]`` per entry. Warm placements first (a steal never evicts a
        lane its owner boards this chunk), then unowned lanes, then the
        LRU lane of an absent tenant; only when every untaken lane belongs
        to a boarding tenant does the steal fall back to the plain LRU.
        Raises when more entries than lanes."""
        if len(tenants) > self.lane_count:
            raise ValueError(f"{len(tenants)} entries do not fit {self.lane_count} lanes")
        self._chunks += 1
        boarding = set(tenants)
        taken: set = set()
        placements: List[Optional[Tuple[int, bool]]] = [None] * len(tenants)
        owned: Dict[str, List[int]] = {}
        for lane, owner in enumerate(self.owners):
            if owner is not None:
                owned.setdefault(owner, []).append(lane)
        for i, tenant in enumerate(tenants):
            mine = [x for x in owned.get(tenant, []) if x not in taken]
            if mine:
                taken.add(mine[0])
                placements[i] = (mine[0], True)
        unowned = [lane for lane, o in enumerate(self.owners) if o is None]
        for i, tenant in enumerate(tenants):
            if placements[i] is not None:
                continue
            free = [x for x in unowned if x not in taken]
            if free:
                lane = free[0]
            else:
                victims = [
                    x for x in range(self.lane_count)
                    if x not in taken and self.owners[x] not in boarding
                ] or [x for x in range(self.lane_count) if x not in taken]
                lane = min(victims, key=lambda x: self._last_used.get(x, -1))
                self.dirty.add(lane)
            taken.add(lane)
            self.owners[lane] = tenant
            placements[i] = (lane, False)
        for lane in taken:
            self._last_used[lane] = self._chunks
        return placements

    def release_tenant(self, tenant: str) -> List[int]:
        """Free every lane ``tenant`` owns; returns them (their carries are
        dirty: reset before any later fold)."""
        freed = []
        for lane, owner in enumerate(self.owners):
            if owner == tenant:
                self.owners[lane] = None
                self.dirty.add(lane)
                freed.append(lane)
        return freed

    def occupied(self) -> int:
        return sum(1 for o in self.owners if o is not None)


class ContinuousRunner:
    """One bucket family's resident lane-packed program with its
    device-resident per-lane incumbent carry and its lane allocator.
    :meth:`run_chunk` is one iteration: occupied lanes evaluate their
    brackets, empty lanes are masked (their carries pass through), and the
    carry stays on the device for the next chunk. On a lane mesh
    (``mesh=``) ``lane_count`` must be a multiple of the ``lane_axis`` size
    and the bucket's widths multiples of the ``config_axis`` size."""

    def __init__(self, eval_fn: Callable, bucket: BucketPlan, lane_count: int = 8,
                 mesh=None, lane_axis: str = "lane", config_axis: str = "config",
                 family: int = 0, device=None, device_metrics: Optional[bool] = None):
        from hpbandster_tpu_torch.obs.device_metrics import bin_edges, device_metrics_default
        from hpbandster_tpu_torch.parallel.mesh import mesh_device, shard_count, single_device

        self.bucket = bucket
        self.lane_count = int(lane_count)
        self.mesh = mesh
        self.lane_axis = lane_axis
        self.config_axis = config_axis
        self.family = int(family)
        self.lanes = LaneAllocator(self.lane_count)
        self._lock = threading.Lock()
        self._carry: Optional[torch.Tensor] = None
        self.chunks_run = 0
        #: masked lanes of the last chunk while same-family items waited
        #: for a later chunk (0 by construction)
        self._last_starved = 0
        self.device_metrics = (device_metrics_default() if device_metrics is None
                               else bool(device_metrics))
        split = subs = None
        if mesh is not None:
            lane_size = shard_count(mesh, lane_axis)
            if lane_size > 1 and self.lane_count % lane_size:
                raise ValueError(f"lane_count {self.lane_count} must be a multiple of the "
                                 f"{lane_axis!r} mesh axis ({lane_size})")
            cfg_size = shard_count(mesh, config_axis)
            if cfg_size > 1 and any(w % cfg_size for w in bucket.widths):
                raise ValueError(f"bucket widths {bucket.widths} must be multiples of the "
                                 f"{config_axis!r} mesh axis ({cfg_size}): build the bucket "
                                 "set with mesh_size set to it")
            split, subs = _lane_shards(mesh, lane_axis, config_axis)
            device = mesh_device(mesh) if device is None else device
        n, w0, depth = self.lane_count, bucket.widths[0], bucket.depth
        edges = bin_edges().astype(np.float32) if self.device_metrics else None
        #: the bin edges on the device, made with the buffers (before any
        #: capture)
        self._edges: Optional[torch.Tensor] = None

        def make_buffers(d):
            dev = self.program.device
            self._carry = init_lane_state(n, dev)
            if edges is not None:
                self._edges = torch.as_tensor(edges, device=dev)
            return (torch.zeros((n, w0, d), dtype=torch.float32, device=dev),
                    torch.zeros((n, depth), dtype=torch.int64, device=dev),
                    torch.zeros((n,), dtype=torch.bool, device=dev))

        def chunk(vectors, counts, carry, reset, sub_mesh):
            return fused_sh_bracket_bucketed_packed_carry(
                eval_fn, vectors, counts, carry, reset, bucket,
                telemetry_edges=None if self._edges is None else self._edges.to(vectors.device),
                mesh=sub_mesh, axis=config_axis)

        def body(vectors, counts, reset):
            if split is None:
                out = chunk(vectors, counts, self._carry, reset, None)
            else:
                out = split.gather({
                    s: chunk(*(t[span.start:span.stop].to(split.devices[s])
                               for t in (vectors, counts, self._carry, reset)), subs[s])
                    for s, span in enumerate(split.blocks(n) or [range(n)])}, vectors.device)
            (idx, loss), new_carry = out[0], out[1]
            self._carry.copy_(new_carry)
            packed = _packed_row(idx, loss)
            return packed if self._edges is None else (packed,) + tuple(out[2])

        self.program = StaticProgram("continuous_bracket", device, make_buffers, body,
                                     graphed=single_device(mesh))

    def ensure_compiled(self, d: int) -> None:
        """Build the family's one program (idempotent, thread-safe)."""
        self.program.ensure(d)

    def warm_age_s(self) -> Optional[float]:
        """Seconds since the family's program was built (None: not yet)."""
        built = self.program.built_mono
        return None if built is None else time.monotonic() - built

    def dispatch_chunk(self, entries: Sequence[PackEntry], d: int,
                       waiting: int = 0) -> Callable[[], List[Any]]:
        """Launch one iteration of the resident program; returns a fetch
        callable (one transfer, which waits, then the demux). ``entries``
        board lanes (at most ``lane_count``), the other lanes are masked,
        and the carry stays on the device, so the next chunk can launch at
        once. ``waiting`` is the same-family backlog that did not board."""
        if not entries:
            return lambda: []
        m = get_metrics()
        with self._lock:
            placements = self.lanes.assign([e.tenant for e in entries])
            w0 = self.bucket.widths[0]
            vectors = np.zeros((self.lane_count, w0, int(d)), np.float32)
            counts = np.zeros((self.lane_count, self.bucket.depth), np.int32)
            # every dirty lane resets this chunk, assigned or not: a released
            # lane's stale carry dies at the first chance
            reset = np.zeros(self.lane_count, np.float32)
            for lane in self.lanes.dirty:
                reset[lane] = 1.0
            bus_on = E.get_bus().active
            for e, (lane, warm) in zip(entries, placements):
                rows = np.asarray(e.vectors, np.float32)
                if rows.shape[0] > w0 or rows.shape[1] != int(d):
                    raise ValueError(
                        f"member rows {rows.shape} do not fit bucket (W0={w0}, d={d})")
                vectors[lane, : rows.shape[0]] = rows
                counts[lane] = member_counts_for(self.bucket, e.plan, e.entry)
                if not warm:
                    # ownership changed (a warm re-boarding is silent)
                    if bus_on:
                        E.emit(E.LANE_ASSIGNED, lane=lane, family=self.family,
                               tenant=e.tenant)
                    m.counter("serve.continuous.joins").inc()
            packed = self.program.run(int(d), vectors, counts, reset)
            self.lanes.dirty -= {i for i, on in enumerate(reset) if on}
            self.chunks_run += 1
            occupied = len(entries)
            masked = self.lane_count - occupied
            m.counter("serve.continuous.chunks").inc()
            m.counter("serve.continuous.masked_lanes").inc(masked)
            family = f"serve.family.{self.family}"
            m.gauge(f"{family}.chunks").set(self.chunks_run)
            age = self.warm_age_s()
            if age is not None:
                m.gauge(f"{family}.warm_age_s").set(round(age, 3))
            m.gauge(f"{family}.lanes_occupied").set(occupied)
            # lanes masked while same-family work waited for a later chunk:
            # 0 by construction (a chunk fills before the next one runs)
            self._last_starved = masked if waiting > 0 else 0
            m.gauge(f"{family}.lanes_starved").set(self._last_starved)
            starved, chunk_seq = self._last_starved, self.chunks_run - 1
            t_dispatch = time.monotonic()
        lanes = [lane for lane, _ in placements]

        def fetch():
            if not self.device_metrics:
                out = demux(fetch_packed(packed), self.bucket, entries, lanes)
            else:
                row, hist, crashes = packed
                out = demux(fetch_packed(row), self.bucket, entries, lanes)
                publish_lane_telemetry(*fetch_telemetry(hist, crashes), self.bucket, entries,
                                       out, lanes)
            if E.get_bus().active:
                # span-shaped chunk record, dispatch to fetch: the flight
                # recorder's rung_compute slice for a serving round, and
                # the record the lane_starvation SLO reads
                E.emit("serve_chunk",
                       duration_s=round(time.monotonic() - t_dispatch, 6),
                       family=self.family, lanes=occupied, starved=starved,
                       seq=chunk_seq)
            return out

        return fetch

    def run_chunk(self, entries: Sequence[PackEntry], d: int, waiting: int = 0):
        """Dispatch and fetch one chunk: each entry's true-shape per-stage
        ``(indices, losses)``, in entry order."""
        return self.dispatch_chunk(entries, d, waiting=waiting)()

    def release_tenant(self, tenant: str) -> None:
        """A tenant left the pool: free (and dirty) its lanes."""
        with self._lock:
            freed = self.lanes.release_tenant(tenant)
            if freed and E.get_bus().active:
                for lane in freed:
                    E.emit(E.LANE_RELEASED, lane=lane, family=self.family,
                           tenant=tenant)
            if freed:
                get_metrics().counter("serve.continuous.leaves").inc(len(freed))

    def lane_incumbents(self) -> List[Optional[float]]:
        """Host decode of the resident carry: per lane the running
        incumbent loss (None: nothing observed; NaN: only crashes). A copy
        of the carry is queued under the lock, after the last chunk that
        was launched, and fetched outside it."""
        with self._lock:
            if self._carry is None:
                return [None] * self.lane_count
            snap = self._carry.clone()
        return decode_lane_state(snap)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            age = self.warm_age_s()
            return {
                "family": self.family,
                "lane_count": self.lane_count,
                "occupied": self.lanes.occupied(),
                "owners": list(self.lanes.owners),
                "chunks": self.chunks_run,
                "starved": self._last_starved,
                "warm_age_s": None if age is None else round(age, 3),
            }
