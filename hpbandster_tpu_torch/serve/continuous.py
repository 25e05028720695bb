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

The reference's 2-D lane x config mesh (``make_lane_mesh``, ``mesh=``)
waits for the port's multi-GPU slice, and its lane gauges and events for
the port's ``obs`` layer.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hpbandster_tpu_torch.ops.buckets import (
    BucketPlan,
    StaticProgram,
    _packed_row,
    fetch_packed,
    fused_sh_bracket_bucketed_packed_carry,
    member_counts_for,
)
from hpbandster_tpu_torch.ops.sweep import decode_lane_state, init_lane_state
from hpbandster_tpu_torch.serve.megabatch import PackEntry, demux

__all__ = ["ContinuousRunner", "LaneAllocator", "make_lane_mesh"]


def make_lane_mesh(lane_shards: int, devices=None):
    """The reference's 2-D ``lane x config`` mesh: not ported yet."""
    raise NotImplementedError(
        "make_lane_mesh is not ported yet (ROADMAP A7: multi-GPU)")


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
    carry stays on the device for the next chunk."""

    def __init__(self, eval_fn: Callable, bucket: BucketPlan, lane_count: int = 8,
                 mesh=None, family: int = 0, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "ContinuousRunner(mesh=...) is not ported yet (ROADMAP A7: multi-GPU)")
        self.bucket = bucket
        self.lane_count = int(lane_count)
        self.family = int(family)
        self.lanes = LaneAllocator(self.lane_count)
        self._lock = threading.Lock()
        self._carry: Optional[torch.Tensor] = None
        self.chunks_run = 0
        #: masked lanes of the last chunk while same-family items waited
        #: for a later chunk (0 by construction)
        self._last_starved = 0
        n, w0, depth = self.lane_count, bucket.widths[0], bucket.depth

        def make_buffers(d):
            dev = self.program.device
            self._carry = init_lane_state(n, dev)
            return (torch.zeros((n, w0, d), dtype=torch.float32, device=dev),
                    torch.zeros((n, depth), dtype=torch.int64, device=dev),
                    torch.zeros((n,), dtype=torch.bool, device=dev))

        def body(vectors, counts, reset):
            (idx, loss), new_carry = fused_sh_bracket_bucketed_packed_carry(
                eval_fn, vectors, counts, self._carry, reset, bucket)
            self._carry.copy_(new_carry)
            return _packed_row(idx, loss)

        self.program = StaticProgram("continuous_bracket", device, make_buffers, body)

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
            for e, (lane, _warm) in zip(entries, placements):
                rows = np.asarray(e.vectors, np.float32)
                if rows.shape[0] > w0 or rows.shape[1] != int(d):
                    raise ValueError(
                        f"member rows {rows.shape} do not fit bucket (W0={w0}, d={d})")
                vectors[lane, : rows.shape[0]] = rows
                counts[lane] = member_counts_for(self.bucket, e.plan, e.entry)
            packed = self.program.run(int(d), vectors, counts, reset)
            self.lanes.dirty -= {i for i, on in enumerate(reset) if on}
            self.chunks_run += 1
            self._last_starved = (self.lane_count - len(entries)) if waiting > 0 else 0
        lanes = [lane for lane, _ in placements]
        return lambda: demux(fetch_packed(packed), self.bucket, entries, lanes)

    def run_chunk(self, entries: Sequence[PackEntry], d: int, waiting: int = 0):
        """Dispatch and fetch one chunk: each entry's true-shape per-stage
        ``(indices, losses)``, in entry order."""
        return self.dispatch_chunk(entries, d, waiting=waiting)()

    def release_tenant(self, tenant: str) -> None:
        """A tenant left the pool: free (and dirty) its lanes."""
        with self._lock:
            self.lanes.release_tenant(tenant)

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
