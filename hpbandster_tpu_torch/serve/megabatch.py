"""Cross-tenant megabatching: many small brackets, one device dispatch.

Ported from ``hpbandster_tpu/serve/megabatch.py``. HyperBand brackets are
independent successive-halving ladders, so brackets of one bucket from
different tenants share one program launch:
``ops.buckets.fused_sh_bracket_bucketed_packed`` runs ``P`` lanes of the
same bucket, every stage as one objective call on ``P * W`` rows. This
module owns the packing (member brackets -> lanes, zero padding for the
rest) and the demux (lanes -> each member's true-shape stages).

The lane count ``pack_width`` is static per runner, so the packed path
builds at most one program per ``(bucket, pack_width)``: on a card one
CUDA graph each, captured once in the process. Fewer ready brackets than
lanes leaves zero-count padding lanes (evaluated, never reported); more
takes several dispatches of the same graph. A member's ``(indices,
losses)`` from a packed dispatch equal a solo dispatch of it through
``ops.buckets._BucketRunner`` wherever the objective treats rows
independently.

On a mesh (``mesh=``, ``axis=``: the backend's config mesh) whole lanes
split over ``axis``, so a lane's promotions never cross a shard: shard
``s`` runs its block of lanes on its device and the blocks gather back on
the mesh's home device (``parallel.mesh.RowSplit``). A mesh that repeats
one card captures the program as one graph; a mesh over several cards or
processes runs it eagerly. With the device metrics plane on
(``device_metrics=``, default ``HPB_DEVICE_METRICS``) the program also
returns each lane's loss histograms and crash counts, and :meth:`MegaRunner.demux`
publishes one decoded ``device_telemetry`` record per member lane.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from hpbandster_tpu_torch.device import resolve_device
from hpbandster_tpu_torch.ops.bracket import BracketPlan
from hpbandster_tpu_torch.ops.buckets import (
    BucketPlan,
    StaticProgram,
    _packed_row,
    _publish_member_telemetry,
    fetch_packed,
    fetch_telemetry,
    fused_sh_bracket_bucketed_packed,
    member_counts_for,
    slice_member_stages,
    unpack_flat,
)
from hpbandster_tpu_torch.utils.lru import LRUCache

__all__ = ["PackEntry", "MegaRunner", "make_mega_runner", "pack_members", "demux",
           "publish_lane_telemetry"]


class PackEntry(NamedTuple):
    """One member bracket heading into a packed dispatch."""

    #: who this bracket belongs to (demuxed results return per entry)
    tenant: str
    #: f32[n0, d] member stage-0 rows (true shape; lane-padded here)
    vectors: np.ndarray
    #: the member's true bracket shape
    plan: BracketPlan
    #: entry stage inside the bucket (ops/buckets.py assignment)
    entry: int


def pack_members(
    entries: Sequence[PackEntry], bucket: BucketPlan, pack_width: int, d: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Member brackets -> ``(f32[P, W0, d], i32[P, depth])`` lane arrays.
    Lanes beyond ``len(entries)`` are zero padding: zero vectors and
    all-zero counts (every stage before entry; nobody reads the lane)."""
    if len(entries) > pack_width:
        raise ValueError(f"{len(entries)} members do not fit pack_width {pack_width}")
    w0 = bucket.widths[0]
    vectors = np.zeros((pack_width, w0, d), np.float32)
    counts = np.zeros((pack_width, bucket.depth), np.int32)
    for lane, e in enumerate(entries):
        rows = np.asarray(e.vectors, np.float32)
        if rows.shape[0] > w0 or rows.shape[1] != d:
            raise ValueError(f"member rows {rows.shape} do not fit bucket (W0={w0}, d={d})")
        vectors[lane, : rows.shape[0]] = rows
        for s, k in enumerate(e.plan.num_configs):
            counts[lane, e.entry + s] = int(k)
    return vectors, counts


def demux(
    flat: np.ndarray, bucket: BucketPlan, entries: Sequence[PackEntry],
    lanes: Optional[Sequence[int]] = None,
) -> List[List[Tuple[np.ndarray, np.ndarray]]]:
    """A fetched packed dispatch (``[P, 2 * sum(widths)]``: indices as
    float32, then losses) -> each entry's true-shape per-stage ``(indices,
    losses)``, in ``entries`` order; entry ``i`` reads lane ``lanes[i]``
    (default: lane ``i``)."""
    lanes = range(len(entries)) if lanes is None else lanes
    return [slice_member_stages(unpack_flat(flat[lane], bucket.widths), e.plan, e.entry)
            for e, lane in zip(entries, lanes)]


def publish_lane_telemetry(hist: np.ndarray, crashes: np.ndarray, bucket: BucketPlan,
                           entries: Sequence[PackEntry], members: Sequence,
                           lanes: Optional[Sequence[int]] = None) -> None:
    """One decoded ``device_telemetry`` record per member lane of a
    fetched dispatch (``hist [P, depth, bins]``, ``crashes [P, depth]``):
    entry ``i``'s lane ``lanes[i]`` (default ``i``) against its
    true-shape stages ``members[i]``."""
    lanes = range(len(entries)) if lanes is None else lanes
    for e, member, lane in zip(entries, members, lanes):
        _publish_member_telemetry(hist[lane], crashes[lane],
                                  member_counts_for(bucket, e.plan, e.entry), bucket.budgets,
                                  member)


class MegaRunner:
    """One bucket's packed program: ``pack_width`` lanes per dispatch, one
    CUDA graph on a card (built once, thread-safe), eager on the CPU; on a
    mesh the lanes split over ``axis`` (``pack_width`` a multiple of its
    size)."""

    def __init__(self, eval_fn, bucket: BucketPlan, pack_width: int = 8, mesh=None,
                 axis: str = "config", device=None, device_metrics: Optional[bool] = None):
        from hpbandster_tpu_torch.obs.device_metrics import bin_edges, device_metrics_default
        from hpbandster_tpu_torch.parallel.mesh import (
            batch_sharding,
            mesh_device,
            shard_count,
            single_device,
        )

        if pack_width < 1:
            raise ValueError("pack_width must be >= 1")
        self.bucket = bucket
        self.pack_width = int(pack_width)
        self.mesh = mesh
        self.axis = axis
        self.device_metrics = (device_metrics_default() if device_metrics is None
                               else bool(device_metrics))
        split = None
        if mesh is not None:
            n = shard_count(mesh, axis)
            if n > 1 and self.pack_width % n:
                raise ValueError(f"pack_width {self.pack_width} must be a multiple of the "
                                 f"{axis!r} mesh axis ({n}) to lane-shard")
            split = batch_sharding(mesh, axis)
            device = mesh_device(mesh) if device is None else device
        shape = (self.pack_width, bucket.widths[0])
        edges = bin_edges().astype(np.float32) if self.device_metrics else None
        #: the bin edges on the device, made with the buffers (before any
        #: capture)
        self._edges: Optional[torch.Tensor] = None

        def make_buffers(d):
            dev = self.program.device
            if edges is not None:
                self._edges = torch.as_tensor(edges, device=dev)
            return (torch.zeros(shape + (d,), dtype=torch.float32, device=dev),
                    torch.zeros((self.pack_width, bucket.depth), dtype=torch.int64,
                                device=dev))

        def lanes(vectors, counts):
            edges_here = None if self._edges is None else self._edges.to(vectors.device)
            return fused_sh_bracket_bucketed_packed(eval_fn, vectors, counts, bucket,
                                                    telemetry_edges=edges_here)

        def body(vectors, counts):
            out = lanes(vectors, counts) if split is None else split.map(lanes, vectors, counts)
            packed = _packed_row(out[0], out[1])
            return packed if self._edges is None else (packed,) + tuple(out[2:])

        self.program = StaticProgram("megabatch_bracket", device, make_buffers, body,
                                     graphed=single_device(mesh))

    def ensure_compiled(self, d: int) -> None:
        """Build the packed program (idempotent, thread-safe)."""
        self.program.ensure(d)

    def dispatch(self, entries: Sequence[PackEntry], d: int):
        """Launch one packed dispatch of up to ``pack_width`` members;
        returns the packed device output without waiting."""
        vectors, counts = pack_members(entries, self.bucket, self.pack_width, int(d))
        return self.program.run(int(d), vectors, counts)

    def demux(self, packed, entries: Sequence[PackEntry]):
        """Fetch one dispatch (one transfer, which waits) and cut it into
        each member's true-shape per-stage ``(indices, losses)``; with
        telemetry, publish one ``device_telemetry`` record per member
        lane."""
        if not self.device_metrics:
            return demux(fetch_packed(packed), self.bucket, entries)
        row, hist, crashes = packed
        out = demux(fetch_packed(row), self.bucket, entries)
        publish_lane_telemetry(*fetch_telemetry(hist, crashes), self.bucket, entries, out)
        return out

    def run_packed(self, entries: Sequence[PackEntry], d: int):
        """Dispatch and demux in one call."""
        return self.demux(self.dispatch(entries, d), entries)


#: process-wide packed-runner cache, the solo runners' policy
_MEGA_FN_CACHE: LRUCache = LRUCache(maxsize=64)


def make_mega_runner(eval_fn, bucket: BucketPlan, pack_width: int = 8, mesh=None,
                     axis: str = "config", device=None,
                     device_metrics: Optional[bool] = None) -> MegaRunner:
    """The process-cached packed runner of one bucket on ``device``
    (``None`` means ``cuda``; with a mesh, its home device). The telemetry
    flag resolves before the cache key (``HPB_DEVICE_METRICS`` by default):
    it changes the program, so each flag has its own runner and graph."""
    from hpbandster_tpu_torch.obs.device_metrics import device_metrics_default
    from hpbandster_tpu_torch.parallel.mesh import mesh_device

    dev = resolve_device(device if mesh is None or device is not None
                         else mesh_device(mesh))
    if device_metrics is None:
        device_metrics = device_metrics_default()
    key = (eval_fn, bucket, int(pack_width), mesh, axis, dev, bool(device_metrics))
    runner = _MEGA_FN_CACHE.get(key)
    if runner is None:
        runner = MegaRunner(eval_fn, bucket, pack_width=pack_width, mesh=mesh, axis=axis,
                            device=dev, device_metrics=device_metrics)
        _MEGA_FN_CACHE[key] = runner
    return runner
