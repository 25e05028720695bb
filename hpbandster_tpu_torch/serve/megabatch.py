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
independently. The reference's per-lane telemetry publication waits for
the port's ``obs`` layer.
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
    fetch_packed,
    fused_sh_bracket_bucketed_packed,
    slice_member_stages,
    unpack_flat,
)
from hpbandster_tpu_torch.utils.lru import LRUCache

__all__ = ["PackEntry", "MegaRunner", "make_mega_runner", "pack_members", "demux"]


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


class MegaRunner:
    """One bucket's packed program: ``pack_width`` lanes per dispatch, one
    CUDA graph on a card (built once, thread-safe), eager on the CPU."""

    def __init__(self, eval_fn, bucket: BucketPlan, pack_width: int = 8, mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "MegaRunner(mesh=...) is not ported yet (ROADMAP A7: multi-GPU)")
        if pack_width < 1:
            raise ValueError("pack_width must be >= 1")
        self.bucket = bucket
        self.pack_width = int(pack_width)
        shape = (self.pack_width, bucket.widths[0])

        def make_buffers(d):
            dev = self.program.device
            return (torch.zeros(shape + (d,), dtype=torch.float32, device=dev),
                    torch.zeros((self.pack_width, bucket.depth), dtype=torch.int64,
                                device=dev))

        def body(vectors, counts):
            return _packed_row(*fused_sh_bracket_bucketed_packed(
                eval_fn, vectors, counts, bucket))

        self.program = StaticProgram("megabatch_bracket", device, make_buffers, body)

    def ensure_compiled(self, d: int) -> None:
        """Build the packed program (idempotent, thread-safe)."""
        self.program.ensure(d)

    def dispatch(self, entries: Sequence[PackEntry], d: int) -> torch.Tensor:
        """Launch one packed dispatch of up to ``pack_width`` members;
        returns the packed device tensor without waiting."""
        vectors, counts = pack_members(entries, self.bucket, self.pack_width, int(d))
        return self.program.run(int(d), vectors, counts)

    def demux(self, packed: torch.Tensor, entries: Sequence[PackEntry]):
        """Fetch one dispatch (one transfer, which waits) and cut it into
        each member's true-shape per-stage ``(indices, losses)``."""
        return demux(fetch_packed(packed), self.bucket, entries)

    def run_packed(self, entries: Sequence[PackEntry], d: int):
        """Dispatch and demux in one call."""
        return self.demux(self.dispatch(entries, d), entries)


#: process-wide packed-runner cache, the solo runners' policy
_MEGA_FN_CACHE: LRUCache = LRUCache(maxsize=64)


def make_mega_runner(eval_fn, bucket: BucketPlan, pack_width: int = 8, mesh=None,
                     device=None) -> MegaRunner:
    """The process-cached packed runner of one bucket on ``device``
    (``None`` means ``cuda``)."""
    if mesh is not None:
        raise NotImplementedError(
            "make_mega_runner(mesh=...) is not ported yet (ROADMAP A7: multi-GPU)")
    dev = resolve_device(device)
    key = (eval_fn, bucket, int(pack_width), dev)
    runner = _MEGA_FN_CACHE.get(key)
    if runner is None:
        runner = MegaRunner(eval_fn, bucket, pack_width=pack_width, device=dev)
        _MEGA_FN_CACHE[key] = runner
    return runner
