"""Shape-bucketed fused brackets: a handful of device programs for a whole
sweep.

Ported from ``hpbandster_tpu/ops/buckets.py``. A per-shape fused bracket
(``ops/fused.py``) burns its stage widths into the program, so a HyperBand
schedule needs one program per distinct ``(num_configs, budgets)``. Here
bracket shapes pad up to a small geometric bucket set and the per-stage
survivor counts become device inputs, so every bracket of a bucket runs
the same program: on a card one CUDA graph per bucket, captured once in the
process and replayed for every member bracket.

Bucket geometry (:func:`build_bucket_set`): adjacent present depths
``(d, d-1)`` share a bucket aligned at the ladder's tail (the shallower
member enters at stage 1), and each rung's width is the widest aligned
member count rounded up to a power of two (floor 8). A shape whose budgets
are not a suffix of its group's deepest member gets its own bucket. On a
mesh (``mesh_size``) every stage width is also padded to a multiple of the
config axis's shard count (:func:`_mesh_pad`), so each rung splits evenly.

The bucketed bracket (:func:`fused_sh_bracket_bucketed`) promotes exactly
as the per-shape bracket does: NaN (crashed) rows rank behind every clean
loss and ahead of padding, ties keep the lower index, survivors keep their
order. The top-k width is a device count, so promotion is a rank mask (a
stable double argsort) and then a static-width gather, with no host read
of a count. Rows past a stage's count are padding: evaluated, never
promoted, never reported. Before a member's entry stage (count 0) the
bracket carries the identity slice, so the entering rows survive as they
are.

Lanes: the lane-packed kernels (:func:`fused_sh_bracket_bucketed_packed`
and its carried form, the serving tier's programs) run ``P`` independent
member brackets of one bucket at once. Each stage evaluates all lanes in
ONE call of the objective on ``P * W`` rows, and promotion sorts within
each lane; the solo bracket is the one-lane case of the same function, so
a lane's results equal a solo dispatch of that bracket wherever the
objective treats rows independently.

Runners (:class:`_BucketRunner`, :func:`make_bucketed_bracket_fn`) are
cached per process. On a card each captures its graph once
(``ensure_compiled``, also ahead of time and in the background through
:func:`precompile_buckets`, so the capture overlaps the optimizer's
stage-0 sampling); a dispatch copies the inputs into the graph's static
buffers, replays, and copies the packed output into a fresh tensor, so two
dispatches in flight never share an output. On the CPU the same body runs
eagerly over the same static buffers. A capture that fails keeps its
error, and the next dispatch of that bucket raises it. With the device
metrics plane on (``device_metrics=``, default ``HPB_DEVICE_METRICS``) a
bucket program also returns each stage's loss histogram and crash count,
and every unpack publishes the member's decoded record to the obs bus
(the gauges and one ``device_telemetry`` journal record,
``_publish_member_telemetry``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from hpbandster_tpu_torch.device import resolve_device, upload
from hpbandster_tpu_torch.obs.runtime import note_transfer
from hpbandster_tpu_torch.ops.bracket import BracketPlan
from hpbandster_tpu_torch.ops.fused import _CRASH_RANK, stage_telemetry
from hpbandster_tpu_torch.utils.lru import LRUCache

__all__ = [
    "BucketPlan",
    "BucketSet",
    "build_bucket_set",
    "bucketed_stage_telemetry",
    "fused_sh_bracket_bucketed",
    "fused_sh_bracket_bucketed_packed",
    "fused_sh_bracket_bucketed_packed_carry",
    "make_bucketed_bracket_fn",
    "member_counts_for",
    "member_telemetry_record",
    "precompile_buckets",
    "slice_member_stages",
]

_F32 = torch.float32


class BucketPlan(NamedTuple):
    """One bucket program: static per-stage widths and budgets."""

    #: padded row capacity at each stage (non-increasing, pow2, floor 8)
    widths: Tuple[int, ...]
    #: budget per stage (a ladder suffix)
    budgets: Tuple[float, ...]

    @property
    def depth(self) -> int:
        return len(self.widths)


class BucketSet(NamedTuple):
    """The bucket programs for a schedule and each shape's placement."""

    buckets: Tuple[BucketPlan, ...]
    #: (num_configs, budgets) -> (bucket_index, entry_stage)
    assignment: Dict[Tuple, Tuple[int, int]]

    def lookup(self, num_configs, budgets) -> Optional[Tuple[int, int]]:
        key = (
            tuple(int(n) for n in num_configs),
            tuple(float(b) for b in budgets),
        )
        return self.assignment.get(key)

    def place(self, num_configs, budgets) -> Optional[Tuple[BucketPlan, BracketPlan, int]]:
        """``(bucket, member plan, entry stage)`` serving a bracket shape,
        or None where the set does not cover it."""
        placed = self.lookup(num_configs, budgets)
        if placed is None:
            return None
        bucket_idx, entry = placed
        plan = BracketPlan(num_configs=tuple(num_configs), budgets=tuple(budgets))
        return self.buckets[bucket_idx], plan, entry


def _pow2(n: int, floor: int = 8) -> int:
    size = floor
    while size < n:
        size *= 2
    return size


def build_bucket_set(
    plans: Sequence[BracketPlan],
    *,
    min_width: int = 8,
    mesh_size: int = 1,
) -> BucketSet:
    """Group a schedule's bracket shapes into a small geometric bucket set.

    Shapes group by depth, adjacent present depths pairing up (deepest
    first); within a bucket, shapes align at the ladder tail, the bucket's
    budgets are the deepest member's, and each rung's width is the widest
    aligned member count rounded up to a power of two. A shape whose
    budgets are not a suffix of its group's deepest member (a plan from
    another ladder) gets its own singleton bucket. Single-stage plans are
    left out (nothing to fuse). ``mesh_size`` pads every bucket's widths
    to a multiple of the config axis's shard count (:func:`_mesh_pad`).
    """
    shapes = sorted(
        {
            (
                tuple(int(n) for n in p.num_configs),
                tuple(float(b) for b in p.budgets),
            )
            for p in plans
            if len(p.num_configs) >= 2
        },
        key=lambda s: (-len(s[1]), s[1], s[0]),
    )
    by_depth: Dict[int, List[Tuple]] = {}
    for shape in shapes:
        by_depth.setdefault(len(shape[1]), []).append(shape)

    buckets: List[BucketPlan] = []
    assignment: Dict[Tuple, Tuple[int, int]] = {}
    used: set = set()
    for d in sorted(by_depth, reverse=True):
        if d in used:
            continue
        group_depths = [d]
        if (d - 1) in by_depth and (d - 1) not in used:
            group_depths.append(d - 1)
        used.update(group_depths)

        bucket_budgets = by_depth[d][0][1]
        members: List[Tuple[Tuple, int]] = []  # (shape, entry)
        for gd in group_depths:
            for shape in by_depth[gd]:
                entry = len(bucket_budgets) - len(shape[1])
                if shape[1] == bucket_budgets[entry:]:
                    members.append((shape, entry))
                else:
                    assignment[shape] = (len(buckets), 0)
                    buckets.append(_mesh_pad(BucketPlan(
                        widths=tuple(_pow2(int(n), min_width) for n in shape[0]),
                        budgets=shape[1],
                    ), mesh_size))
        if not members:
            continue
        widths = [0] * len(bucket_budgets)
        for shape, entry in members:
            for s, n in enumerate(shape[0]):
                widths[entry + s] = max(widths[entry + s], int(n))
        # the pow2 roundup of a non-increasing profile stays non-increasing;
        # the running max from the right guards degenerate inputs anyway
        widths = [_pow2(w, min_width) for w in widths]
        for j in range(len(widths) - 2, -1, -1):
            widths[j] = max(widths[j], widths[j + 1])
        idx = len(buckets)
        buckets.append(_mesh_pad(BucketPlan(widths=tuple(widths), budgets=bucket_budgets),
                                 mesh_size))
        for shape, entry in members:
            assignment[shape] = (idx, entry)
    return BucketSet(buckets=tuple(buckets), assignment=assignment)


def _mesh_pad(bucket: BucketPlan, mesh_size: int) -> BucketPlan:
    """Every stage width padded to a multiple of ``mesh_size``, so each rung
    of the ladder splits evenly over the config axis (an indivisible stage
    would run whole on the home device). Widths are powers of two (floor 8),
    so on a power-of-two mesh no wider than a stage nothing pads; per stage
    the padding is at most ``mesh_size - 1`` rows."""
    m = max(int(mesh_size), 1)
    if m == 1 or all(w % m == 0 for w in bucket.widths):
        return bucket
    widths = [((w + m - 1) // m) * m for w in bucket.widths]
    # the roundup of a non-increasing profile stays non-increasing; guarded
    # as build_bucket_set guards it
    for j in range(len(widths) - 2, -1, -1):
        widths[j] = max(widths[j], widths[j + 1])
    return BucketPlan(widths=tuple(widths), budgets=bucket.budgets)


# --------------------------------------------------------------- kernels
def _eval_lanes(eval_fn, vecs: torch.Tensor, budget: float, mesh=None,
                axis: str = "config") -> torch.Tensor:
    """One stage of ``P`` lanes, ``vecs [P, w, d]``: ONE objective call on
    ``P * w`` rows, reshaped back to ``[P, w]``; on a mesh the rows split
    over its config axis (``parallel.mesh.batch_sharding``)."""
    p, w, d = vecs.shape

    def evaluate(rows):
        losses = eval_fn(rows, budget)
        if losses.shape != (rows.shape[0],):
            raise ValueError(
                f"eval_fn must return one loss per row, f32[{rows.shape[0]}], got shape "
                f"{tuple(losses.shape)}")
        return losses.to(_F32)

    flat = vecs.reshape(p * w, d)
    if mesh is None:
        return evaluate(flat).reshape(p, w)
    from hpbandster_tpu_torch.parallel.mesh import batch_sharding

    return batch_sharding(mesh, axis).map(evaluate, flat).reshape(p, w)


def _bucketed_lanes(eval_fn, vectors: torch.Tensor, counts: torch.Tensor,
                    bucket: BucketPlan, mesh=None,
                    axis: str = "config") -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The one definition of a bucketed bracket, over ``P`` lanes:
    ``vectors [P, W0, d]``, ``counts`` integer ``[P, depth]`` on the same
    device, each stage's rows split over ``mesh``'s config axis when one is
    given. Returns per-stage ``(idx int64 [P, w], losses f32 [P, w])``."""
    widths, budgets = bucket.widths, bucket.budgets
    dev = vectors.device
    n_lanes = vectors.shape[0]
    cur_vecs = vectors
    cur_idx = torch.arange(widths[0], device=dev).expand(n_lanes, -1)
    out = []
    for t in range(len(widths)):
        losses = _eval_lanes(eval_fn, cur_vecs, float(budgets[t]), mesh, axis)
        out.append((cur_idx, losses))
        if t + 1 == len(widths):
            break
        w, w_next = widths[t], widths[t + 1]
        rows = torch.arange(w, device=dev)[None, :]
        count, count_next = counts[:, t:t + 1], counts[:, t + 1:t + 2]
        valid = rows < count
        key = torch.where(torch.isnan(losses),
                          torch.full_like(losses, float(_CRASH_RANK)), losses)
        key = torch.where(valid, key, torch.full_like(key, float("inf")))
        # double argsort = value rank with index-stable ties: the selection
        # the per-shape bracket's stable sort makes
        ranks = torch.argsort(torch.argsort(key, dim=1, stable=True), dim=1, stable=True)
        promote = (ranks < count_next) & valid
        # survivors first, in their original order, then the rest: a static
        # head slice is the gather
        order = torch.argsort(torch.where(promote, rows, rows + w), dim=1, stable=True)
        identity = torch.arange(w_next, device=dev)[None, :]
        sel = torch.where(count > 0, order[:, :w_next], identity)
        cur_vecs = torch.gather(
            cur_vecs, 1, sel[:, :, None].expand(-1, -1, cur_vecs.shape[2]))
        cur_idx = torch.gather(cur_idx, 1, sel)
    return out


def fused_sh_bracket_bucketed(
    eval_fn: Callable, vectors: torch.Tensor, counts: torch.Tensor, bucket: BucketPlan,
    mesh=None, axis: str = "config",
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """One bucketed bracket on the device. ``vectors`` is ``f32[W0, d]``
    (member rows first, zero-padded); ``counts`` the member's true
    per-stage config counts (integer ``[depth]`` on the vectors' device, 0
    before its entry). Returns per-stage ``(indices int64, losses f32)`` at
    bucket widths; rows past ``counts[t]`` are padding
    (:func:`slice_member_stages` cuts them). Nothing here reads a count on
    the host, so the bracket captures into a CUDA graph. ``mesh``/``axis``
    split each stage's evaluation over the config axis; the rank mask and
    the survivor gather run on the home device, and the values are those
    of the unsharded bracket."""
    stages = _bucketed_lanes(eval_fn, vectors[None], counts[None], bucket, mesh, axis)
    return [(i[0], l[0]) for i, l in stages]


def bucketed_stage_telemetry(stages, counts, edges):
    """Device-metrics accumulation over one bucketed bracket's stages:
    per stage ``(histogram i32[n_bins], crash count i32[])`` in the schema
    of ``ops.fused.stage_telemetry``. Rows past a stage's count are padding
    and are left out of both."""
    out = []
    for t, (_idx, losses) in enumerate(stages):
        live = torch.arange(losses.shape[0], device=losses.device) < counts[t]
        masked = torch.where(live, losses, torch.full_like(losses, float("nan")))
        hist, crashes = stage_telemetry(masked, edges)
        crashes = crashes - (~live).sum(dtype=torch.int32)
        out.append((hist, crashes))
    return out


def _flat(stages) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-stage lane pairs -> ``(idx [P, sum(widths)], losses [P, ...])``."""
    return (torch.cat([s[0] for s in stages], dim=1),
            torch.cat([s[1] for s in stages], dim=1))


def _lane_telemetry(stages, counts, edges):
    """Per-lane ``(hist i32[P, depth, n_bins], crashes i32[P, depth])``."""
    hists, crashes = [], []
    for lane in range(counts.shape[0]):
        tel = bucketed_stage_telemetry(
            [(i[lane], l[lane]) for i, l in stages], counts[lane], edges)
        hists.append(torch.stack([h for h, _ in tel]))
        crashes.append(torch.stack([c for _, c in tel]))
    return torch.stack(hists), torch.stack(crashes)


def fused_sh_bracket_bucketed_packed(
    eval_fn: Callable, vectors: torch.Tensor, counts: torch.Tensor,
    bucket: BucketPlan, telemetry_edges: Optional[torch.Tensor] = None,
    mesh=None, axis: str = "config",
):
    """A lane-packed stack of bucketed brackets: ``vectors f32[P, W0, d]``
    and integer ``counts [P, depth]``, ``P`` member brackets of the same
    bucket (the serving tier's cross-tenant megabatch). Lanes never
    interact, and each lane's promotions equal a solo dispatch of that
    bracket. Returns ``(idx [P, sum(widths)], losses f32[P, sum(widths)])``,
    the solo runner's flat layout with a lane axis; with ``telemetry_edges``
    (the metrics plane's bin edges on the device) also per-lane ``(hist,
    crashes)``. An all-zero-count lane is padding: evaluated, carried by
    the identity slice, never reported. ``mesh``/``axis`` split each
    stage's evaluation over that axis, as for the solo bracket."""
    stages = _bucketed_lanes(eval_fn, vectors, counts, bucket, mesh, axis)
    idx, loss = _flat(stages)
    if telemetry_edges is None:
        return idx, loss
    return (idx, loss) + _lane_telemetry(stages, counts, telemetry_edges)


def fused_sh_bracket_bucketed_packed_carry(
    eval_fn: Callable, vectors: torch.Tensor, counts: torch.Tensor,
    carry: torch.Tensor, reset: torch.Tensor, bucket: BucketPlan,
    telemetry_edges: Optional[torch.Tensor] = None, mesh=None, axis: str = "config",
):
    """The carried lane-packed kernel, the continuous-batching tier's
    program (``serve/continuous.py``): the lanes of
    :func:`fused_sh_bracket_bucketed_packed` plus a per-lane incumbent in
    rank space (``carry f32[P]``, ``ops.sweep.init_lane_state``).
    ``reset bool[P]`` re-initializes a lane's carry before this chunk folds
    (its owner changed). Each lane folds ``min(carry, best final-stage
    rank)``, NaN ranking at the crash constant and rows past the lane's
    final count at +inf, so an empty lane's carry passes through. Returns
    ``((idx, losses), new_carry)``, and the per-lane telemetry third with
    ``telemetry_edges``. ``mesh``/``axis`` split each stage's evaluation
    over that axis (a lane mesh's config axis)."""
    stages = _bucketed_lanes(eval_fn, vectors, counts, bucket, mesh, axis)
    f_loss = stages[-1][1]
    valid = torch.arange(bucket.widths[-1], device=f_loss.device)[None, :] < counts[:, -1:]
    rank = torch.where(torch.isnan(f_loss),
                       torch.full_like(f_loss, float(_CRASH_RANK)), f_loss)
    rank = torch.where(valid, rank, torch.full_like(rank, float("inf")))
    base = torch.where(reset, torch.full_like(carry, float("inf")), carry)
    new_carry = torch.minimum(base, rank.min(dim=1).values)
    out = (_flat(stages), new_carry)
    if telemetry_edges is None:
        return out
    return out + (_lane_telemetry(stages, counts, telemetry_edges),)


# ------------------------------------------------------------- host side
def slice_member_stages(stages: List[Tuple], plan: BracketPlan, entry: int) -> List[Tuple]:
    """Cut a bucket dispatch's stage list down to one member bracket's:
    bucket stage ``entry + s`` holds member stage ``s`` in its first
    ``plan.num_configs[s]`` rows."""
    out = []
    for s, k in enumerate(plan.num_configs):
        idx, losses = stages[entry + s]
        out.append((idx[: int(k)], losses[: int(k)]))
    return out


def member_counts_for(bucket: BucketPlan, plan: BracketPlan, entry: int) -> np.ndarray:
    """One member bracket's entry-aligned count vector (``i32[depth]``,
    zeros before its entry): the one layout every dispatcher builds."""
    counts = np.zeros(bucket.depth, np.int32)
    for s, k in enumerate(plan.num_configs):
        counts[entry + s] = int(k)
    return counts


def member_telemetry_record(hist, crashes, counts, budgets, stages):
    """One member bracket's fetched telemetry -> the decoded
    ``device_telemetry`` record (``obs/device_metrics.py`` schema).

    ``hist``/``crashes`` are the :func:`bucketed_stage_telemetry` outputs
    of this member's dispatch (or its lane of a packed one), bucket-depth
    rows; ``counts`` the member's entry-aligned counts; ``budgets`` the
    bucket's; ``stages`` the member's true-shape per-stage ``(idx,
    losses)``. Returns None for an all-zero (padding) lane."""
    from types import SimpleNamespace

    from hpbandster_tpu_torch.obs.device_metrics import decode_device_metrics

    counts = np.asarray(counts, np.int64)
    nonzero = np.nonzero(counts)[0]
    if nonzero.size == 0:
        return None
    entry = int(nonzero[0])
    member_counts = tuple(int(c) for c in counts[entry:])
    member_budgets = tuple(float(b) for b in budgets[entry:])
    n_stages = len(member_counts)
    hist_m = np.asarray(hist)[entry:entry + n_stages]
    crash_m = np.asarray(crashes)[entry:entry + n_stages]
    # promotions are the next stage's count (the rank mask always fills it:
    # counts are non-increasing and crashed rows still rank)
    promos = np.array(list(member_counts[1:]) + [0], np.int64)
    final_losses = np.asarray(stages[-1][1], np.float32)[: member_counts[-1]]
    finite = final_losses[~np.isnan(final_losses)]
    best = float(finite.min()) if finite.size else float("nan")
    metrics = SimpleNamespace(
        loss_hist=hist_m[None, :, :],
        evals=np.array([member_counts], np.int64),
        crashes=crash_m[None, :],
        promotions=promos[None, :],
        model_fits=np.zeros((1,), np.int64),
        best_final=np.array([best], np.float32),
    )
    return decode_device_metrics(metrics, plans=[(member_counts, member_budgets)])


def _publish_member_telemetry(hist, crashes, counts, budgets, stages) -> None:
    """Decode one member's fetched telemetry and hand it to the obs
    pipeline (gauges and a ``device_telemetry`` journal record)."""
    from hpbandster_tpu_torch.obs.device_metrics import (
        emit_device_telemetry,
        publish_device_metrics,
    )

    rec = member_telemetry_record(hist, crashes, counts, budgets, stages)
    if rec is not None:
        publish_device_metrics(rec)
        emit_device_telemetry(rec)


class _TelemetryPacked(NamedTuple):
    """A telemetry-carrying dispatch: the program's output tensors and the
    member's host counts the decode needs (callers hand dispatch results
    to ``unpack`` untouched)."""

    out: Tuple[torch.Tensor, ...]
    counts: np.ndarray


def unpack_flat(flat: np.ndarray, widths: Sequence[int]) -> List[Tuple[np.ndarray, np.ndarray]]:
    """A fetched packed row (``[indices as f32 | losses]`` over
    ``sum(widths)`` each) -> per-stage ``(idx int64, losses f32)``."""
    total = int(sum(widths))
    idx_flat = flat[:total].astype(np.int64)
    loss_flat = flat[total:]
    out, off = [], 0
    for w in widths:
        out.append((idx_flat[off:off + w], loss_flat[off:off + w]))
        off += w
    return out


def fetch_telemetry(hist: torch.Tensor, crashes: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """A dispatch's telemetry (histograms and crash counts) on the host,
    counted as two buffers."""
    hist, crashes = hist.cpu().numpy(), crashes.cpu().numpy()
    note_transfer("d2h", hist.nbytes + crashes.nbytes, buffers=2)
    return hist, crashes


def _packed_row(idx: torch.Tensor, losses: torch.Tensor) -> torch.Tensor:
    """One tensor for one transfer: indices are exact in float32."""
    return torch.cat([idx.to(_F32), losses], dim=-1)


def fetch_packed(packed: torch.Tensor) -> np.ndarray:
    """A packed row (or lanes of rows) on the host, counted as the
    reference counts its fetched (idx, loss) pair: two buffers."""
    flat = packed.cpu().numpy()
    note_transfer("d2h", flat.nbytes, buffers=2)
    return flat


class StaticProgram:
    """A device program over static input buffers, run eagerly on the CPU
    and as one captured CUDA graph on a card: the plumbing the bucket, the
    megabatch and the continuous runners share.

    ``make_buffers(d)`` returns the static input tensors for vectors of
    ``d`` dims; ``body(*buffers)`` computes the program and returns its
    output tensor (or a tuple of them). :meth:`run` copies host arrays into
    the buffers, runs or replays, and returns a fresh output, on the
    stream, without waiting. ``graphed=False`` runs the body eagerly on a
    card too: a program whose work spans several cards or processes (a
    mesh's shards) is not one capturable stream.
    The build happens once (``ensure``), thread-safe; a build that fails
    keeps its error and every later call raises it."""

    def __init__(self, name: str, device, make_buffers, body, graphed: bool = True):
        self.name = name
        self.graphed = bool(graphed)
        self.device = resolve_device(device)
        self._make_buffers = make_buffers
        self._body = body
        self._lock = threading.Lock()
        self._buffers: Optional[Tuple[torch.Tensor, ...]] = None
        self._out = None
        self._dim: Optional[int] = None
        self._error: Optional[BaseException] = None
        self.graph = None
        #: host seconds of the build (capture and instantiate on a card)
        self.build_s: Optional[float] = None
        self.built_mono: Optional[float] = None

    @property
    def built(self) -> bool:
        return self._dim is not None

    def ensure(self, d: int) -> None:
        with self._lock:
            self._ensure_locked(int(d))

    def _ensure_locked(self, d: int) -> None:
        if self._error is not None:
            raise RuntimeError(
                f"{self.name} program failed to build earlier") from self._error
        if self._dim is not None:
            if self._dim != d:
                raise ValueError(
                    f"{self.name} program built for d={self._dim}, asked for d={d}")
            return
        t0 = time.perf_counter()
        try:
            buffers = self._make_buffers(d)
            if self.device.type == "cuda" and self.graphed:
                from hpbandster_tpu_torch.ops.graphs import RoundGraph, shape_signature

                def capture():
                    self._out = self._body(*buffers)

                self.graph = RoundGraph(capture, self.device, warmup=True, name=self.name,
                                        signature=shape_signature(*buffers))
        except BaseException as e:
            self._error = e
            raise
        self._buffers = buffers
        self._dim = d
        self.build_s = time.perf_counter() - t0
        self.built_mono = time.monotonic()

    def run(self, d: int, *host_inputs) -> torch.Tensor:
        """Fill the buffers from ``host_inputs`` (numpy, in buffer order;
        one pinned upload), run or replay the program, and return a fresh
        copy of its output, queued on the stream without waiting."""
        with self._lock:
            self._ensure_locked(int(d))
            for buf, src in zip(self._buffers, upload(self.device, *host_inputs)):
                buf.copy_(src)
            if self.graph is not None:
                self.graph.replay()
                out = (tuple(t.clone() for t in self._out)
                       if isinstance(self._out, tuple) else self._out.clone())
            else:
                out = self._body(*self._buffers)
            # counted after the launch, one buffer per input, as the
            # reference counts its dispatches
            note_transfer("h2d", sum(int(np.asarray(a).nbytes) for a in host_inputs),
                          buffers=len(host_inputs))
            return out


#: process-wide runner cache: an (objective, bucket, mesh, device,
#: telemetry flag) combination builds once per process; bounded, so
#: throwaway closures cannot pin graphs forever
_BUCKET_FN_CACHE: LRUCache = LRUCache(maxsize=64)


class _BucketRunner:
    """One bucket's program and its dispatch/unpack plumbing: one CUDA
    graph on a card (built once, lazily on the first dispatch or ahead of
    time by :meth:`ensure_compiled` / :func:`precompile_buckets`), the same
    body eagerly on the CPU. ``device_metrics`` (default
    ``HPB_DEVICE_METRICS``) adds the stages' telemetry to the program and
    publishes each member's decoded record at unpack. ``mesh``/``axis``
    split each stage's evaluation over the config axis (the bucket's
    widths padded by :func:`_mesh_pad`); a mesh whose shards span several
    cards or processes runs the program eagerly, one over a single card
    captures it as before."""

    def __init__(self, eval_fn, bucket: BucketPlan, device=None,
                 device_metrics: Optional[bool] = None, mesh=None, axis: str = "config"):
        from hpbandster_tpu_torch.obs.device_metrics import bin_edges, device_metrics_default
        from hpbandster_tpu_torch.parallel.mesh import single_device

        self.bucket = bucket
        self.mesh = mesh
        self.axis = axis
        self.device_metrics = (device_metrics_default() if device_metrics is None
                               else bool(device_metrics))
        w0, depth = bucket.widths[0], bucket.depth
        edges = bin_edges().astype(np.float32) if self.device_metrics else None
        #: the bin edges on the device, made with the buffers (before any
        #: capture)
        self._edges: Optional[torch.Tensor] = None

        def make_buffers(d):
            dev = self.program.device
            if edges is not None:
                self._edges = torch.as_tensor(edges, device=dev)
            return (torch.zeros((w0, d), dtype=_F32, device=dev),
                    torch.zeros((depth,), dtype=torch.int64, device=dev))

        def body(vectors, counts):
            stages = fused_sh_bracket_bucketed(eval_fn, vectors, counts, bucket, mesh, axis)
            packed = _packed_row(*(torch.cat(x) for x in zip(*stages)))
            if self._edges is None:
                return packed
            tel = bucketed_stage_telemetry(stages, counts, self._edges)
            return (packed, torch.stack([h for h, _ in tel]),
                    torch.stack([c for _, c in tel]))

        self.program = StaticProgram("fused_bucket", device, make_buffers, body,
                                     graphed=single_device(mesh))

    def ensure_compiled(self, d: int) -> None:
        """Build the bucket's program for ``d``-dim vectors (idempotent,
        thread-safe: a background precompile and a dispatch may race)."""
        self.program.ensure(d)

    def dispatch(self, vectors: np.ndarray, counts: Sequence[int]) -> torch.Tensor:
        """Launch one member bracket; returns the packed device tensor
        without waiting (callers launch several brackets before fetching).
        ``vectors`` is ``f32[n0, d]`` (padded here), ``counts`` the
        member's entry-aligned counts (``member_counts_for``)."""
        vectors = np.asarray(vectors, np.float32)
        w0 = self.bucket.widths[0]
        if vectors.shape[0] > w0:
            raise ValueError(f"{vectors.shape[0]} rows do not fit bucket width {w0}")
        counts = np.asarray(counts, np.int32)
        if counts.shape != (self.bucket.depth,):
            raise ValueError(
                f"counts must be i32[{self.bucket.depth}], got {counts.shape}")
        padded = np.zeros((w0, vectors.shape[1]), np.float32)
        padded[: vectors.shape[0]] = vectors
        out = self.program.run(vectors.shape[1], padded, counts)
        if self.device_metrics:
            # the counts ride the handle: unpack decodes the telemetry
            # against the member's true rung layout
            return _TelemetryPacked(out, counts)
        return out

    def unpack(self, packed) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Fetch a dispatch (one transfer, which waits), cut into per-stage
        ``(idx, losses)`` at bucket widths. A telemetry-carrying dispatch
        also fetches its histograms and crash counts and publishes the
        member's decoded ``device_telemetry`` record."""
        if not isinstance(packed, _TelemetryPacked):
            return unpack_flat(fetch_packed(packed), self.bucket.widths)
        (row, hist, crashes), counts = packed
        out = unpack_flat(fetch_packed(row), self.bucket.widths)
        hist, crashes = fetch_telemetry(hist, crashes)
        _publish_member_telemetry(hist, crashes, counts, self.bucket.budgets, out)
        return out

    def run_member(self, vectors: np.ndarray, plan: BracketPlan, entry: int):
        """Dispatch and fetch one member bracket; its true-shape per-stage
        ``(indices, losses)``, as a per-shape fused runner returns them."""
        counts = member_counts_for(self.bucket, plan, entry)
        return slice_member_stages(self.unpack(self.dispatch(vectors, counts)), plan, entry)


def make_bucketed_bracket_fn(eval_fn: Callable, bucket: BucketPlan, mesh=None,
                             axis: str = "config", device=None,
                             device_metrics: Optional[bool] = None) -> _BucketRunner:
    """The process-cached runner of one bucket's program on ``device``
    (``None`` means ``cuda``; with a mesh, its home device), with the
    telemetry flag resolved here (``HPB_DEVICE_METRICS`` by default): it
    changes the program."""
    from hpbandster_tpu_torch.obs.device_metrics import device_metrics_default
    from hpbandster_tpu_torch.parallel.mesh import mesh_device

    dev = resolve_device(device if mesh is None or device is not None
                         else mesh_device(mesh))
    if device_metrics is None:
        device_metrics = device_metrics_default()
    key = (eval_fn, bucket, mesh, axis, dev, bool(device_metrics))
    runner = _BUCKET_FN_CACHE.get(key)
    if runner is None:
        runner = _BucketRunner(eval_fn, bucket, device=dev, device_metrics=device_metrics,
                               mesh=mesh, axis=axis)
        _BUCKET_FN_CACHE[key] = runner
    return runner


class _Precompile:
    """Handle over a (possibly background) build of a bucket set."""

    def __init__(self, runners: List, d: int):
        self._runners = runners
        self._d = int(d)
        self._done = threading.Event()
        self.errors: List[BaseException] = []
        #: monotonic start and end of the build
        self.started_mono: Optional[float] = None
        self.finished_mono: Optional[float] = None

    def _work(self) -> None:
        self.started_mono = time.monotonic()
        try:
            for r in self._runners:
                try:
                    r.ensure_compiled(self._d)
                except Exception as e:  # kept: the runner re-raises at dispatch
                    self.errors.append(e)
        finally:
            self.finished_mono = time.monotonic()
            self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every bucket is built; True when finished."""
        return self._done.wait(timeout)


def precompile_buckets(
    eval_fn: Callable, bucket_set: BucketSet, d: int, mesh=None, axis: str = "config",
    device=None, background: bool = True,
) -> _Precompile:
    """Build every bucket's program (on a card: capture its graph), in a
    daemon thread by default so the build overlaps the optimizer's stage-0
    sampling. Returns a handle whose ``wait()`` blocks until the set is
    ready; dispatching earlier is safe (a runner's lock serializes on its
    build in flight), and a failed build raises at its bucket's next
    dispatch."""
    runners = [make_bucketed_bracket_fn(eval_fn, b, mesh=mesh, axis=axis, device=device)
               for b in bucket_set.buckets]
    return start_precompile(runners, d, background, "bucket-precompile")


def start_precompile(runners: List, d: int, background: bool, name: str) -> _Precompile:
    """Run ``ensure_compiled(d)`` over ``runners`` now or in a daemon
    thread; the handle shared by every precompiling caller."""
    handle = _Precompile(runners, d)
    if background:
        threading.Thread(target=handle._work, daemon=True, name=name).start()
    else:
        handle._work()
    return handle
