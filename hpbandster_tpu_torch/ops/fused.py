"""Successive-halving bracket on the device: every stage's evaluation and
promotion without leaving the device.

Ported from ``hpbandster_tpu/ops/fused.py``: ``_CRASH_RANK``,
``stage_telemetry`` (the device half of the metrics plane),
``StatefulEval``, ``fused_sh_bracket`` (the stateless ``eval_fn`` seam or
the ``StatefulEval`` warm-continuation seam, with the default promotion
scores or a ``rank_fn`` over the survivors' loss history), ``_pack_stages``,
``_unpack_stages`` and ``make_fused_bracket_fn`` (one bracket shape's
runner, for the batched executor).

Crashed configs surface as NaN losses and rank behind every clean loss but
ahead of padding rows. Ties keep the lower row index: the reference's
``lax.top_k`` then ``sort`` does, and ties are common here (every crash
ranks at ``_CRASH_RANK``, every pad row at +inf). ``torch.topk`` promises
no tie order, so promotion is a stable sort of the rank keys.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from hpbandster_tpu_torch.device import resolve_device, upload
from hpbandster_tpu_torch.obs.runtime import note_transfer
from hpbandster_tpu_torch.utils.lru import LRUCache

__all__ = ["StatefulEval", "fused_sh_bracket", "make_fused_bracket_fn", "rank_key",
           "stage_telemetry", "tree_leaves", "tree_map"]

#: crashed (NaN) losses map here for ranking: behind any real loss, ahead of
#: the +inf padding rows
_CRASH_RANK = np.float32(3.0e38)

EvalFn = Callable[[torch.Tensor, float], torch.Tensor]
RankFn = Callable[[torch.Tensor, torch.Tensor, float], torch.Tensor]


def rank_key(losses: torch.Tensor, is_pad: torch.Tensor) -> torch.Tensor:
    """Promotion key: the loss, ``_CRASH_RANK`` for NaN, +inf for pad rows."""
    key = torch.where(
        torch.isnan(losses), torch.full_like(losses, float(_CRASH_RANK)), losses
    )
    return torch.where(is_pad, torch.full_like(key, float("inf")), key)


def stage_telemetry(
    losses: torch.Tensor, edges: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rung's telemetry: ``(histogram i32[len(edges) + 1], crash count
    i32[])`` over its losses, ``edges`` being the bin schema's upper bounds
    (``obs.device_metrics.bin_edges``, float32, on the losses' device).

    NaN (crashed) losses are left out of the histogram and counted as
    crashes; +/-inf land in the end bins; a loss equal to an edge lands in
    that edge's bin (``<=`` against the upper bound). Scatter-free, as in
    the reference: a cumulative ``count(loss <= edge)`` over the losses,
    then differenced, so the output's shape depends on the bins alone."""
    losses = losses.to(torch.float32)
    crashed = torch.isnan(losses)
    w = (~crashed).to(torch.int32)
    le = (losses[:, None] <= edges[None, :]).to(torch.int32) * w[:, None]
    cum = le.sum(0, dtype=torch.int32)  # finite losses at or below each edge
    total = w.sum(dtype=torch.int32)
    hist = torch.cat([cum[:1], torch.diff(cum), (total - cum[-1])[None]])
    return hist, crashed.sum(dtype=torch.int32)


class StatefulEval(NamedTuple):
    """Stateful-evaluation seam beside ``eval_fn``: training whose live
    state threads through the rung ladder, so promoted configs continue
    training instead of restarting.

    ``init_fn(vectors f32[n, d]) -> state`` builds one lane per row: a
    tensor, or a dict, tuple or list of them (nested), every leaf with a
    leading axis of size ``n``. ``step_fn(state, vectors f32[k, d], budget,
    prev_budget) -> (state, losses f32[k])`` trains each lane from budget
    ``prev_budget`` to ``budget`` (Python floats) and returns the lanes'
    losses; a diverged lane reports NaN and must not touch the others.
    The bracket gathers the surviving lanes with the indices the rung
    promoted (:func:`tree_map` of ``leaf[top]``)."""

    init_fn: Callable[[torch.Tensor], Any]
    step_fn: Callable[[Any, torch.Tensor, float, float], Tuple[Any, torch.Tensor]]


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """``fn`` applied to every tensor leaf of a (nested) dict, tuple, named
    tuple or list, keeping the structure."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of a (nested) dict, tuple, named tuple or list, in
    :func:`tree_map`'s order."""
    out: List[torch.Tensor] = []
    tree_map(lambda t: out.append(t) or t, tree)
    return out


def _eval_stage(eval_fn: EvalFn, vecs: torch.Tensor, budget: float) -> torch.Tensor:
    losses = eval_fn(vecs, budget)
    if losses.shape != (vecs.shape[0],):
        raise ValueError(
            f"eval_fn must return one loss per row, f32[{vecs.shape[0]}], "
            f"got shape {tuple(losses.shape)}"
        )
    return losses.to(torch.float32)


def fused_sh_bracket(
    eval_fn: Optional[EvalFn],
    vectors: torch.Tensor,
    num_configs: Sequence[int],
    budgets: Sequence[float],
    rank_fn: Optional[RankFn] = None,
    stateful: Optional[StatefulEval] = None,
    return_final_state: bool = False,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Run one whole bracket. Returns per-stage ``(indices, losses)`` where
    ``indices`` (int64) index the original stage-0 rows.

    ``eval_fn(vectors f32[n, d], budget) -> f32[n]`` is batched; the budget
    is a Python float. ``vectors`` may carry padding rows beyond
    ``num_configs[0]``: they are evaluated but never promoted.

    ``stateful`` (a :class:`StatefulEval`, exclusive with ``eval_fn``)
    trains instead: stage 0 runs ``init_fn`` then ``step_fn(state, vecs,
    budgets[0], 0.0)``; stage ``s`` gathers the surviving lanes by the
    promotion's indices and runs ``step_fn(state, vecs, budgets[s],
    budgets[s-1])``. ``return_final_state=True`` returns ``(stages,
    state)``, the last stage's surviving lanes.

    ``rank_fn(budgets_so_far f32[s+1], history f32[n_cur, s+1],
    final_budget) -> scores f32[n_cur]`` replaces the promotion scores after
    stage ``s >= 1`` (lower is better). Default: the current stage's loss,
    plain successive halving. Where a score is NaN (an earlier stage
    crashed) the current loss stands in; a crash in the current stage
    ranks as a crash whatever the score.
    """
    if (eval_fn is None) == (stateful is None):
        raise ValueError(
            "provide exactly one evaluation seam: eval_fn (stateless) or "
            "stateful (StatefulEval warm continuation)"
        )
    if return_final_state and stateful is None:
        raise ValueError("return_final_state=True requires stateful")
    n0 = int(num_configs[0])
    n_rows = vectors.shape[0]
    if n_rows < n0:
        raise ValueError(f"need >= {n0} stage-0 vectors, got {n_rows}")
    dev = vectors.device
    # filled on the device, not copied from the host: no synchronising upload
    budgets_dev = [torch.full((1,), float(b), dtype=torch.float32, device=dev)
                   for b in budgets] if rank_fn is not None else []

    def scores_for(history: List[torch.Tensor], s: int) -> torch.Tensor:
        """Promotion scores after stage ``s`` from the survivors' loss
        history; crashed (NaN-loss) configs stay NaN."""
        current = history[-1]
        if rank_fn is None or s == 0:
            return current
        scores = rank_fn(torch.cat(budgets_dev[: s + 1]),
                         torch.stack(history, dim=1), float(budgets[-1]))
        scores = torch.where(torch.isnan(scores), current, scores)
        return torch.where(torch.isnan(current), current, scores)

    state = None
    if stateful is not None:
        # one lane per row, padding rows included (never promoted)
        state, losses = stateful.step_fn(
            stateful.init_fn(vectors), vectors, float(budgets[0]), 0.0
        )
        losses = losses.to(torch.float32)
    else:
        losses = _eval_stage(eval_fn, vectors, float(budgets[0]))
    cur_idx = torch.arange(n_rows, device=dev)
    history = [losses]  # per-stage losses of the current survivors
    cur_key = rank_key(scores_for(history, 0), cur_idx >= n0)
    out = [(torch.arange(n0, device=dev), losses[:n0])]
    for s in range(1, len(num_configs)):
        k = int(num_configs[s])
        top = torch.sort(cur_key, stable=True).indices[:k]
        top = torch.sort(top).values  # keep original order among survivors
        cur_idx = cur_idx[top]
        if stateful is not None:
            # warm continuation: the surviving lanes, by the same indices
            # the rank promoted, train the budget increment only
            state, losses = stateful.step_fn(
                tree_map(lambda leaf: leaf[top], state), vectors[cur_idx],
                float(budgets[s]), float(budgets[s - 1]),
            )
            losses = losses.to(torch.float32)
        else:
            losses = _eval_stage(eval_fn, vectors[cur_idx], float(budgets[s]))
        history = ([col[top] for col in history] if rank_fn is not None else []) + [losses]
        if s + 1 < len(num_configs):
            cur_key = rank_key(scores_for(history, s),
                               torch.zeros_like(cur_idx, dtype=torch.bool))
        out.append((cur_idx, losses))
    if return_final_state:
        return out, state
    return out


def _pack_stages(stages) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concatenate per-stage ``(idx, losses)`` into two flat tensors."""
    return (
        torch.cat([s[0] for s in stages]),
        torch.cat([s[1] for s in stages]),
    )


def _unpack_stages(packed, num_configs) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-stage ``(idx, losses)`` numpy slices of fetched packed arrays."""
    idx_flat, loss_flat = (np.asarray(p) for p in packed)
    out, off = [], 0
    for k in num_configs:
        out.append((idx_flat[off:off + k], loss_flat[off:off + k]))
        off += k
    return out


#: process-wide runner cache: executors come and go, but an (objective,
#: bracket shape, device) combination builds once. Bounded, so throwaway
#: closures cannot pin their datasets forever.
_FUSED_FN_CACHE = LRUCache(maxsize=64)


def make_fused_bracket_fn(
    eval_fn: EvalFn,
    num_configs: Sequence[int],
    budgets: Sequence[float],
    mesh=None,
    device=None,
):
    """A runner for one bracket shape: ``fn(vectors f32[n0, d]) ->
    [(indices, losses), ...]`` as numpy, every stage and promotion on
    ``device`` (``None`` means ``cuda``).

    ``fn.dispatch(vectors)`` uploads the vectors and launches the whole
    bracket without waiting for it, returning the packed stages as one
    device tensor; ``fn.fetch(packed)`` brings them to the host (one
    transfer, which synchronises), so a caller can launch several brackets
    before fetching any. Runners are cached per ``(eval_fn, num_configs,
    budgets, device)``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "make_fused_bracket_fn(mesh=...) is not ported yet (ROADMAP A7: "
            "multi-GPU)")
    dev = resolve_device(device)
    num_configs = tuple(int(n) for n in num_configs)
    budgets = tuple(float(b) for b in budgets)
    cache_key = (eval_fn, num_configs, budgets, dev)
    cached = _FUSED_FN_CACHE.get(cache_key)
    if cached is not None:
        return cached

    def dispatch(vectors) -> torch.Tensor:
        vectors = np.asarray(vectors, np.float32)
        note_transfer("h2d", vectors.nbytes)
        (v,) = upload(dev, vectors)
        idx, losses = _pack_stages(fused_sh_bracket(eval_fn, v, num_configs, budgets))
        # one tensor, one transfer at the fetch (indices are exact in f32)
        return torch.cat([idx.to(torch.float32), losses])

    def fetch(packed: torch.Tensor):
        flat = packed.cpu().numpy()
        # the reference fetches the (idx, loss) pair: two buffers
        note_transfer("d2h", flat.nbytes, buffers=2)
        total = len(flat) // 2
        return _unpack_stages((flat[:total].astype(np.int64), flat[total:]), num_configs)

    def runner(vectors):
        return fetch(dispatch(vectors))

    runner.dispatch = dispatch
    runner.fetch = fetch
    _FUSED_FN_CACHE[cache_key] = runner
    return runner
