"""Successive-halving bracket on the device: every stage's evaluation and
promotion without leaving the device.

Ported from ``hpbandster_tpu/ops/fused.py``: ``_CRASH_RANK``,
``fused_sh_bracket`` (the stateless ``eval_fn`` seam, with the default
promotion scores or a ``rank_fn`` over the survivors' loss history) and
``_pack_stages``.

Crashed configs surface as NaN losses and rank behind every clean loss but
ahead of padding rows. Ties keep the lower row index: the reference's
``lax.top_k`` then ``sort`` does, and ties are common here (every crash
ranks at ``_CRASH_RANK``, every pad row at +inf). ``torch.topk`` promises
no tie order, so promotion is a stable sort of the rank keys.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["fused_sh_bracket", "rank_key"]

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


def _eval_stage(eval_fn: EvalFn, vecs: torch.Tensor, budget: float) -> torch.Tensor:
    losses = eval_fn(vecs, budget)
    if losses.shape != (vecs.shape[0],):
        raise ValueError(
            f"eval_fn must return one loss per row, f32[{vecs.shape[0]}], "
            f"got shape {tuple(losses.shape)}"
        )
    return losses.to(torch.float32)


def fused_sh_bracket(
    eval_fn: EvalFn,
    vectors: torch.Tensor,
    num_configs: Sequence[int],
    budgets: Sequence[float],
    rank_fn: Optional[RankFn] = None,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Run one whole bracket. Returns per-stage ``(indices, losses)`` where
    ``indices`` (int64) index the original stage-0 rows.

    ``eval_fn(vectors f32[n, d], budget) -> f32[n]`` is batched; the budget
    is a Python float. ``vectors`` may carry padding rows beyond
    ``num_configs[0]``: they are evaluated but never promoted.

    ``rank_fn(budgets_so_far f32[s+1], history f32[n_cur, s+1],
    final_budget) -> scores f32[n_cur]`` replaces the promotion scores after
    stage ``s >= 1`` (lower is better). Default: the current stage's loss,
    plain successive halving. Where a score is NaN (an earlier stage
    crashed) the current loss stands in; a crash in the current stage
    ranks as a crash whatever the score.
    """
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
        losses = _eval_stage(eval_fn, vectors[cur_idx], float(budgets[s]))
        history = ([col[top] for col in history] if rank_fn is not None else []) + [losses]
        if s + 1 < len(num_configs):
            cur_key = rank_key(scores_for(history, s),
                               torch.zeros_like(cur_idx, dtype=torch.bool))
        out.append((cur_idx, losses))
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
