"""Successive-halving / HyperBand bracket arithmetic (host side, numpy).

Ported from ``hpbandster_tpu/ops/bracket.py``: ``max_sh_iterations``,
``budget_ladder``, ``BracketPlan``, ``hyperband_bracket``,
``hyperband_schedule``, the promotion rule on the tensor's device
(``sh_promotion_mask``, ``sh_promotion_mask_compiled``), its host twin
``sh_promotion_mask_np``, the resampling variant ``sh_resample_mask`` and
``power_law_extrapolate`` (the H2BO promotion score, in tensor ops). The
schedule is plain Python, so the port keeps it identical; the fused
bracket's own promotion lives in ``ops/fused.py``.

Every promotion rule ranks NaN (crashed) as +inf and breaks ties by the
lower index: a stable sort, as ``jnp.argsort`` is.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = [
    "max_sh_iterations",
    "budget_ladder",
    "BracketPlan",
    "hyperband_bracket",
    "hyperband_schedule",
    "sh_promotion_mask",
    "sh_promotion_mask_compiled",
    "sh_promotion_mask_np",
    "sh_resample_mask",
    "power_law_extrapolate",
]


def max_sh_iterations(min_budget: float, max_budget: float, eta: float) -> int:
    """Number of distinct successive-halving bracket shapes:
    ``floor(log(max/min)/log(eta)) + 1``."""
    if not (max_budget > 0 and min_budget > 0 and max_budget >= min_budget):
        raise ValueError(f"need 0 < min_budget <= max_budget, got [{min_budget}, {max_budget}]")
    if eta <= 1:
        raise ValueError(f"need eta > 1, got {eta}")
    # epsilon-robust floor: log(243)/log(3) = 4.999999999999999 in f64, and a
    # bare floor would silently drop the lowest rung of an exact ladder
    ratio = np.log(max_budget / min_budget) / np.log(eta)
    return int(np.floor(ratio + 1e-9)) + 1


def budget_ladder(min_budget: float, max_budget: float, eta: float) -> np.ndarray:
    """Ascending geometric budget ladder ending exactly at ``max_budget``."""
    k = max_sh_iterations(min_budget, max_budget, eta)
    return max_budget * np.power(float(eta), -np.arange(k - 1, -1, -1, dtype=np.float64))


class BracketPlan(NamedTuple):
    """Static description of one successive-halving bracket."""

    #: configs alive at each stage, e.g. [9, 3, 1]
    num_configs: Tuple[int, ...]
    #: budget evaluated at each stage (same length)
    budgets: Tuple[float, ...]

    @property
    def n_stages(self) -> int:
        return len(self.num_configs)

    @property
    def total_evaluations(self) -> int:
        return int(sum(self.num_configs))


def hyperband_bracket(
    iteration_index: int, min_budget: float, max_budget: float, eta: float
) -> BracketPlan:
    """The bracket HyperBand runs at global iteration ``iteration_index``:
    ``s = max_SH_iter - 1 - (i % max_SH_iter)``,
    ``n0 = ceil(max_SH_iter / (s+1) * eta**s)``,
    ``ns = [max(floor(n0 * eta**(-j)), 1) for j in 0..s]``, on the last
    ``s+1`` rungs of the ladder."""
    k = max_sh_iterations(min_budget, max_budget, eta)
    ladder = budget_ladder(min_budget, max_budget, eta)
    s = k - 1 - (iteration_index % k)
    n0 = int(math.ceil((k / (s + 1)) * eta**s))
    ns = tuple(max(int(n0 * eta ** (-j)), 1) for j in range(s + 1))
    budgets = tuple(float(b) for b in ladder[-(s + 1):])
    return BracketPlan(num_configs=ns, budgets=budgets)


def hyperband_schedule(
    n_iterations: int, min_budget: float, max_budget: float, eta: float
) -> Tuple[BracketPlan, ...]:
    """Plans for ``n_iterations`` consecutive HyperBand iterations."""
    return tuple(
        hyperband_bracket(i, min_budget, max_budget, eta) for i in range(n_iterations)
    )


def sh_promotion_mask(losses: torch.Tensor, k) -> torch.Tensor:
    """The successive-halving promotion rule on the losses' device:
    ``losses f32[n]`` (NaN = crashed) -> ``bool[n]`` marking the ``k`` best.
    NaN ranks as +inf; ``ranks = argsort(argsort(clean))`` with stable
    sorts, so ties go to the lower index. ``k`` is an int or a 0-dim
    tensor; leading batch dims rank independently."""
    losses = torch.as_tensor(losses)
    clean = torch.where(torch.isnan(losses), torch.full_like(losses, math.inf), losses)
    order = torch.argsort(clean, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return ranks < k


def sh_promotion_mask_compiled():
    """The reference's compiled promotion kernel: there is nothing to
    compile here, so the rule itself, one callable for every width."""
    return sh_promotion_mask


def sh_resample_mask(
    losses: torch.Tensor, k, resampling_rate: float, generator=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SuccessiveResampling's rule: promote only ``max(ceil(k * (1 -
    resampling_rate)), 1)`` survivors; the caller fills the rest of the next
    stage with fresh samples. Returns ``(promote_mask, n_resampled)``, the
    count an int32 0-dim tensor. The selection is deterministic; the
    generator is accepted in the reference's key position and unused."""
    del generator
    losses = torch.as_tensor(losses)
    if isinstance(k, torch.Tensor):
        prod = k.to(torch.float32) * (1.0 - resampling_rate)
        k_i = k.to(torch.int32)
    else:
        # the product in float64 rounded once to float32, as the reference's
        # Python-number product reaches jnp.ceil
        prod = torch.tensor(np.float32(k * (1.0 - resampling_rate)), device=losses.device)
        k_i = torch.tensor(int(k), dtype=torch.int32, device=losses.device)
    n_promote = torch.clamp(torch.ceil(prod).to(torch.int32), min=1)
    return sh_promotion_mask(losses, n_promote), k_i - n_promote


def sh_promotion_mask_np(losses: np.ndarray, k) -> np.ndarray:
    """The successive-halving promotion rule on the host: NaN (crashed)
    ranks as +inf, stable double-argsort ranking in float32, ``rank < k``."""
    losses = np.asarray(losses, dtype=np.float32)
    clean = np.where(np.isnan(losses), np.float32(np.inf), losses)
    ranks = np.argsort(np.argsort(clean, kind="stable"), kind="stable")
    return ranks < k


def power_law_extrapolate(
    budgets: torch.Tensor, losses: torch.Tensor, target_budget: float,
    floor: float = 1e-6,
) -> torch.Tensor:
    """Each config's power-law learning curve extrapolated to
    ``target_budget``: ``budgets f32[s]`` (ascending), ``losses f32[n, s]``
    -> ``f32[n]``. The twin of the host ``PowerLawModel.predict``, fitted as
    ``loss = c + exp(intercept) * budget^slope`` by least squares in log
    space.

    Fewer than 3 points, a non-positive residual, an all-increasing curve
    or a positive slope fall back to the last observed loss. The on-device
    H2BO promotion (``FusedH2BO``) ranks by these scores."""
    losses = losses.to(torch.float32)
    last = losses[:, -1]
    if losses.shape[1] < 3:
        return last

    y0, y1, y2 = losses[:, -3], losses[:, -2], losses[:, -1]
    denom = y0 + y2 - 2.0 * y1
    c_est = torch.where(
        torch.abs(denom) > 1e-12, (y0 * y2 - y1 * y1) / denom,
        torch.full_like(denom, -math.inf),
    )
    ymin = losses.min(dim=1).values
    # scale-aware floor: a fixed 1e-12 is not representable next to
    # float32 values of order 1
    floor_eff = torch.clamp(torch.abs(ymin) * 1e-5, min=floor)
    c = torch.where(
        torch.isfinite(c_est), torch.minimum(c_est, ymin - floor_eff), ymin - floor_eff
    )
    resid = losses - c[:, None]
    bad = (resid <= 0).any(dim=1) | (torch.diff(losses, dim=1) > 0).all(dim=1)

    log_b = torch.log(budgets.to(torch.float32))[None, :]
    log_r = torch.log(torch.clamp(resid, min=1e-30))
    mb = log_b.mean(dim=1)
    mr = log_r.mean(dim=1)
    cov = ((log_b - mb[:, None]) * (log_r - mr[:, None])).mean(dim=1)
    var = torch.clamp(((log_b - mb[:, None]) ** 2).mean(dim=1), min=1e-30)
    slope = cov / var
    intercept = mr - slope * mb
    bad = bad | (slope > 0)
    # the target's log in float32 on the host: a Python number, no upload
    log_t = float(np.log(np.float32(target_budget)))
    pred = c + torch.exp(intercept + slope * log_t)
    return torch.where(bad, last, pred)
