"""Successive-halving / HyperBand bracket arithmetic (host side, numpy).

Ported from ``hpbandster_tpu/ops/bracket.py``: ``max_sh_iterations``,
``budget_ladder``, ``BracketPlan``, ``hyperband_bracket`` and the host
promotion rule ``sh_promotion_mask_np``. The schedule is plain Python, so
the port keeps it identical; the on-device promotion lives in
``ops/fused.py``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np

__all__ = [
    "max_sh_iterations",
    "budget_ladder",
    "BracketPlan",
    "hyperband_bracket",
    "sh_promotion_mask_np",
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


def sh_promotion_mask_np(losses: np.ndarray, k) -> np.ndarray:
    """The successive-halving promotion rule on the host: NaN (crashed)
    ranks as +inf, stable double-argsort ranking in float32, ``rank < k``."""
    losses = np.asarray(losses, dtype=np.float32)
    clean = np.where(np.isnan(losses), np.float32(np.inf), losses)
    ranks = np.argsort(np.argsort(clean, kind="stable"), kind="stable")
    return ranks < k
