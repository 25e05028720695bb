"""HyperBand's bracket schedule and successive halving's top-k promotion.

Frozen copies of ``hpbandster_tpu_torch/ops/bracket.py``
(``max_sh_iterations``, ``budget_ladder``, ``hyperband_bracket``) and of
the promotion rule of ``hpbandster_tpu_torch/ops/fused.py`` and
``core/successive_halving.py`` (the ``k`` lowest losses of a rung go on,
crashes last).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np


def max_sh_iterations(min_budget: float, max_budget: float, eta: float) -> int:
    ratio = np.log(max_budget / min_budget) / np.log(eta)
    return int(np.floor(ratio + 1e-9)) + 1


def budget_ladder(min_budget: float, max_budget: float, eta: float) -> np.ndarray:
    k = max_sh_iterations(min_budget, max_budget, eta)
    return max_budget * np.power(float(eta), -np.arange(k - 1, -1, -1, dtype=np.float64))


def bracket(i: int, min_budget: float, max_budget: float,
            eta: float) -> Tuple[Tuple[int, ...], Tuple[float, ...]]:
    """``(configs per rung, budget per rung)`` of HyperBand's bracket ``i``."""
    k = max_sh_iterations(min_budget, max_budget, eta)
    ladder = budget_ladder(min_budget, max_budget, eta)
    s = k - 1 - (i % k)
    n0 = int(math.ceil((k / (s + 1)) * eta**s))
    ns = tuple(max(int(n0 * eta ** (-j)), 1) for j in range(s + 1))
    return ns, tuple(float(b) for b in ladder[-(s + 1):])


def promoted(losses: Dict[int, float], k: int) -> set:
    """The ``k`` configurations of a rung that go on: lowest loss first,
    NaN (a crash) behind every loss, ties in configuration order."""
    order = sorted(losses, key=lambda c: (math.isnan(losses[c]), losses[c], c))
    return set(order[:k])


def schedule_counts(n_iterations: int, min_budget: float, max_budget: float,
                    eta: float) -> List[Dict[float, int]]:
    """Runs per budget of each of the first ``n_iterations`` brackets."""
    out = []
    for i in range(n_iterations):
        ns, bs = bracket(i, min_budget, max_budget, eta)
        out.append(dict(zip(bs, ns)))
    return out


def total_evaluations(brackets: Sequence[int], min_budget: float,
                      max_budget: float, eta: float) -> int:
    return sum(sum(bracket(i, min_budget, max_budget, eta)[0]) for i in brackets)
