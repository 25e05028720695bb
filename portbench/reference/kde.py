"""BOHB's model: the budget it fits at, the good/bad split, the
normal-reference bandwidths and the acquisition score ``log l - log g``.

Frozen copies of the port's rules, continuous dimensions only (the
benchmark's spaces have no others):

* the gate and the split: ``hpbandster_tpu_torch/ops/sweep.py``
  (``trained_split``, ``dynamic_gate``) and ``models/bohb_kde.py``
  (``_trained_split``, ``_fit_kde_pair``): a budget's model exists once it
  holds ``min_points + 2`` observations and both sides exceed the dimension;
  the good side is the ``n_good`` lowest losses, the bad side the ``n_bad``
  highest (a stable sort, crashes as ``+inf``); proposals use the largest
  budget with a model;
* the bandwidths: ``ops/kde.py::normal_reference_bandwidths``,
  ``1.06 sigma n^(-1/(d+4))`` with the population sigma, floored at
  ``min_bandwidth``;
* the score: ``ops/cuda_kde.py::score_candidates_reference``, a masked
  Gaussian mixture per side, each side's log-density floored at
  ``log(1e-32)``.

Every function computes in the dtype it is handed: float64 for the
reference, bfloat16 for the control.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

LOG_PDF_FLOOR = math.log(1e-32)
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def split_sizes(n: int, d: int, min_points: int,
                top_n_percent: int) -> Optional[Tuple[int, int]]:
    """``(n_good, n_bad)`` of a budget holding ``n`` observations, or None
    while its model's gate is closed."""
    if n < min_points + 2:
        return None
    n_good = max(min_points, (top_n_percent * n) // 100)
    n_bad = max(min_points, ((100 - top_n_percent) * n) // 100)
    if n_good <= d or n_bad <= d:
        return None
    return n_good, n_bad


def model_budget(counts: Dict[float, int], d: int, min_points: int,
                 top_n_percent: int) -> Optional[float]:
    """The largest budget whose gate is open, or None."""
    open_ = [b for b, n in counts.items()
             if split_sizes(n, d, min_points, top_n_percent) is not None]
    return max(open_) if open_ else None


def split(vectors: np.ndarray, losses: np.ndarray, d: int, min_points: int,
          top_n_percent: int) -> Tuple[np.ndarray, np.ndarray]:
    """The good and the bad observations of one budget."""
    n = len(losses)
    n_good, n_bad = split_sizes(n, d, min_points, top_n_percent)
    key = np.where(np.isnan(losses), np.inf, losses)
    order = np.argsort(key, kind="stable")
    return vectors[order[:n_good]], vectors[order[n - n_bad:]]


def bandwidths(data: torch.Tensor, min_bandwidth: float) -> torch.Tensor:
    """Per-dimension normal-reference bandwidths of ``data [n, d]``."""
    n, d = data.shape
    sigma = data.std(dim=0, unbiased=False)
    bw = 1.06 * sigma * float(n) ** (-1.0 / (4.0 + d))
    return torch.clamp(bw, min=min_bandwidth)


def _log_density(x: torch.Tensor, data: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """Mixture log-density of ``x [s, d]`` under ``data [n, d]``."""
    bw = torch.clamp(bw, min=1e-10)
    z = (x[:, None, :] - data[None, :, :]) / bw
    ll = (-0.5 * torch.square(z) - torch.log(bw) - _LOG_SQRT_2PI).sum(-1)
    return torch.logsumexp(ll, dim=1) - math.log(data.shape[0])


def scores(cands: torch.Tensor, good: torch.Tensor, bad: torch.Tensor,
           bw_good: torch.Tensor, bw_bad: torch.Tensor,
           block: int = 2048) -> torch.Tensor:
    """``max(log l, F) - max(log g, F)`` of every candidate, in blocks of
    ``block`` candidates so that the pairwise terms fit."""
    out = []
    for lo in range(0, cands.shape[0], block):
        x = cands[lo:lo + block]
        lg = torch.clamp(_log_density(x, good, bw_good), min=LOG_PDF_FLOOR)
        lb = torch.clamp(_log_density(x, bad, bw_bad), min=LOG_PDF_FLOOR)
        out.append(lg - lb)
    return torch.cat(out) if out else cands.new_zeros((0,))
