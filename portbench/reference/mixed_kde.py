"""BOHB's model on a space of continuous and unordered categorical dims:
the normal-reference bandwidths capped on categorical dims and the
acquisition score ``log l - log g`` with an Aitchison–Aitken kernel on
them.

The gate, the split and the Gaussian bandwidth rule are ``kde.py``'s,
imported unchanged. What this file adds is a frozen copy of the port's
categorical rules:

* the cap: ``hpbandster_tpu_torch/ops/kde.py::_discrete_bw_cap`` and
  ``normal_reference_bandwidths`` take the Gaussian rule's bandwidth of a
  categorical column of choice indices, floor it at ``min_bandwidth`` and
  cap it at ``(k - 1) / k`` for ``k`` choices;
* the kernel: ``hpbandster_tpu_torch/ops/cuda_kde.py::
  score_candidates_reference`` gives a categorical dim ``1 - bw`` where the
  candidate's choice is the observation's and ``bw / (k - 1)`` where it is
  not, each side's log-density floored at ``log(1e-32)``.

Departures from HpBandSter's model (statsmodels' ``KDEMultivariate`` with
``bw="normal_reference"``, vartype ``u`` on categorical dims), as the port
makes them:

* statsmodels does not cap a categorical bandwidth, so a wide column there
  can give ``bw > (k - 1) / k``, where the kernel prefers another choice
  to the observed one; the cap keeps the observed choice the likeliest;
* HpBandSter takes the ratio of the densities, each floored at 1e-32; this
  takes the difference of their logs, floored at ``log(1e-32)``, which
  orders candidates the same way;
* every discrete dim here is unordered: the port's ordinal kernel
  (Wang–van Ryzin) has no copy, since no configuration of the benchmark
  has an ordinal dim.

Every function computes in the dtype it is handed: float64 for the
reference, bfloat16 for the control.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import kde

LOG_PDF_FLOOR = kde.LOG_PDF_FLOOR
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _cards(cards, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(cards, dtype=torch.float64).to(like.device, like.dtype)


def bandwidths(data: torch.Tensor, cards, min_bandwidth: float) -> torch.Tensor:
    """Per-dimension bandwidths of ``data [n, d]``: ``kde.bandwidths``,
    then on each dim with ``cards[j] = k > 0`` choices at most
    ``(k - 1) / k``."""
    bw = kde.bandwidths(data, min_bandwidth)
    k = _cards(cards, data)
    cap = (k - 1.0) / torch.clamp(k, min=2.0)
    return torch.where(k > 0, torch.minimum(bw, cap), bw)


def _log_density(x: torch.Tensor, data: torch.Tensor, bw: torch.Tensor,
                 k: torch.Tensor) -> torch.Tensor:
    """Mixture log-density of ``x [s, d]`` under ``data [n, d]``: Gaussian
    on continuous dims, Aitchison–Aitken on categorical ones (their values
    are choice indices, matched within 0.5)."""
    diff = x[:, None, :] - data[None, :, :]
    gauss = -0.5 * torch.square(diff / bw) - torch.log(bw) - _LOG_SQRT_2PI
    same = torch.abs(diff) < 0.5
    aa = torch.where(same, torch.log1p(-bw), torch.log(bw) - torch.log(torch.clamp(k - 1.0, min=1.0)))
    ll = torch.where(k > 0, aa, gauss).sum(-1)
    return torch.logsumexp(ll, dim=1) - math.log(data.shape[0])


def scores(cands: torch.Tensor, good: torch.Tensor, bad: torch.Tensor,
           bw_good: torch.Tensor, bw_bad: torch.Tensor, cards,
           block: int = 1024) -> torch.Tensor:
    """``max(log l, F) - max(log g, F)`` of every candidate, in blocks of
    ``block`` candidates so that the pairwise terms fit."""
    k = _cards(cards, cands)
    out = []
    for lo in range(0, cands.shape[0], block):
        x = cands[lo:lo + block]
        lg = torch.clamp(_log_density(x, good, bw_good, k), min=LOG_PDF_FLOOR)
        lb = torch.clamp(_log_density(x, bad, bw_bad, k), min=LOG_PDF_FLOOR)
        out.append(lg - lb)
    return torch.cat(out) if out else cands.new_zeros((0,))
