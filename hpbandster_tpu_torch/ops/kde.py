"""Mixed-type kernel-density estimation: fit and candidate sampling.

Ported from ``hpbandster_tpu/ops/kde.py``: ``KDE``, ``LOG_PDF_FLOOR``,
``_discrete_bw_cap``, ``normal_reference_bandwidths`` (two-pass variance),
``_truncnorm_unit``, ``sample_around`` and ``generate_candidates``. The
acquisition scorer that consumes these lives in ``ops/cuda_kde.py``.

Random numbers come from an explicit ``torch.Generator``. The sampling math
is split from the draws (``candidates_from_uniforms``), so a test can feed
the reference's own uniforms through the port's arithmetic.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = [
    "KDE",
    "LOG_PDF_FLOOR",
    "normal_reference_bandwidths",
    "sample_around",
    "candidates_from_uniforms",
    "generate_candidates",
]

#: the reference clips pdf values at 1e-32 before the ratio
LOG_PDF_FLOOR = math.log(1e-32)


class KDE(NamedTuple):
    """A fitted mixed-type KDE over unit-hypercube observation vectors.

    ``data`` is ``f32[n, d]`` (no NaNs), ``mask`` is ``f32[n]`` with 1 for
    real observations, ``bw`` is ``f32[d]``.
    """

    data: torch.Tensor
    mask: torch.Tensor
    bw: torch.Tensor


def _discrete_bw_cap(cards: torch.Tensor) -> torch.Tensor:
    """Aitchison–Aitken lambda must stay below (k-1)/k; continuous dims uncapped."""
    cards_f = torch.clamp(cards.to(torch.float32), min=2.0)
    cap = (cards_f - 1.0) / cards_f
    return torch.where(cards > 0, cap, torch.full_like(cap, math.inf))


def normal_reference_bandwidths(
    data: torch.Tensor,
    mask: torch.Tensor,
    cards: torch.Tensor,
    min_bandwidth: float = 1e-3,
) -> torch.Tensor:
    """Per-dim normal-reference rule ``1.06 * sigma_j * n^(-1/(d+4))``
    (statsmodels' constant, population sigma), floored at ``min_bandwidth``
    and capped at the Aitchison–Aitken limit on discrete dims."""
    data = data.to(torch.float32)
    mask = mask.to(torch.float32)
    d = data.shape[-1]
    n = torch.clamp(mask.sum(), min=1.0)
    mean = (data * mask[:, None]).sum(0) / n
    var = (torch.square(data - mean) * mask[:, None]).sum(0) / n
    sigma = torch.sqrt(torch.clamp(var, min=0.0))
    bw = 1.06 * sigma * n ** (-1.0 / (4.0 + d))
    return torch.minimum(torch.clamp(bw, min=min_bandwidth), _discrete_bw_cap(cards.to(data.device)))


def _truncnorm_unit(
    u01: torch.Tensor, mean: torch.Tensor, sd: torch.Tensor
) -> torch.Tensor:
    """Truncated-normal sample on [0, 1] by inverse CDF, from uniforms in
    [0, 1) (scaled into [ndtr(-mean/sd), ndtr((1-mean)/sd)) exactly as a
    bounded ``jax.random.uniform`` scales its draw)."""
    sd = torch.clamp(sd, min=1e-6)
    a = torch.special.ndtr((0.0 - mean) / sd)
    b = torch.special.ndtr((1.0 - mean) / sd)
    u = torch.maximum(a, u01 * (b - a) + a)
    u = torch.clamp(u, 1e-7, 1.0 - 1e-7)
    return torch.clamp(mean + sd * torch.special.ndtri(u), 0.0, 1.0)


def sample_around(
    u_cont: torch.Tensor,
    u_keep: torch.Tensor,
    u_cat: torch.Tensor,
    datum: torch.Tensor,
    bw: torch.Tensor,
    vartypes: torch.Tensor,
    cards: torch.Tensor,
    bandwidth_factor: float = 3.0,
    min_bandwidth: float = 1e-3,
) -> torch.Tensor:
    """BOHB candidates: perturb good observations per dim, batched over rows.

    Continuous dims: truncnorm(mean=datum, sd=bw*bandwidth_factor) on [0,1];
    discrete dims: keep the datum's value w.p. (1-bw), else a uniform choice.
    ``u_*`` are uniforms in [0, 1) of the same shape as ``datum``.
    """
    sd = torch.clamp(bw * bandwidth_factor, min=min_bandwidth)
    cont = _truncnorm_unit(u_cont, datum, sd)
    lam = torch.clamp(bw, 0.0, 1.0 - 1e-7)
    keep = u_keep >= lam
    cards_safe = torch.clamp(cards, min=1)
    rand_choice = u_cat * cards_safe.to(torch.float32)
    rand_choice = torch.minimum(
        torch.clamp(torch.floor(rand_choice), min=0.0),
        (cards_safe - 1).to(torch.float32),
    )
    disc = torch.where(keep, datum, rand_choice)
    return torch.where(vartypes == 0, cont, disc)


def candidates_from_uniforms(
    good: KDE,
    idx: torch.Tensor,
    u_cont: torch.Tensor,
    u_keep: torch.Tensor,
    u_cat: torch.Tensor,
    vartypes: torch.Tensor,
    cards: torch.Tensor,
    bandwidth_factor: float = 3.0,
    min_bandwidth: float = 1e-3,
) -> torch.Tensor:
    """Candidates around the good points ``good.data[idx]``, from the given
    per-candidate uniforms (each ``f32[total, d]``)."""
    return sample_around(
        u_cont, u_keep, u_cat, good.data[idx], good.bw[None, :],
        vartypes[None, :], cards[None, :], bandwidth_factor, min_bandwidth,
    )


def generate_candidates(
    generator: torch.Generator,
    good: KDE,
    vartypes: torch.Tensor,
    cards: torch.Tensor,
    total: int,
    bandwidth_factor: float = 3.0,
    min_bandwidth: float = 1e-3,
) -> torch.Tensor:
    """``total`` perturbed-good-point candidates, ``f32[total, d]``: a donor
    drawn uniformly among the masked-in good points, then
    :func:`sample_around`."""
    dev = good.data.device
    d = good.data.shape[1]
    idx = torch.multinomial(
        (good.mask > 0).to(torch.float32), total, replacement=True,
        generator=generator,
    )
    u = torch.rand((3, total, d), generator=generator, device=dev)
    return candidates_from_uniforms(
        good, idx, u[0], u[1], u[2], vartypes, cards, bandwidth_factor,
        min_bandwidth,
    )
