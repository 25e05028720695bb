"""Mixed-type kernel-density estimation: fit and candidate sampling.

Ported from ``hpbandster_tpu/ops/kde.py``: ``KDE``, ``LOG_PDF_FLOOR``,
``_discrete_bw_cap``, ``normal_reference_bandwidths`` (two-pass variance),
``_per_dim_log_kernels`` and ``kde_logpdf`` (the reference's XLA log-density,
kept as a plain version for the tests), ``_truncnorm_unit``,
``sample_around``, ``generate_candidates``, the ``HPB_PALLAS_KDE_FIT`` flag
reader, ``impute_conditional_masked``, ``fit_kde_pair_masked`` (the
traced-count fit of the dynamic-count tier) and the per-bracket path's
proposal half: ``propose``, ``propose_batch``, ``generate_candidates_seeded``,
``propose_batch_seeded_scored``, ``propose_batch_seeded`` and
``refit_propose_batch_seeded``. The acquisition scorer and the masked-moment
bandwidth kernel live in ``ops/cuda_kde.py``; every proposal here scores
through it (``kde_score.cu`` on a card), never through ``kde_logpdf``.

Random numbers come from an explicit ``torch.Generator``. The sampling math
is split from the draws (``candidates_from_uniforms``), so a test can feed
the reference's own uniforms through the port's arithmetic; the seeded
proposal functions take their candidates and imputation uniforms from a
draw source (:class:`SeededDraws` by default), so a test can feed the
reference's own candidates.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Tuple

import torch

__all__ = [
    "KDE",
    "LOG_PDF_FLOOR",
    "normal_reference_bandwidths",
    "kde_logpdf",
    "sample_around",
    "candidates_from_uniforms",
    "generate_candidates",
    "impute_conditional_masked",
    "fit_kde_pair_masked",
    "SeededDraws",
    "per_proposal_candidates",
    "propose",
    "propose_batch",
    "generate_candidates_seeded",
    "propose_batch_seeded_scored",
    "propose_batch_seeded",
    "refit_pair",
    "refit_propose_batch_seeded",
]

#: the reference clips pdf values at 1e-32 before the ratio
LOG_PDF_FLOOR = math.log(1e-32)

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


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


def _per_dim_log_kernels(
    x: torch.Tensor,
    data: torch.Tensor,
    bw: torch.Tensor,
    vartypes: torch.Tensor,
    cards: torch.Tensor,
) -> torch.Tensor:
    """Log kernel value of each (point, datum, dim): ``x f32[..., d]``
    against ``data f32[N, d]`` gives ``f32[..., N, d]``.

    Vartype codes: 0 continuous (Gaussian), 1 unordered
    (Aitchison–Aitken), 2 ordered (Wang–van Ryzin); the reference's XLA form,
    where a discrete match is ``|diff| < 0.5`` and any code other than 0
    and 1 takes the ordinal kernel.
    """
    diff = x[..., None, :] - data
    bw = torch.clamp(bw, min=1e-10)
    log_c = -0.5 * torch.square(diff / bw) - torch.log(bw) - _LOG_SQRT_2PI
    same = torch.abs(diff) < 0.5  # discrete dims hold integer codes
    lam = torch.clamp(bw, 1e-10, 1.0 - 1e-7)
    km1 = torch.clamp(cards.to(torch.float32) - 1.0, min=1.0)
    l1m = torch.log1p(-lam)
    log_u = torch.where(same, l1m, torch.log(lam) - torch.log(km1))
    log_o = torch.where(
        same, l1m, math.log(0.5) + l1m + torch.abs(diff) * torch.log(lam)
    )
    return torch.where(vartypes == 0, log_c, torch.where(vartypes == 1, log_u, log_o))


def kde_logpdf(
    x: torch.Tensor, kde: KDE, vartypes: torch.Tensor, cards: torch.Tensor
) -> torch.Tensor:
    """Mixture log-density of points ``x f32[..., d]`` under the
    product-kernel KDE, ``f32[...]``: the plain version the tests hold the
    proposal path against."""
    per_datum = _per_dim_log_kernels(x, kde.data, kde.bw, vartypes, cards).sum(-1)
    log_w = torch.where(kde.mask > 0, 0.0, -math.inf)
    n = torch.clamp(kde.mask.sum(), min=1.0)
    return torch.logsumexp(per_datum + log_w, dim=-1) - torch.log(n)


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


def _masked_donors(mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Row indices drawn uniformly among the masked-in rows of ``mask``
    (``f32[n]``), one per uniform in ``u``: the inverse CDF of the mask's
    running count. With no row masked in every index is ``n - 1``, a finite
    row, so a fit on empty buffers still samples (its picks are discarded
    downstream) and nothing waits on the host."""
    live = (mask > 0).to(torch.int64)
    cum = torch.cumsum(live, 0)
    total = cum[-1:]
    r = torch.minimum(
        torch.floor(u * total.to(u.dtype)).to(torch.int64),
        torch.clamp(total - 1, min=0),
    ) + 1
    idx = torch.searchsorted(cum, r, side="left")
    return torch.clamp(idx, max=mask.shape[0] - 1)


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
    drawn uniformly among the masked-in good points (:func:`_masked_donors`),
    then :func:`sample_around`."""
    dev = good.data.device
    d = good.data.shape[1]
    idx = _masked_donors(
        good.mask, torch.rand(total, generator=generator, device=dev)
    )
    u = torch.rand((3, total, d), generator=generator, device=dev)
    return candidates_from_uniforms(
        good, idx, u[0], u[1], u[2], vartypes, cards, bandwidth_factor,
        min_bandwidth,
    )


def _moments_fit_requested() -> Optional[bool]:
    """Tri-state ``HPB_PALLAS_KDE_FIT`` flag, read as the reference's
    ``_pallas_fit_requested`` reads it: ``"1"`` computes the fit's
    bandwidths through the masked-moment kernel (``ops/cuda_kde.py``),
    ``"0"`` through the two-pass :func:`normal_reference_bandwidths`, unset
    defers to the caller's argument (default: two-pass)."""
    env = os.environ.get("HPB_PALLAS_KDE_FIT", "")
    if env in ("0", "1"):
        return env == "1"
    return None


def impute_conditional_masked(
    data: torch.Tensor, cards: torch.Tensor, u: torch.Tensor, u_fb: torch.Tensor
) -> torch.Tensor:
    """Donor imputation of conditional data (the host model's
    ``impute_conditional_data``): every NaN (inactive) entry of ``data
    f32[n, d]`` takes the value of a uniformly random *active* row of its
    column, and a column with no active row takes a random category
    (discrete) or a uniform value (continuous).

    Donors come by inverse CDF over each column's running active count
    (``searchsorted`` per column, no ``n x n`` matrix). ``u`` and ``u_fb``
    (``f32[n, d]`` in [0, 1)) are the donor and fallback draws, handed in by
    the caller's draw source."""
    n = data.shape[0]
    isnan = torch.isnan(data)
    cnt = torch.cumsum((~isnan).to(torch.int32), 0, dtype=torch.int32)
    total = cnt[-1]  # [d]
    # the r-th donor (1-indexed) of each entry; searchsorted over the
    # column's non-decreasing count finds its row
    r = torch.floor(u * torch.clamp(total, min=1).to(u.dtype)[None, :]).to(torch.int32) + 1
    rows = torch.searchsorted(cnt.T.contiguous(), r.T.contiguous(), side="left").T
    donated = torch.gather(data, 0, torch.clamp(rows, 0, n - 1))

    cards_f = torch.clamp(cards.to(torch.float32), min=1.0)
    disc = torch.minimum(torch.clamp(torch.floor(u_fb * cards_f), min=0.0), cards_f - 1.0)
    fallback = torch.where(cards[None, :] > 0, disc, u_fb)
    fill = torch.where((total > 0)[None, :], donated, fallback)
    return torch.where(isnan, fill, data)


def fit_kde_pair_masked(
    vecs: torch.Tensor,
    losses: torch.Tensor,
    count: torch.Tensor,
    n_good: torch.Tensor,
    n_bad: torch.Tensor,
    cards: torch.Tensor,
    min_bandwidth: float,
    impute_draws=None,
    use_moments_kernel: Optional[bool] = None,
) -> Tuple[KDE, KDE]:
    """Good/bad KDE fit over a full-capacity buffer, with device counts.

    ``vecs``/``losses`` are full-capacity buffers (``f32[C, d]`` /
    ``f32[C]``, empty slots carrying ``+inf`` loss); ``count``, ``n_good``
    and ``n_bad`` are int32 scalar tensors. A stable sort puts the +inf pads
    (and crashes) last in index order; split membership is a rank mask over
    the sorted buffer (``rank < n_good``, ``count - n_bad <= rank <
    count``), and both KDEs keep all ``C`` rows, mask-weighted. Nothing here
    reads a count on the host.

    ``impute_draws`` (conditional spaces: the good and the bad side's
    ``(u, u_fb)`` uniforms, each ``f32[C, d]``) donor-imputes each side with
    its non-members set to NaN, so they neither donate nor constrain; every
    NaN is filled before a bandwidth or the scorer sees the data.

    ``use_moments_kernel`` (the reference's ``use_pallas_fit``; overridden
    by ``HPB_PALLAS_KDE_FIT``) takes the bandwidths from masked-moment
    passes (``cuda_kde.moment_bandwidths``: one-pass variance, a distinct
    numeric consumer) instead of the two-pass
    :func:`normal_reference_bandwidths`: one launch for both sides, or one
    per side when imputation gave the sides different data.
    """
    cap = vecs.shape[0]
    order = torch.argsort(losses, stable=True)  # +inf pads sort last
    sorted_v = vecs[order]
    rank = torch.arange(cap, dtype=torch.int32, device=vecs.device)
    good_in = rank < n_good
    bad_in = (rank >= count - n_bad) & (rank < count)
    good_mask = good_in.to(torch.float32)
    bad_mask = bad_in.to(torch.float32)
    if impute_draws is not None:
        (u_g, fb_g), (u_b, fb_b) = impute_draws
        good_data = impute_conditional_masked(
            torch.where(good_in[:, None], sorted_v, float("nan")), cards, u_g, fb_g)
        bad_data = impute_conditional_masked(
            torch.where(bad_in[:, None], sorted_v, float("nan")), cards, u_b, fb_b)
    else:
        good_data = bad_data = sorted_v

    env = _moments_fit_requested()
    if bool(use_moments_kernel) if env is None else env:
        from hpbandster_tpu_torch.ops.cuda_kde import moment_bandwidths

        if impute_draws is None:
            bw_good, bw_bad = moment_bandwidths(
                sorted_v, torch.stack([good_mask, bad_mask]), cards, min_bandwidth
            )
        else:
            bw_good = moment_bandwidths(good_data, good_mask, cards, min_bandwidth)
            bw_bad = moment_bandwidths(bad_data, bad_mask, cards, min_bandwidth)
    else:
        bw_good = normal_reference_bandwidths(good_data, good_mask, cards, min_bandwidth)
        bw_bad = normal_reference_bandwidths(bad_data, bad_mask, cards, min_bandwidth)
    return KDE(good_data, good_mask, bw_good), KDE(bad_data, bad_mask, bw_bad)


# ------------------------------------------------------------- proposals
def per_proposal_candidates(
    generator: torch.Generator,
    good: KDE,
    vartypes: torch.Tensor,
    cards: torch.Tensor,
    n: int,
    num_samples: int = 64,
    bandwidth_factor: float = 3.0,
    min_bandwidth: float = 1e-3,
) -> torch.Tensor:
    """``n`` proposals' candidates in :func:`propose`'s layout, proposal
    after proposal: each candidate's donor uniform and its three
    perturbation uniforms are drawn together, ``f32[n * num_samples, d]``.
    The flat layout (:func:`generate_candidates`) draws every donor first;
    the distribution is the same, the numbers differ."""
    d = good.data.shape[1]
    u = torch.rand((n * num_samples, 1 + 3 * d), generator=generator,
                   device=good.data.device)
    idx = _masked_donors(good.mask, u[:, 0])
    return candidates_from_uniforms(
        good, idx, u[:, 1:1 + d], u[:, 1 + d:1 + 2 * d], u[:, 1 + 2 * d:],
        vartypes, cards, bandwidth_factor, min_bandwidth,
    )


class SeededDraws:
    """The per-bracket path's default draws, on ``device``.

    A proposal wave's candidates come from a ``torch.Generator`` seeded with
    the wave's host seed (the number the reference turns into a jax key),
    in the per-proposal or the flat layout; the in-trace fit's imputation
    uniforms from one seeded with the imputation seed. A call with seed
    ``None`` (a one-at-a-time proposal) draws from :attr:`trickle`, one
    generator seeded at construction, as the reference's trickle path draws
    from its key chain. A test replaces this object to feed the reference's
    own candidates through the port's arithmetic.
    """

    def __init__(self, device, trickle_seed: int = 0):
        self.device = torch.device(device)
        self.trickle = torch.Generator(device=self.device)
        self.trickle.manual_seed(int(trickle_seed))

    def generator(self, seed: Optional[int]) -> torch.Generator:
        if seed is None:
            return self.trickle
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return gen

    def candidates(self, seed, good: KDE, vartypes, cards, n: int, num_samples: int,
                   bandwidth_factor: float, min_bandwidth: float, flat: bool) -> torch.Tensor:
        """``f32[n * num_samples, d]``, proposal ``i``'s candidates in rows
        ``i * num_samples`` onwards."""
        gen = self.generator(seed)
        if flat:
            return generate_candidates(gen, good, vartypes, cards, n * num_samples,
                                       bandwidth_factor, min_bandwidth)
        return per_proposal_candidates(gen, good, vartypes, cards, n, num_samples,
                                       bandwidth_factor, min_bandwidth)

    def impute(self, seed: int, n: int, d: int):
        """The good and the bad side's ``(u, u_fb)`` imputation uniforms,
        each ``f32[n, d]``."""
        u = torch.rand((2, 2, n, d), generator=self.generator(seed), device=self.device)
        return (u[0, 0], u[0, 1]), (u[1, 0], u[1, 1])


def propose(
    generator: torch.Generator,
    good: KDE,
    bad: KDE,
    vartypes: torch.Tensor,
    cards: torch.Tensor,
    num_samples: int = 64,
    bandwidth_factor: float = 3.0,
    min_bandwidth: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One BOHB proposal: the best of ``num_samples`` candidates by
    ``max(log l, F) - max(log g, F)``. Returns ``(best f32[d], candidates
    f32[num_samples, d], scores f32[num_samples])``."""
    from hpbandster_tpu_torch.ops.cuda_kde import score_candidates

    cands = per_proposal_candidates(generator, good, vartypes, cards, 1, num_samples,
                                    bandwidth_factor, min_bandwidth)
    scores = score_candidates(cands, good, bad, vartypes, cards)
    # index_select, not a 0-dim tensor index, which reads it on the host
    best = cands.index_select(0, torch.argmax(scores).reshape(1))[0]
    return best, cands, scores


def propose_batch(
    generator: torch.Generator,
    good: KDE,
    bad: KDE,
    vartypes: torch.Tensor,
    cards: torch.Tensor,
    n: int,
    num_samples: int = 64,
    bandwidth_factor: float = 3.0,
    min_bandwidth: float = 1e-3,
) -> torch.Tensor:
    """A whole stage of :func:`propose` calls in one scorer launch,
    ``f32[n, d]``: the reference's vmap of ``propose`` over a key batch."""
    from hpbandster_tpu_torch.ops.cuda_kde import propose_from_candidates

    cands = per_proposal_candidates(generator, good, vartypes, cards, n, num_samples,
                                    bandwidth_factor, min_bandwidth)
    return propose_from_candidates(cands, good, bad, vartypes, cards, n)


def generate_candidates_seeded(
    seed: int,
    good: KDE,
    vartypes: torch.Tensor,
    cards: torch.Tensor,
    n: int,
    num_samples: int = 64,
    bandwidth_factor: float = 3.0,
    min_bandwidth: float = 1e-3,
    draws: Optional[SeededDraws] = None,
) -> torch.Tensor:
    """All ``n * num_samples`` candidates of a stage in the flat layout,
    ``f32[n * num_samples, d]``, keyed from one host seed."""
    draws = draws or SeededDraws(good.data.device)
    return draws.candidates(seed, good, vartypes, cards, n, num_samples,
                            bandwidth_factor, min_bandwidth, flat=True)


def propose_batch_seeded_scored(
    seed: Optional[int],
    good: KDE,
    bad: KDE,
    vartypes: torch.Tensor,
    cards: torch.Tensor,
    n: int,
    num_samples: int = 64,
    bandwidth_factor: float = 3.0,
    min_bandwidth: float = 1e-3,
    draws: Optional[SeededDraws] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` proposals in :func:`propose`'s layout from one host seed, and
    each one's winning score: ``(f32[n, d], f32[n])``, the score being the
    selected candidate's ``log l - log g`` (for the audit's ``lg_score``).
    One scorer launch for all ``n * num_samples`` candidates."""
    from hpbandster_tpu_torch.ops.cuda_kde import propose_scored

    draws = draws or SeededDraws(good.data.device)
    cands = draws.candidates(seed, good, vartypes, cards, n, num_samples,
                             bandwidth_factor, min_bandwidth, flat=False)
    return propose_scored(cands, good, bad, vartypes, cards, n)


def propose_batch_seeded(
    seed: Optional[int],
    good: KDE,
    bad: KDE,
    vartypes: torch.Tensor,
    cards: torch.Tensor,
    n: int,
    num_samples: int = 64,
    bandwidth_factor: float = 3.0,
    min_bandwidth: float = 1e-3,
    draws: Optional[SeededDraws] = None,
) -> torch.Tensor:
    """:func:`propose_batch_seeded_scored` without the scores."""
    return propose_batch_seeded_scored(
        seed, good, bad, vartypes, cards, n, num_samples, bandwidth_factor,
        min_bandwidth, draws,
    )[0]


def refit_pair(
    obs_v: torch.Tensor,
    obs_l: torch.Tensor,
    count: int,
    n_good: int,
    n_bad: int,
    cards: torch.Tensor,
    min_bandwidth: float,
    impute_seed: Optional[int],
    draws: SeededDraws,
) -> Tuple[KDE, KDE]:
    """The in-trace refit's good/bad pair over raw observation buffers
    (:func:`fit_kde_pair_masked`), imputing from ``impute_seed``'s draws on
    a conditional space. The moment-kernel fit follows
    ``HPB_PALLAS_KDE_FIT``."""
    impute_draws = (None if impute_seed is None
                    else draws.impute(impute_seed, *obs_v.shape))
    return fit_kde_pair_masked(obs_v, obs_l, count, n_good, n_bad, cards,
                               min_bandwidth, impute_draws=impute_draws)


def refit_propose_batch_seeded(
    seed: int,
    obs_v: torch.Tensor,
    obs_l: torch.Tensor,
    count: int,
    n_good: int,
    n_bad: int,
    vartypes: torch.Tensor,
    cards: torch.Tensor,
    n: int,
    num_samples: int = 64,
    bandwidth_factor: float = 3.0,
    min_bandwidth: float = 1e-3,
    impute_seed: Optional[int] = None,
    draws: Optional[SeededDraws] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The KDE refit and a whole stage of proposals with no host step
    between them: raw observation buffers (``f32[C, d]`` vectors, ``f32[C]``
    losses, ``+inf`` in empty slots) in, ``(f32[n, d], f32[n])`` proposals
    and scores out, in :func:`propose`'s layout. ``count``, ``n_good`` and
    ``n_bad`` are the caller's split arithmetic. Pass ``impute_seed`` on
    conditional spaces."""
    draws = draws or SeededDraws(obs_v.device)
    good, bad = refit_pair(obs_v, obs_l, count, n_good, n_bad, cards,
                           min_bandwidth, impute_seed, draws)
    return propose_batch_seeded_scored(
        seed, good, bad, vartypes, cards, n, num_samples, bandwidth_factor,
        min_bandwidth, draws,
    )
