"""Whole-sweep fusion: a multi-bracket BOHB run driven on the device.

Ported from ``hpbandster_tpu/ops/sweep.py``: the space codec
(``SpaceCodec``, ``build_space_codec``, ``quantize_unit``, ``random_unit``),
``pow2_capacities``, ``plan_additions``, ``_fit_kde_pair_device`` and the
static and dynamic-count tiers of ``make_fused_sweep_fn``
(``init_obs_state``, ``trained_split``, ``dynamic_gate``,
``dynamic_proposals``, ``run_bracket`` and the unrolled ``sweep``).

The static tier keeps every observation count a Python int, so the model
gate, the good/bad split sizes and the choice of the largest trained budget
are decided on the host with no device round trip. The dynamic-count tier
keeps the counts on the device as int32 tensors over full-capacity buffers:
the gate, the split and the budget choice are tensor arithmetic, every
bracket fits and proposes, and ``torch.where`` keeps or discards the model's
picks, so nothing inside a sweep waits on the host for a count. PyTorch runs
eagerly, so the sweep is a Python loop of device ops rather than one
compiled program, and it synchronises when the caller reads the outputs.

Random numbers enter through a draw seam (:class:`GeneratorDraws`): each
bracket asks it for its uniform stage-0 vectors, its candidate set and its
model-based mask. The default draws from one ``torch.Generator`` seeded from
the run seed; a test can hand in the reference's own draws instead.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from hpbandster_tpu_torch.ops.bracket import BracketPlan
from hpbandster_tpu_torch.ops.cuda_kde import propose_from_candidates
from hpbandster_tpu_torch.ops.fused import _pack_stages, fused_sh_bracket
from hpbandster_tpu_torch.ops.kde import (
    KDE,
    fit_kde_pair_masked,
    generate_candidates,
    normal_reference_bandwidths,
)

__all__ = [
    "SpaceCodec",
    "build_space_codec",
    "quantize_unit",
    "random_unit",
    "random_unit_from",
    "pow2_capacities",
    "plan_additions",
    "GeneratorDraws",
    "SweepBracketOutput",
    "make_fused_sweep_fn",
]

_F32 = torch.float32


def pow2_capacities(counts: dict, floor: int = 256) -> dict:
    """Per-budget buffer capacities of the dynamic-count tier: each count
    rounded up to a power of two, at least ``floor``. The one definition of
    the tier's buffer shapes: a chunked run and a run resumed from its
    checkpoint agree on every chunk's shapes because both take them from
    here."""
    floor = max(int(floor), 1)
    return {
        float(b): 1 << max(int(n) - 1, floor - 1).bit_length()
        for b, n in counts.items()
    }


def plan_additions(plans: Sequence[BracketPlan]) -> dict:
    """Per-budget observation counts a plan sequence appends."""
    out: dict = {}
    for plan in plans:
        for k, b in zip(plan.num_configs, plan.budgets):
            out[float(b)] = out.get(float(b), 0) + int(k)
    return out


class SpaceCodec(NamedTuple):
    """Static per-dim description of a search space, enough to quantize and
    sample unit-hypercube vectors on the device. Arrays are numpy, as in the
    reference; the device functions cast them to float32 tensors.

    dim kinds: 0 = float, 1 = integer, 2 = categorical/ordinal (index repr),
    3 = constant.
    """

    kind: np.ndarray      # int32[d]
    log: np.ndarray       # bool[d]
    lower: np.ndarray     # float64[d] (1.0-safe for non-log dims)
    upper: np.ndarray     # float64[d]
    q: np.ndarray         # float64[d]; NaN = no quantization
    cards: np.ndarray     # int32[d] choices per discrete dim (0 = continuous)
    vartypes: np.ndarray  # int32[d] KDE vartype codes ('c'=0,'u'=1,'o'=2)
    logits: np.ndarray    # float32[d, kmax] sampling log-probs, -inf padded


def build_space_codec(configspace) -> SpaceCodec:
    """Extract the static codec of a ``hpbandster_tpu_torch.space``
    ``ConfigurationSpace``."""
    from hpbandster_tpu_torch.space.hyperparameters import (
        CategoricalHyperparameter,
        Constant,
        OrdinalHyperparameter,
        UniformFloatHyperparameter,
        UniformIntegerHyperparameter,
    )

    hps = configspace.get_hyperparameters()
    d = len(hps)
    kind = np.zeros(d, np.int32)
    log = np.zeros(d, bool)
    lower = np.ones(d, np.float64)
    upper = np.full(d, 2.0, np.float64)
    q = np.full(d, np.nan, np.float64)
    cards = np.zeros(d, np.int32)
    kmax = max([hp.num_choices for hp in hps] + [1])
    logits = np.full((d, kmax), -np.inf, np.float32)

    for i, hp in enumerate(hps):
        if isinstance(hp, Constant):
            kind[i] = 3
            cards[i] = 1
            logits[i, 0] = 0.0
        elif isinstance(hp, UniformFloatHyperparameter):
            kind[i] = 0
            log[i] = hp.log
            lower[i], upper[i] = hp.lower, hp.upper
            if hp.q is not None:
                q[i] = hp.q
        elif isinstance(hp, UniformIntegerHyperparameter):
            kind[i] = 1
            log[i] = hp.log
            lower[i], upper[i] = hp.lower, hp.upper
        elif isinstance(hp, CategoricalHyperparameter):
            kind[i] = 2
            cards[i] = hp.num_choices
            logits[i, : hp.num_choices] = np.log(
                np.maximum(np.asarray(hp.probabilities, np.float64), 1e-300)
            )
        elif isinstance(hp, OrdinalHyperparameter):
            kind[i] = 2
            cards[i] = hp.num_choices
            logits[i, : hp.num_choices] = 0.0
        else:
            raise ValueError(f"unsupported hyperparameter type {type(hp).__name__}")
    return SpaceCodec(
        kind=kind, log=log, lower=lower, upper=upper, q=q, cards=cards,
        vartypes=np.asarray(configspace.vartypes()), logits=logits,
    )


def _int_log_bounds(codec: SpaceCodec) -> Tuple[np.ndarray, np.ndarray]:
    """The codec's widened log bounds for integer dims (float64 numpy)."""
    lo = np.where(
        codec.lower > 1, codec.lower - 0.4999, np.maximum(codec.lower, 1) * 0.5001
    )
    hi = codec.upper + 0.4999
    return lo, hi


def _f32(x, device) -> torch.Tensor:
    """A float32 tensor on ``device``. The codec's float64 arrays must not
    leak through as float64: the reference computes them in float32."""
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def quantize_unit(codec: SpaceCodec, u: torch.Tensor) -> torch.Tensor:
    """Snap unit-hypercube vectors ``f32[..., d]`` to representable
    configurations: the device twin of ``to_vector(from_vector(u))``.
    Rounding is half-to-even (``torch.round``), as in the reference."""
    dev = u.device
    kind = torch.as_tensor(codec.kind, device=dev)
    is_log = torch.as_tensor(codec.log, device=dev)
    u_raw = u.to(_F32)
    # float/int dims live in [0,1]; categorical dims hold raw choice indices
    u = torch.clamp(u_raw, 0.0, 1.0)

    # floats: identity unless quantized (q), then value-space snap
    lo = _f32(codec.lower, dev)
    hi = _f32(codec.upper, dev)
    log_lo = torch.log(torch.clamp(lo, min=1e-30))
    log_hi = torch.log(torch.clamp(hi, min=1e-30))
    val_lin = lo + u * (hi - lo)
    val_log = torch.exp(log_lo + u * (log_hi - log_lo))
    val = torch.where(is_log, val_log, val_lin)
    qs = _f32(np.nan_to_num(codec.q, nan=1.0), dev)
    has_q = torch.as_tensor(np.isfinite(codec.q), device=dev)
    val_q = torch.minimum(torch.maximum(torch.round(val / qs) * qs, lo), hi)
    enc_lin = (val_q - lo) / torch.clamp(hi - lo, min=1e-30)
    enc_log = (torch.log(torch.clamp(val_q, min=1e-30)) - log_lo) / torch.clamp(
        log_hi - log_lo, min=1e-30
    )
    u_float = torch.where(
        has_q, torch.clamp(torch.where(is_log, enc_log, enc_lin), 0.0, 1.0), u
    )

    # integers: decode (bin-center / widened-log), round, re-encode
    ilo_np, ihi_np = _int_log_bounds(codec)
    ilo = _f32(ilo_np, dev)
    ihi = _f32(ihi_np, dev)
    n_int = torch.clamp(hi - lo + 1.0, min=1.0)
    v_lin = lo - 0.5 + u * n_int
    log_ilo = torch.log(torch.clamp(ilo, min=1e-30))
    log_ihi = torch.log(torch.clamp(ihi, min=1e-30))
    v_log = torch.exp(log_ilo + u * (log_ihi - log_ilo))
    vi = torch.minimum(
        torch.maximum(torch.round(torch.where(is_log, v_log, v_lin)), lo), hi
    )
    enc_i_lin = (vi - lo + 0.5) / n_int
    enc_i_log = torch.clamp(
        (torch.log(torch.clamp(vi, min=1e-30)) - log_ilo)
        / torch.clamp(log_ihi - log_ilo, min=1e-30),
        0.0,
        1.0,
    )
    u_int = torch.where(is_log, enc_i_log, enc_i_lin)

    # categorical / ordinal: snap to the nearest index
    kf = torch.clamp(_f32(codec.cards, dev), min=1.0)
    u_cat = torch.minimum(torch.clamp(torch.round(u_raw), min=0.0), kf - 1.0)

    out = torch.where(kind == 0, u_float, u)
    out = torch.where(kind == 1, u_int, out)
    out = torch.where(kind == 2, u_cat, out)
    return torch.where(kind == 3, torch.zeros_like(out), out)


def random_unit_from(
    codec: SpaceCodec, u: torch.Tensor, cat_idx: torch.Tensor
) -> torch.Tensor:
    """Compose uniform configuration vectors from ``u`` (uniforms in [0, 1),
    ``f32[n, d]``) and ``cat_idx`` (per-dim categorical draws, ``[n, d]``):
    float/int dims take ``u``, categorical/ordinal dims the index, constants
    0. Un-quantized; pass through :func:`quantize_unit` before evaluating."""
    kind = torch.as_tensor(codec.kind, device=u.device)
    out = torch.where(kind == 2, cat_idx.to(_F32), u.to(_F32))
    return torch.where(kind == 3, torch.zeros_like(out), out)


def random_unit(
    codec: SpaceCodec, generator: torch.Generator, n: int,
    device: torch.device,
) -> torch.Tensor:
    """``n`` uniform configuration vectors, ``f32[n, d]``: uniform unit for
    float/int dims, weighted categorical, uniform ordinal, 0 for constants.
    Categorical draws use the Gumbel-max trick over the codec's logits."""
    d = int(codec.kind.shape[0])
    logits = _f32(codec.logits, device)  # [d, kmax], -inf padded
    u = torch.rand((n, d), generator=generator, device=device)
    g = torch.rand((n, d, logits.shape[1]), generator=generator, device=device)
    gumbel = -torch.log(-torch.log(torch.clamp(g, min=1e-20)))
    idx = torch.argmax(logits[None] + gumbel, dim=-1)
    return random_unit_from(codec, u, idx)


def _fit_kde_pair_device(
    vecs: torch.Tensor,
    losses: torch.Tensor,
    n_good: int,
    n_bad: int,
    cards: torch.Tensor,
    min_bandwidth: float,
) -> Tuple[KDE, KDE]:
    """Stable sort by loss, top ``n_good`` / bottom ``n_bad`` rows,
    normal-reference bandwidths (the host model's ``_fit_kde_pair``)."""
    n = vecs.shape[0]
    order = torch.argsort(losses, stable=True)
    good = vecs[order[:n_good]]
    bad = vecs[order[n - n_bad:]]

    def mk(data: torch.Tensor) -> KDE:
        mask = torch.ones(data.shape[0], dtype=_F32, device=data.device)
        bw = normal_reference_bandwidths(data, mask, cards, min_bandwidth)
        return KDE(data, mask, bw)

    return mk(good), mk(bad)


class SweepBracketOutput(NamedTuple):
    """Per-bracket outputs of the sweep (device tensors)."""

    #: quantized stage-0 configuration vectors, f32[n0, d]
    vectors: torch.Tensor
    #: True where the proposal was model-based, bool[n0]
    model_based: torch.Tensor
    #: stage-major concatenation of original-row indices, int64[sum(ns)]
    idx_packed: torch.Tensor
    #: matching losses (NaN = crashed), f32[sum(ns)]
    loss_packed: torch.Tensor


class GeneratorDraws:
    """The sweep's default draws, all from one ``torch.Generator`` seeded
    with the run seed and consumed in bracket order.

    A draw source answers three questions per bracket ``b_i``: the uniform
    stage-0 vectors (:meth:`stage0`), the candidate set around the fitted
    good KDE (:meth:`candidates`) and which proposals are model-based
    (:meth:`model_mask`).
    """

    def __init__(
        self,
        codec: SpaceCodec,
        seed: int,
        device: torch.device,
        random_fraction: float,
        bandwidth_factor: float,
        min_bandwidth: float,
    ):
        self.codec = codec
        self.device = torch.device(device)
        self.random_fraction = float(random_fraction)
        self.bandwidth_factor = float(bandwidth_factor)
        self.min_bandwidth = float(min_bandwidth)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        # float32 once: the candidate draw reads them as floats
        self._vartypes = _f32(codec.vartypes, self.device)
        self._cards = _f32(codec.cards, self.device)

    def stage0(self, b_i: int, n0: int) -> torch.Tensor:
        return random_unit(self.codec, self.generator, n0, self.device)

    def candidates(self, b_i: int, good: KDE, total: int) -> torch.Tensor:
        return generate_candidates(
            self.generator, good, self._vartypes, self._cards, total,
            self.bandwidth_factor, self.min_bandwidth,
        )

    def model_mask(self, b_i: int, n0: int) -> torch.Tensor:
        u = torch.rand((n0,), generator=self.generator, device=self.device)
        return u >= self.random_fraction


def make_fused_sweep_fn(
    eval_fn: Callable[[torch.Tensor, float], torch.Tensor],
    plans: Sequence[BracketPlan],
    codec: SpaceCodec,
    *,
    device,
    num_samples: int = 64,
    random_fraction: float = 1 / 3,
    top_n_percent: int = 15,
    min_points_in_model: Optional[int] = None,
    bandwidth_factor: float = 3.0,
    min_bandwidth: float = 1e-3,
    warm_counts: Optional[dict] = None,
    dynamic_counts: bool = False,
    capacities: Optional[dict] = None,
    return_state: bool = False,
    resident: bool = False,
    mesh=None,
    shard_sampling: bool = False,
    incumbent_only: bool = False,
    device_metrics: bool = False,
    stateful_eval=None,
    rank_fn: Optional[Callable] = None,
    active_mask_fn: Optional[Callable] = None,
    forbidden_fn: Optional[Callable] = None,
) -> Callable[..., List[SweepBracketOutput]]:
    """Build the sweep; returns
    ``fn(seed, warm_v=None, warm_l=None, warm_n=None, draws=None)``.

    ``eval_fn(vectors f32[n, d], budget) -> f32[n]`` is batched. Model
    bookkeeping mirrors the reference: a budget's KDE pair exists once it
    holds ``min_points_in_model + 2`` observations and both split sides
    exceed ``d``; proposals use the largest such budget, refit at every
    bracket start from all observations so far. ``draws`` replaces the
    default :class:`GeneratorDraws` seeded with ``seed``.

    Static tier (default): ``warm_counts`` (budget -> n) sizes the warm
    observations that ``warm_v``/``warm_l`` (budget -> ``[n, d]`` / ``[n]``,
    numpy or tensors) bring in; ``fn`` returns ``[SweepBracketOutput]``.

    ``dynamic_counts=True``: ``warm_v[b]``/``warm_l[b]`` are full-capacity
    buffers and ``warm_n[b]`` an int32 count tensor. The gate, the split
    sizes and the largest-trained-budget choice are device arithmetic
    (:func:`~hpbandster_tpu_torch.ops.kde.fit_kde_pair_masked`); every
    bracket fits and proposes over ``capmax`` rows and ``torch.where``
    discards the model's picks while no gate is open, so counts are never
    read on the host. ``capacities`` (budget -> slots, covering warm plus
    every plan's additions) pins the buffer shapes so all chunks of a run
    agree. ``return_state=True`` makes ``fn`` return ``(outputs, (obs_v,
    obs_l, counts))``, the end-of-sweep state the next chunk takes back as
    its warm inputs. Where the reference donates the warm buffers to that
    state, the port never writes to its inputs: it builds the state from
    them once and then appends to it in place.

    The other tiers and seams of the reference (resident, meshes,
    incumbent-only, device metrics, stateful evaluation, custom promotion
    ranks, conditions and forbiddens) are not ported yet and raise
    ``NotImplementedError``.
    """
    unported = {
        "resident": resident,
        "mesh": mesh is not None, "shard_sampling": shard_sampling,
        "incumbent_only": incumbent_only, "device_metrics": device_metrics,
        "stateful_eval": stateful_eval is not None,
        "rank_fn": rank_fn is not None,
        "active_mask_fn": active_mask_fn is not None,
        "forbidden_fn": forbidden_fn is not None,
    }
    for name, on in unported.items():
        if on:
            raise NotImplementedError(
                f"{name} is not ported to the PyTorch sweep yet"
            )
    if eval_fn is None:
        raise ValueError("make_fused_sweep_fn needs an eval_fn")
    if return_state and not dynamic_counts:
        raise ValueError(
            "return_state=True requires dynamic_counts=True: the static "
            "tier's counts are host ints, there is no reusable state"
        )
    device = torch.device(device)
    d = int(codec.kind.shape[0])
    min_pts = (d + 1) if min_points_in_model is None else max(int(min_points_in_model), d + 1)
    plans = [BracketPlan(tuple(p.num_configs), tuple(p.budgets)) for p in plans]
    warm_counts = {float(b): int(n) for b, n in (warm_counts or {}).items() if n > 0}

    # static per-budget observation capacities across the whole sweep
    additions = plan_additions(plans)
    caps: Dict[float, int] = dict(warm_counts)
    for b, k in additions.items():
        caps[b] = caps.get(b, 0) + k
    if capacities is not None:
        for b, need in caps.items():
            if capacities.get(float(b), 0) < need:
                raise ValueError(
                    f"capacities[{b}]={capacities.get(float(b))} cannot hold "
                    f"the {need} observations this sweep accumulates there"
                )
        caps = {float(b): int(n) for b, n in capacities.items()}

    # float32 once, as the kernels take them: no cast per launch
    vartypes_dev = _f32(codec.vartypes, device)
    cards_dev = _f32(codec.cards, device)

    def trained_split(n: int) -> Optional[Tuple[int, int]]:
        """Host-side gate of the KDE fit: split sizes, or None when closed."""
        if n < min_pts + 2:
            return None
        n_good = max(min_pts, (top_n_percent * n) // 100)
        n_bad = max(min_pts, ((100 - top_n_percent) * n) // 100)
        if n_good <= d or n_bad <= d:
            return None
        return n_good, n_bad

    # dynamic-count machinery: the gate is the int32 twin of trained_split
    # (same integer formulas, so the model opens at the same counts)
    capmax = max(caps.values(), default=0)
    any_trainable = any(trained_split(c) is not None for c in caps.values())

    def dynamic_gate(cnt: torch.Tensor):
        n_good = torch.clamp((top_n_percent * cnt) // 100, min=min_pts)
        n_bad = torch.clamp(((100 - top_n_percent) * cnt) // 100, min=min_pts)
        has = (cnt >= min_pts + 2) & (n_good > d) & (n_bad > d)
        return has, n_good, n_bad

    def dynamic_proposals(b_i, draws, obs_v, obs_l, counts, rand_vecs, n0):
        """Largest-trained-budget choice, fit and proposal, all on the
        device. Budget priority is a descending loop; the chosen budget's
        buffer is widened to ``capmax`` so one fit serves whichever budget
        wins. With no gate open the fit runs on empty buffers (finite, the
        donor draw is :func:`~hpbandster_tpu_torch.ops.kde._masked_donors`)
        and the mask discards every model pick, like the static tier's
        all-random bracket."""
        sel_v = torch.zeros((capmax, d), dtype=_F32, device=device)
        sel_l = torch.full((capmax,), float("inf"), dtype=_F32, device=device)
        sel_n = torch.zeros((), dtype=torch.int32, device=device)
        any_model = torch.zeros((), dtype=torch.bool, device=device)
        for b in sorted(caps, reverse=True):
            has, _, _ = dynamic_gate(counts[b])
            take = has & ~any_model
            pad = capmax - caps[b]
            pv = torch.nn.functional.pad(obs_v[b], (0, 0, 0, pad))
            pl = torch.nn.functional.pad(obs_l[b], (0, pad), value=float("inf"))
            sel_v = torch.where(take, pv, sel_v)
            sel_l = torch.where(take, pl, sel_l)
            sel_n = torch.where(take, counts[b], sel_n)
            any_model = any_model | has
        _, n_good, n_bad = dynamic_gate(sel_n)
        good, bad = fit_kde_pair_masked(
            sel_v, sel_l, sel_n, n_good, n_bad, cards_dev, min_bandwidth,
        )
        cands = draws.candidates(b_i, good, n0 * num_samples)
        model_vecs = propose_from_candidates(
            cands, good, bad, vartypes_dev, cards_dev, n0
        )
        mb_mask = any_model & draws.model_mask(b_i, n0).to(device)
        return torch.where(mb_mask[:, None], model_vecs, rand_vecs), mb_mask

    def init_obs_state(warm_v, warm_l, warm_n):
        """Per-budget observation buffers. Static tier: exact-count slices
        with the warm rows in front and Python-int counts. Dynamic tier:
        full-capacity buffers with int32 count tensors; pad slots are
        pinned to (0-vector, +inf loss) whatever the caller sent. NaN warm
        losses (crashes) enter as +inf on both tiers."""
        if not dynamic_counts:
            obs_v = {b: torch.zeros((cap, d), dtype=_F32, device=device)
                     for b, cap in caps.items()}
            obs_l = {b: torch.zeros(cap, dtype=_F32, device=device)
                     for b, cap in caps.items()}
            counts = {b: 0 for b in caps}
            for b, n in warm_counts.items():
                v = torch.as_tensor(warm_v[b]).to(device, _F32)
                l = torch.as_tensor(warm_l[b]).to(device, _F32)
                obs_v[b][:n] = v
                obs_l[b][:n] = torch.where(torch.isnan(l), torch.full_like(l, float("inf")), l)
                counts[b] = n
            return obs_v, obs_l, counts
        obs_v, obs_l, counts = {}, {}, {}
        for b, cap in caps.items():
            # a budget in `capacities` but in none of the warm dicts starts
            # empty; one in only some of them is a caller's bug
            have = warm_n is not None and b in warm_n
            have_v = warm_v is not None and b in warm_v
            have_l = warm_l is not None and b in warm_l
            if not (have == have_v == have_l):
                raise ValueError(
                    f"inconsistent warm inputs for budget {b}: present in "
                    f"warm_n={have}, warm_v={have_v}, warm_l={have_l} — each "
                    "budget must appear in all three dicts or none"
                )
            # each budget's additions over the whole schedule are static, so
            # clamping the warm count to (capacity - additions) keeps every
            # later append inside the buffer: an oversized count drops its
            # newest warm rows instead of overrunning the appends
            n_b = torch.clamp(
                torch.as_tensor(warm_n[b] if have else 0, dtype=torch.int32,
                                device=device),
                max=cap - additions.get(b, 0),
            )
            live = torch.arange(cap, dtype=torch.int32, device=device) < n_b
            if have:
                v = torch.as_tensor(warm_v[b]).to(device, _F32)
                l = torch.as_tensor(warm_l[b]).to(device, _F32)
                obs_v[b] = torch.where(live[:, None], v, torch.zeros_like(v))
                obs_l[b] = torch.where(
                    live & ~torch.isnan(l), l, torch.full_like(l, float("inf"))
                )
            else:
                obs_v[b] = torch.zeros((cap, d), dtype=_F32, device=device)
                obs_l[b] = torch.full((cap,), float("inf"), dtype=_F32, device=device)
            counts[b] = n_b
        return obs_v, obs_l, counts

    def run_bracket(b_i, plan, draws, obs_v, obs_l, counts):
        """One bracket: sample/propose -> rung ladder -> observation append.
        Updates ``obs_v``/``obs_l``/``counts`` in place."""
        n0 = plan.num_configs[0]
        rand_vecs = draws.stage0(b_i, n0).to(device)
        if dynamic_counts:
            if any_trainable:
                proposals, mb_mask = dynamic_proposals(
                    b_i, draws, obs_v, obs_l, counts, rand_vecs, n0
                )
            else:
                # no budget's gate can open even at full capacity: no model
                # math at all
                proposals = rand_vecs
                mb_mask = torch.zeros(n0, dtype=torch.bool, device=device)
        else:
            model_budget = None
            for b in sorted(caps, reverse=True):
                if trained_split(counts[b]) is not None:
                    model_budget = b
                    break
            if model_budget is None:
                proposals = rand_vecs
                mb_mask = torch.zeros(n0, dtype=torch.bool, device=device)
            else:
                n = counts[model_budget]
                n_good, n_bad = trained_split(n)
                good, bad = _fit_kde_pair_device(
                    obs_v[model_budget][:n], obs_l[model_budget][:n],
                    n_good, n_bad, cards_dev, min_bandwidth,
                )
                cands = draws.candidates(b_i, good, n0 * num_samples)
                model_vecs = propose_from_candidates(
                    cands, good, bad, vartypes_dev, cards_dev, n0
                )
                mb_mask = draws.model_mask(b_i, n0).to(device)
                proposals = torch.where(mb_mask[:, None], model_vecs, rand_vecs)

        vectors = quantize_unit(codec, proposals)
        stages = fused_sh_bracket(eval_fn, vectors, plan.num_configs, plan.budgets)
        for (idx_s, losses_s), k_s, budget in zip(stages, plan.num_configs, plan.budgets):
            b = float(budget)
            c = counts[b]
            upd_l = torch.where(
                torch.isnan(losses_s), torch.full_like(losses_s, float("inf")), losses_s
            )
            if dynamic_counts:
                # append at the device offset c: the init clamp keeps
                # c + k_s inside the buffer
                rows = c + torch.arange(k_s, device=device)
                obs_v[b].index_copy_(0, rows, vectors[idx_s])
                obs_l[b].index_copy_(0, rows, upd_l)
            else:
                obs_v[b][c:c + k_s] = vectors[idx_s]
                obs_l[b][c:c + k_s] = upd_l
            counts[b] = c + k_s
        idx_packed, loss_packed = _pack_stages(stages)
        return SweepBracketOutput(vectors[:n0], mb_mask, idx_packed, loss_packed)

    def sweep(seed, warm_v=None, warm_l=None, warm_n=None, draws=None):
        if draws is None:
            draws = GeneratorDraws(
                codec, int(seed), device, random_fraction, bandwidth_factor,
                min_bandwidth,
            )
        obs_v, obs_l, counts = init_obs_state(warm_v, warm_l, warm_n)
        outputs = [
            run_bracket(b_i, plan, draws, obs_v, obs_l, counts)
            for b_i, plan in enumerate(plans)
        ]
        if return_state:
            return outputs, (obs_v, obs_l, counts)
        return outputs

    return sweep
