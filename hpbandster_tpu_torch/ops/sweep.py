"""Whole-sweep fusion: a multi-bracket BOHB run driven on the device.

Ported from ``hpbandster_tpu/ops/sweep.py``: the space codec
(``SpaceCodec``, ``build_space_codec``, ``quantize_unit``, ``random_unit``,
``_decode_values``), the compiled conditions and forbidden clauses
(``compile_active_mask``, ``compile_forbidden_mask``, and the in-sweep
rejection resampling as ``resample_forbidden``), ``pow2_capacities``,
``plan_additions``, ``_fit_kde_pair_device``, the static and
dynamic-count tiers of ``make_fused_sweep_fn`` (``init_obs_state``,
``trained_split``, ``dynamic_gate``, ``dynamic_proposals``, ``run_bracket``
and the unrolled ``sweep``), and the serving lanes' incumbent carry
(``init_lane_state``, ``decode_lane_state``).

The static tier keeps every observation count a Python int, so the model
gate, the good/bad split sizes and the choice of the largest trained budget
are decided on the host with no device round trip. The dynamic-count tier
keeps the counts on the device as int32 tensors over full-capacity buffers:
the gate, the split and the budget choice are tensor arithmetic, every
bracket fits and proposes, and ``torch.where`` keeps or discards the model's
picks, so nothing inside a sweep waits on the host for a count. On the CPU
the sweep is a Python loop of eager ops. On a card the dynamic tiers run
as captured CUDA graphs, the counterpart of the reference's compiled
programs: a chunk's brackets as one graph, or the resident round. The
callable that builds them is reusable: a later call copies its warm inputs
into the captured buffers, reseeds the graph's generator and replays, so a
cached sweep (``FusedBOHB``'s sweep cache) pays one capture. The static tier
runs eagerly everywhere. A sweep synchronises when the caller reads the
outputs.

Random numbers enter through a draw seam (:class:`GeneratorDraws`): each
bracket asks it for its uniform stage-0 vectors, its candidate set, its
model-based mask and, on conditional or forbidden spaces, its imputation
uniforms and forbidden-row redraws. The default draws from one
``torch.Generator`` seeded from the run seed; a test can hand in the
reference's own draws instead. The codec's constants reach the device
once per optimizer (:class:`CodecTables`, built by the optimizer and
handed to every sweep it builds and to the compiled masks), since every
upload from host memory is a synchronising copy.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from hpbandster_tpu_torch.obs.device_metrics import N_BINS, bin_edges
from hpbandster_tpu_torch.ops.bracket import BracketPlan
from hpbandster_tpu_torch.ops.cuda_kde import propose_from_candidates
from hpbandster_tpu_torch.ops.fused import (
    _CRASH_RANK,
    StatefulEval,
    _pack_stages,
    fused_sh_bracket,
    stage_telemetry,
)
from hpbandster_tpu_torch.ops.kde import (
    KDE,
    fit_kde_pair_masked,
    generate_candidates,
    impute_conditional_masked,
    normal_reference_bandwidths,
)

__all__ = [
    "SpaceCodec",
    "build_space_codec",
    "CodecTables",
    "codec_tables",
    "quantize_unit",
    "random_unit",
    "random_unit_from",
    "compile_active_mask",
    "compile_forbidden_mask",
    "resample_forbidden",
    "pow2_capacities",
    "plan_additions",
    "GeneratorDraws",
    "SweepBracketOutput",
    "SweepIncumbent",
    "ResidentSweepOutputs",
    "DeviceMetrics",
    "init_device_metrics",
    "init_lane_state",
    "decode_lane_state",
    "resident_rotation",
    "unstack_resident_outputs",
    "make_fused_sweep_fn",
]

_F32 = torch.float32


def _has_warm(b: float, warm_v, warm_l, warm_n) -> bool:
    """Whether budget ``b`` has dynamic-tier warm inputs. A budget in the
    capacities but in none of the warm dicts starts empty; one in only
    some of them is a caller's bug."""
    have = warm_n is not None and b in warm_n
    have_v = warm_v is not None and b in warm_v
    have_l = warm_l is not None and b in warm_l
    if not (have == have_v == have_l):
        raise ValueError(
            f"inconsistent warm inputs for budget {b}: present in "
            f"warm_n={have}, warm_v={have_v}, warm_l={have_l} — each "
            "budget must appear in all three dicts or none"
        )
    return have


def _copy_into(dst, src) -> None:
    """Write ``src`` into ``dst`` in place, leaf by leaf: tensors, or
    dicts, tuples and named tuples of them."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        for a, b in zip(dst, src):
            _copy_into(a, b)


def _sig(caps_sig: str, plans, flags: str) -> str:
    """A captured sweep's signature in the capture ledger: capacities,
    bracket shapes and modes, cut to 200 characters."""
    out = (f"caps={caps_sig}; plans=" + "|".join(
        "x".join(map(str, p.num_configs)) for p in plans) + flags)
    return out if len(out) <= 200 else out[:197] + "..."


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

    @property
    def signature(self) -> Tuple:
        """Hashable identity for sweep caches."""
        return tuple((a.tobytes(), a.shape) for a in self)


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


class CodecTables(NamedTuple):
    """A codec's per-dim constants as tensors on one device, with the
    float32 values the reference computes in its trace. Whoever owns the
    codec builds them once (:func:`codec_tables`; ``FusedBOHB`` for all its
    chunks) and hands them to every codec function, mask and sweep: each
    upload from numpy is a synchronising copy."""

    kind: torch.Tensor     # int32[d]
    is_log: torch.Tensor   # bool[d]
    lo: torch.Tensor       # f32[d]
    hi: torch.Tensor
    log_lo: torch.Tensor   # log(max(lo, 1e-30))
    log_hi: torch.Tensor
    qs: torch.Tensor       # q, 1 where there is none
    has_q: torch.Tensor    # bool[d]
    n_int: torch.Tensor    # max(hi - lo + 1, 1)
    log_ilo: torch.Tensor  # log of the widened integer log bounds
    log_ihi: torch.Tensor
    kf: torch.Tensor       # max(cards, 1)
    cards: torch.Tensor    # f32[d], as the kernels take them
    vartypes: torch.Tensor  # f32[d]
    logits: torch.Tensor   # f32[d, kmax]

    @property
    def device(self) -> torch.device:
        return self.kind.device


def codec_tables(codec: SpaceCodec, device) -> CodecTables:
    """Upload ``codec``'s constants to ``device`` once."""
    dev = torch.device(device)
    lo, hi = _f32(codec.lower, dev), _f32(codec.upper, dev)
    ilo_np, ihi_np = _int_log_bounds(codec)
    cards = _f32(codec.cards, dev)

    def log(x):
        return torch.log(torch.clamp(x, min=1e-30))

    return CodecTables(
        kind=torch.as_tensor(codec.kind, device=dev),
        is_log=torch.as_tensor(codec.log, device=dev),
        lo=lo, hi=hi, log_lo=log(lo), log_hi=log(hi),
        qs=_f32(np.nan_to_num(codec.q, nan=1.0), dev),
        has_q=torch.as_tensor(np.isfinite(codec.q), device=dev),
        n_int=torch.clamp(hi - lo + 1.0, min=1.0),
        log_ilo=log(_f32(ilo_np, dev)), log_ihi=log(_f32(ihi_np, dev)),
        kf=torch.clamp(cards, min=1.0), cards=cards,
        vartypes=_f32(codec.vartypes, dev), logits=_f32(codec.logits, dev),
    )


def quantize_unit(t: CodecTables, u: torch.Tensor) -> torch.Tensor:
    """Snap unit-hypercube vectors ``f32[..., d]`` (on ``t``'s device) to
    representable configurations: the device twin of
    ``to_vector(from_vector(u))``. Rounding is half-to-even
    (``torch.round``), as in the reference."""
    u_raw = u.to(_F32)
    # float/int dims live in [0,1]; categorical dims hold raw choice indices
    u = torch.clamp(u_raw, 0.0, 1.0)

    # floats: identity unless quantized (q), then value-space snap
    val_lin = t.lo + u * (t.hi - t.lo)
    val_log = torch.exp(t.log_lo + u * (t.log_hi - t.log_lo))
    val = torch.where(t.is_log, val_log, val_lin)
    val_q = torch.minimum(torch.maximum(torch.round(val / t.qs) * t.qs, t.lo), t.hi)
    enc_lin = (val_q - t.lo) / torch.clamp(t.hi - t.lo, min=1e-30)
    enc_log = (torch.log(torch.clamp(val_q, min=1e-30)) - t.log_lo) / torch.clamp(
        t.log_hi - t.log_lo, min=1e-30
    )
    u_float = torch.where(
        t.has_q, torch.clamp(torch.where(t.is_log, enc_log, enc_lin), 0.0, 1.0), u
    )

    # integers: decode (bin-center / widened-log), round, re-encode
    v_lin = t.lo - 0.5 + u * t.n_int
    v_log = torch.exp(t.log_ilo + u * (t.log_ihi - t.log_ilo))
    vi = torch.minimum(
        torch.maximum(torch.round(torch.where(t.is_log, v_log, v_lin)), t.lo), t.hi
    )
    enc_i_lin = (vi - t.lo + 0.5) / t.n_int
    enc_i_log = torch.clamp(
        (torch.log(torch.clamp(vi, min=1e-30)) - t.log_ilo)
        / torch.clamp(t.log_ihi - t.log_ilo, min=1e-30),
        0.0,
        1.0,
    )
    u_int = torch.where(t.is_log, enc_i_log, enc_i_lin)

    # categorical / ordinal: snap to the nearest index
    u_cat = torch.minimum(torch.clamp(torch.round(u_raw), min=0.0), t.kf - 1.0)

    out = torch.where(t.kind == 0, u_float, u)
    out = torch.where(t.kind == 1, u_int, out)
    out = torch.where(t.kind == 2, u_cat, out)
    return torch.where(t.kind == 3, torch.zeros_like(out), out)


def random_unit_from(
    tables: CodecTables, u: torch.Tensor, cat_idx: torch.Tensor
) -> torch.Tensor:
    """Compose uniform configuration vectors from ``u`` (uniforms in [0, 1),
    ``f32[n, d]``) and ``cat_idx`` (per-dim categorical draws, ``[n, d]``):
    float/int dims take ``u``, categorical/ordinal dims the index, constants
    0. Un-quantized; pass through :func:`quantize_unit` before evaluating."""
    out = torch.where(tables.kind == 2, cat_idx.to(_F32), u.to(_F32))
    return torch.where(tables.kind == 3, torch.zeros_like(out), out)


def random_unit(
    tables: CodecTables, generator: torch.Generator, n: int
) -> torch.Tensor:
    """``n`` uniform configuration vectors, ``f32[n, d]``, on ``tables``'
    device (``generator``'s): uniform unit for float/int dims, weighted
    categorical, uniform ordinal, 0 for constants. Categorical draws use
    the Gumbel-max trick over the codec's logits."""
    logits = tables.logits  # [d, kmax], -inf padded
    d, kmax = logits.shape
    u = torch.rand((n, d), generator=generator, device=tables.device)
    g = torch.rand((n, d, kmax), generator=generator, device=tables.device)
    gumbel = -torch.log(-torch.log(torch.clamp(g, min=1e-20)))
    idx = torch.argmax(logits[None] + gumbel, dim=-1)
    return random_unit_from(tables, u, idx)


def _decode_values(t: CodecTables, q: torch.Tensor) -> torch.Tensor:
    """Decode quantized unit vectors ``f32[n, d]`` to the numbers conditions
    compare against: floats/ints to their real value, categorical/ordinal
    dims to their choice INDEX (value-level comparisons are resolved to
    indices at compile time), constants to 0."""
    v_lin = t.lo + q * (t.hi - t.lo)
    v_log = torch.exp(t.log_lo + q * (t.log_hi - t.log_lo))
    v_float = torch.where(t.is_log, v_log, v_lin)
    vi_lin = t.lo - 0.5 + q * t.n_int
    vi_log = torch.exp(t.log_ilo + q * (t.log_ihi - t.log_ilo))
    v_int = torch.minimum(
        torch.maximum(torch.round(torch.where(t.is_log, vi_log, vi_lin)), t.lo), t.hi
    )
    out = torch.where(t.kind == 0, v_float, q)
    out = torch.where(t.kind == 1, v_int, out)
    out = torch.where(t.kind == 2, torch.round(q), out)
    return torch.where(t.kind == 3, torch.zeros_like(out), out)


def _all(terms: List[torch.Tensor]) -> torch.Tensor:
    return functools.reduce(torch.logical_and, terms)


def _any(terms: List[torch.Tensor]) -> torch.Tensor:
    return functools.reduce(torch.logical_or, terms)


def compile_active_mask(configspace, tables: CodecTables):
    """Compile the space's condition DAG to a batched activity predicate.

    Returns ``mask_fn(q: f32[n, d]) -> bool[n, d]`` deciding, from QUANTIZED
    unit vectors, which dims are conditionally active: the device twin of
    ``ConfigurationSpace._active_set`` (a child is active iff every
    condition on it holds, and a condition on an inactive parent is false).
    The conditions are evaluated column by column over the whole batch, in
    topological order, so a parent's activity is decided before any of its
    children. ``tables`` are the space's codec constants, on the device the
    mask runs on.

    Raises ``ValueError`` for condition forms without a numeric device
    representation: an order comparison on a categorical parent, or on a
    non-numeric or unsorted ordinal, and an unknown condition type.
    """
    from hpbandster_tpu_torch.space.conditions import (
        AndConjunction,
        EqualsCondition,
        GreaterThanCondition,
        InCondition,
        LessThanCondition,
        NotEqualsCondition,
        OrConjunction,
    )
    from hpbandster_tpu_torch.space.hyperparameters import (
        CategoricalHyperparameter,
        OrdinalHyperparameter,
    )

    names = configspace.get_hyperparameter_names()
    index = {n: i for i, n in enumerate(names)}
    hp_by_name = dict(zip(names, configspace.get_hyperparameters()))

    def ordinal_order_value(parent_name: str, value) -> float:
        """Greater/Less on an ordinal compares VALUES on the host; here the
        indices are compared, which is order-faithful only if the sequence
        is numerically sorted."""
        seq = hp_by_name[parent_name].sequence
        try:
            numeric = [float(v) for v in seq]
        except (TypeError, ValueError):
            raise ValueError(
                f"device conditions need a numeric ordinal sequence for "
                f"order comparisons on {parent_name!r}"
            ) from None
        if numeric != sorted(numeric):
            raise ValueError(
                f"ordinal {parent_name!r} is not numerically sorted; order "
                f"comparisons have no index representation"
            )
        return float(hp_by_name[parent_name].index(value))

    def compile_cond(c):
        if isinstance(c, (AndConjunction, OrConjunction)):
            subs = [compile_cond(x) for x in c.components]
            join = _all if isinstance(c, AndConjunction) else _any
            return lambda dec, act: join([f(dec, act) for f in subs])
        simple = (EqualsCondition, NotEqualsCondition, InCondition,
                  GreaterThanCondition, LessThanCondition)
        if not isinstance(c, simple):
            raise ValueError(
                f"condition type {type(c).__name__} has no device compilation"
            )
        j = index[c.parent_name]
        parent_hp = hp_by_name[c.parent_name]
        if isinstance(c, EqualsCondition):
            v = _value_to_number(parent_hp, c.value)
            test = lambda x: x == v  # noqa: E731
        elif isinstance(c, NotEqualsCondition):
            v = _value_to_number(parent_hp, c.value)
            test = lambda x: x != v  # noqa: E731
        elif isinstance(c, InCondition):
            vals = [_value_to_number(parent_hp, v) for v in c.value]
            test = lambda x: _any([x == v for v in vals])  # noqa: E731
        else:
            # the decoded number of a categorical dim is its choice INDEX;
            # comparing a raw value against it would build a wrong mask
            if isinstance(parent_hp, CategoricalHyperparameter):
                raise ValueError(
                    f"order condition on categorical parent "
                    f"{c.parent_name!r} has no device representation"
                )
            v = (
                ordinal_order_value(c.parent_name, c.value)
                if isinstance(parent_hp, OrdinalHyperparameter)
                else float(c.value)
            )
            if isinstance(c, GreaterThanCondition):
                test = lambda x: x > v  # noqa: E731
            else:
                test = lambda x: x < v  # noqa: E731
        return lambda dec, act: act[j] & test(dec[:, j])

    topo = configspace._topological_order()
    per_dim = [
        (index[name], [compile_cond(c) for c in configspace.get_conditions()
                       if c.child_name == name])
        for name in topo
    ]

    def mask_fn(q: torch.Tensor) -> torch.Tensor:
        dec = _decode_values(tables, q)
        ones = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
        act = [ones] * len(names)  # one column per dim
        for j, conds in per_dim:
            for fn in conds:
                act[j] = act[j] & fn(dec, act)
        return torch.stack(act, dim=1)

    return mask_fn


def _value_to_number(hp, value) -> float:
    """A condition's or clause's comparison value in the decoded-number
    domain of :func:`_decode_values` for ``hp``'s dim."""
    from hpbandster_tpu_torch.space.hyperparameters import (
        CategoricalHyperparameter,
        Constant,
        OrdinalHyperparameter,
    )

    if isinstance(hp, (CategoricalHyperparameter, OrdinalHyperparameter)):
        return float(hp.index(value))  # compare by choice index
    if isinstance(hp, Constant):
        return 0.0 if value == hp.value else float("nan")  # never equal
    return float(value)


def compile_forbidden_mask(configspace, tables: CodecTables):
    """Compile the space's forbidden clauses to a batched predicate.

    Returns ``forbidden_fn(q: f32[n, d], act: bool[n, d]) -> bool[n]``, True
    where a QUANTIZED vector violates any forbidden clause: the device twin
    of ``ConfigurationSpace.is_forbidden``. A clause term on an inactive dim
    is False (the host sees only active values). Equality on a continuous
    dim is float32-tolerant: ``1e-5·|v|`` on log dims, ``1e-5·max(hi - lo,
    |lo|, |hi|)`` on linear dims (the decode's error model per scale kind);
    discrete dims compare their choice indices exactly. ``tables`` as for
    :func:`compile_active_mask`.

    Raises ``ValueError`` for a clause type without a device compilation
    and for a clause on an unknown parameter.
    """
    from hpbandster_tpu_torch.space.forbidden import (
        ForbiddenAndConjunction,
        ForbiddenEqualsClause,
        ForbiddenInClause,
    )
    from hpbandster_tpu_torch.space.hyperparameters import UniformFloatHyperparameter

    names = configspace.get_hyperparameter_names()
    index = {n: i for i, n in enumerate(names)}
    hp_by_name = dict(zip(names, configspace.get_hyperparameters()))

    def eq_term(name: str, value):
        if name not in index:
            raise ValueError(f"forbidden clause on unknown parameter {name!r}")
        j = index[name]
        hp = hp_by_name[name]
        v = _value_to_number(hp, value)
        if not isinstance(hp, UniformFloatHyperparameter):
            return lambda dec, act: act[:, j] & (dec[:, j] == v)
        lo, hi = float(hp.lower), float(hp.upper)
        if hp.log:
            tol = 1e-5 * max(abs(v), 1e-30)
        else:
            tol = 1e-5 * max(hi - lo, abs(lo), abs(hi))
        return lambda dec, act: act[:, j] & (torch.abs(dec[:, j] - v) <= tol)

    def compile_clause(c):
        if isinstance(c, ForbiddenAndConjunction):
            subs = [compile_clause(x) for x in c.components]
            return lambda dec, act: _all([f(dec, act) for f in subs])
        if isinstance(c, ForbiddenEqualsClause):
            return eq_term(c.name, c.value)
        if isinstance(c, ForbiddenInClause):
            terms = [eq_term(c.name, v) for v in c.values]
            return lambda dec, act: _any([f(dec, act) for f in terms])
        raise ValueError(
            f"forbidden clause type {type(c).__name__} has no device compilation"
        )

    clauses = [compile_clause(c) for c in configspace.get_forbiddens()]

    def forbidden_fn(q: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        if not clauses:
            return torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
        dec = _decode_values(tables, q)
        return _any([f(dec, act) for f in clauses])

    return forbidden_fn


def resample_forbidden(
    vectors: torch.Tensor,
    forbidden_fn: Callable,
    active_mask_fn: Optional[Callable],
    redraws: torch.Tensor,
    fallback: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rejection resampling of forbidden rows, the reference's fixed passes
    in closed form. ``redraws`` (``f32[passes, n, d]``, quantized) are the
    uniform vectors of every pass; in pass ``t`` a row still forbidden takes
    ``redraws[t]``, and a row forbidden after the last pass becomes
    ``fallback`` (a host-verified valid vector, ``f32[d]``). So each row
    ends as the first allowed vector of (its proposal, its redraws in pass
    order), or the fallback: one batched predicate over all of them gives
    the passes' result with no host wait and no pass-by-pass dispatch.
    Returns the vectors and ``bool[n]``, True for every row that was redrawn
    (its proposal was forbidden)."""
    passes, n, d = redraws.shape
    cands = torch.cat([vectors[None], redraws])  # [passes + 1, n, d]
    flat = cands.reshape(-1, d)
    active = (torch.ones_like(flat, dtype=torch.bool) if active_mask_fn is None
              else active_mask_fn(flat))
    allowed = ~forbidden_fn(flat, active).reshape(passes + 1, n)
    # argmax keeps the first maximum: the first allowed candidate
    first = torch.argmax(allowed.to(torch.uint8), dim=0)
    chosen = cands[first, torch.arange(n, device=vectors.device)]
    out = torch.where(allowed.any(dim=0)[:, None], chosen, fallback[None, :])
    return out, ~allowed[0]


def _fit_kde_pair_device(
    vecs: torch.Tensor,
    losses: torch.Tensor,
    n_good: int,
    n_bad: int,
    cards: torch.Tensor,
    min_bandwidth: float,
    impute_draws=None,
) -> Tuple[KDE, KDE]:
    """Stable sort by loss, top ``n_good`` / bottom ``n_bad`` rows,
    normal-reference bandwidths (the host model's ``_fit_kde_pair``).
    Conditional spaces pass ``impute_draws``, the good and the bad side's
    ``(u, u_fb)`` uniforms (each ``f32[rows, d]``): NaN (inactive) dims are
    then donor-imputed per split side, like the host model."""
    n = vecs.shape[0]
    order = torch.argsort(losses, stable=True)
    good = vecs[order[:n_good]]
    bad = vecs[order[n - n_bad:]]
    if impute_draws is not None:
        (u_g, fb_g), (u_b, fb_b) = impute_draws
        good = impute_conditional_masked(good, cards, u_g, fb_g)
        bad = impute_conditional_masked(bad, cards, u_b, fb_b)

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


class SweepIncumbent(NamedTuple):
    """The ``incumbent_only=True`` sweep's whole output: the best
    final-stage (largest-budget) loss over every bracket, crashed (NaN)
    rows ranked behind any real loss, so an all-crashed sweep still
    returns a row (with a NaN loss)."""

    #: the winning configuration's quantized vector, f32[d]
    vector: torch.Tensor
    #: its final-stage loss (NaN = every candidate crashed), f32[]
    loss: torch.Tensor
    #: which bracket (index into ``plans``) produced it, i32[]
    bracket: torch.Tensor
    #: each bracket's best final-stage loss, f32[len(plans)]
    per_bracket_loss: torch.Tensor


class ResidentSweepOutputs(NamedTuple):
    """Full outputs of a ``resident=True`` sweep: ``stacked`` holds one
    :class:`SweepBracketOutput` per rotation position whose leaves carry a
    leading round axis, ``tail`` the outputs of the partial last round.
    :func:`unstack_resident_outputs` flattens both into the unrolled
    sweep's per-bracket list."""

    stacked: Tuple[SweepBracketOutput, ...]
    tail: Tuple[SweepBracketOutput, ...]


class DeviceMetrics(NamedTuple):
    """The sweep's telemetry, accumulated on the device: every leaf is sized
    by the schedule (brackets x rungs x bins), never by the config count.
    Rows beyond a bracket's rung count keep their initial values; the
    decoder (``obs.device_metrics.decode_device_metrics``) walks the plan
    shapes and never reads them."""

    #: per-(bracket, rung) loss histogram over the schema's bins; NaN
    #: (crashed) losses are counted in ``crashes`` instead
    loss_hist: torch.Tensor   # i32[n_brackets, max_rungs, N_BINS]
    #: per-(bracket, rung) evaluations (the stage widths)
    evals: torch.Tensor       # i32[n_brackets, max_rungs]
    #: per-(bracket, rung) crashed (NaN-loss) evaluations
    crashes: torch.Tensor     # i32[n_brackets, max_rungs]
    #: per-(bracket, rung) configs promoted to the next rung (0 at the last)
    promotions: torch.Tensor  # i32[n_brackets, max_rungs]
    #: per bracket, 1 when its proposals came from a fit with an open gate
    model_fits: torch.Tensor  # i32[n_brackets]
    #: per-bracket best final-stage loss (NaN = every candidate crashed)
    best_final: torch.Tensor  # f32[n_brackets]
    #: per-(bracket, rung) position in the sweep's execution order (-1 =
    #: the rung never ran)
    rung_seq: torch.Tensor    # i32[n_brackets, max_rungs]


def init_device_metrics(
    n_brackets: int, max_rungs: int, n_bins: int, device=None
) -> DeviceMetrics:
    """Zeroed metrics on ``device``; ``best_final`` starts at NaN (no best
    yet) and ``rung_seq`` at -1 (no position yet)."""
    i32 = dict(dtype=torch.int32, device=device)
    return DeviceMetrics(
        loss_hist=torch.zeros((n_brackets, max_rungs, n_bins), **i32),
        evals=torch.zeros((n_brackets, max_rungs), **i32),
        crashes=torch.zeros((n_brackets, max_rungs), **i32),
        promotions=torch.zeros((n_brackets, max_rungs), **i32),
        model_fits=torch.zeros((n_brackets,), **i32),
        best_final=torch.full((n_brackets,), float("nan"), dtype=_F32, device=device),
        rung_seq=torch.full((n_brackets, max_rungs), -1, **i32),
    )


def init_lane_state(n_lanes: int, device=None) -> torch.Tensor:
    """A fresh per-lane incumbent carry for a continuous-batching program
    (``serve/continuous.py`` over ``ops.buckets.
    fused_sh_bracket_bucketed_packed_carry``): one rank-space float32 per
    lane on ``device``, +inf meaning the lane has observed nothing.

    In rank space a real loss is itself and a crashed (NaN) evaluation is
    ``_CRASH_RANK`` (behind every real loss, ahead of emptiness), so the
    fold is one ``minimum`` with no NaN case. :func:`decode_lane_state` maps
    it back on the host."""
    return torch.full((int(n_lanes),), float("inf"), dtype=_F32, device=device)


def decode_lane_state(carry) -> List[Optional[float]]:
    """Host decode of a rank-space lane carry: per lane the running
    incumbent loss, NaN for a lane that has only crashed, None for a lane
    that has observed nothing."""
    if isinstance(carry, torch.Tensor):
        carry = carry.detach().cpu().numpy()
    out: List[Optional[float]] = []
    for v in np.asarray(carry, np.float32):
        v = float(v)
        if v == float("inf"):
            out.append(None)
        elif v >= float(_CRASH_RANK):
            out.append(float("nan"))
        else:
            out.append(v)
    return out


def resident_rotation(plans: Sequence[BracketPlan]) -> Tuple[int, int, int]:
    """``(period, n_rounds, n_tail)`` of a bracket schedule: ``period`` is
    the smallest ``p`` with ``plans[i] == plans[i - p]`` for every ``i >=
    p`` (``len(plans)`` for an aperiodic schedule: one round), and ``n_tail
    = len(plans) - period * n_rounds`` brackets of the partial last round
    run after the rounds."""
    plans = [BracketPlan(tuple(p.num_configs), tuple(p.budgets)) for p in plans]
    n = len(plans)
    if n == 0:
        raise ValueError("resident rotation needs at least one bracket")
    period = n
    for cand in range(1, n):
        if all(plans[i] == plans[i - cand] for i in range(cand, n)):
            period = cand
            break
    n_rounds = n // period
    return period, n_rounds, n - period * n_rounds


def unstack_resident_outputs(
    raw: ResidentSweepOutputs, n_rounds: int
) -> List[SweepBracketOutput]:
    """Flatten a (fetched) :class:`ResidentSweepOutputs` into the unrolled
    sweep's per-bracket list, in bracket order (round-major over the
    rotation, then the tail)."""
    outs: List[SweepBracketOutput] = []
    for r in range(int(n_rounds)):
        for pos_out in raw.stacked:
            outs.append(SweepBracketOutput(*(leaf[r] for leaf in pos_out)))
    outs.extend(SweepBracketOutput(*o) for o in raw.tail)
    return outs


@functools.lru_cache(maxsize=None)
def _bin_edges_on(device: torch.device) -> torch.Tensor:
    """The metrics plane's bin edges as float32 on ``device``, uploaded
    once per device."""
    return torch.as_tensor(bin_edges().astype(np.float32), device=device)


class GeneratorDraws:
    """The sweep's default draws, all from one ``torch.Generator`` seeded
    with the run seed and consumed in bracket order.

    A draw source answers these questions per bracket ``b_i``: the uniform
    stage-0 vectors (:meth:`stage0`), the candidate set around the fitted
    good KDE (:meth:`candidates`), which proposals are model-based
    (:meth:`model_mask`) and, on conditional or forbidden spaces, the
    imputation uniforms of each split side (:meth:`impute`) and the
    uniform vectors of each forbidden-row redraw (:meth:`forbidden_redraw`).
    """

    def __init__(
        self,
        tables: CodecTables,
        seed: int,
        random_fraction: float,
        bandwidth_factor: float,
        min_bandwidth: float,
    ):
        self.tables = tables
        self.device = tables.device
        self.random_fraction = float(random_fraction)
        self.bandwidth_factor = float(bandwidth_factor)
        self.min_bandwidth = float(min_bandwidth)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def stage0(self, b_i: int, n0: int) -> torch.Tensor:
        return random_unit(self.tables, self.generator, n0)

    def candidates(self, b_i: int, good: KDE, total: int) -> torch.Tensor:
        return generate_candidates(
            self.generator, good, self.tables.vartypes, self.tables.cards, total,
            self.bandwidth_factor, self.min_bandwidth,
        )

    def model_mask(self, b_i: int, n0: int) -> torch.Tensor:
        u = torch.rand((n0,), generator=self.generator, device=self.device)
        return u >= self.random_fraction

    def impute(self, b_i: int, side: int, n: int, d: int):
        """``(u, u_fb)``, the donor and the fallback uniforms ``f32[n, d]``
        of split side ``side`` (0 good, 1 bad)."""
        u = torch.rand((2, n, d), generator=self.generator, device=self.device)
        return u[0], u[1]

    def forbidden_redraw(self, b_i: int, t: int, n0: int) -> torch.Tensor:
        """Redraw ``t``: ``n0`` uniform stage-0-style vectors, un-quantized."""
        return self.stage0(b_i, n0)


def _clone_tree(x):
    """A copy of every tensor in ``x`` (tensors, or dicts, lists, tuples
    and named tuples of them)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(_clone_tree, x))
    if isinstance(x, (list, tuple)):
        return type(x)(map(_clone_tree, x))
    return x


class _Sweep:
    """The callable :func:`make_fused_sweep_fn` returns.

    Where nothing is captured (the CPU, the static tier, ``_eager``) a
    call runs ``eager(seed, warm_v, warm_l, warm_n, draws)``. On a card the
    dynamic tiers' program is captured once (:meth:`prepare`, or the first
    call) and every call runs it through the ``run`` that ``capture()``
    returned. Calls on one sweep take turns: a call holds the sweep's lock
    from writing its inputs into the captured buffers to copying the
    outputs out of the graph's memory, and waits on the device for the
    previous call's copies, so two threads sharing a cached sweep never
    replay over each other's inputs or outputs, and a result stays valid
    after later calls. The graph is held here and nowhere else, so a sweep
    dropped from a cache frees its graph at once."""

    def __init__(self, eager, capture, device):
        self._eager = eager
        self._capture = capture
        self._device = device
        self._lock = threading.Lock()
        self._run = None
        self._done = None  # the previous call's copies, as a CUDA event
        #: the captured program (a :class:`~hpbandster_tpu_torch.ops.graphs.RoundGraph`)
        #: once captured; None where nothing is captured
        self.graph = None

    def prepare(self) -> None:
        """Capture the program now (a no-op where nothing is captured, and
        once captured)."""
        if self._capture is None:
            return
        with self._lock:
            self._prepare_locked()

    def _prepare_locked(self) -> None:
        if self.graph is None:
            self.graph, self._run = self._capture()

    def __call__(self, seed, warm_v=None, warm_l=None, warm_n=None, draws=None):
        if self._capture is None:
            return self._eager(seed, warm_v, warm_l, warm_n, draws)
        if draws is not None:
            raise ValueError(
                "the dynamic-count sweep on CUDA replays a captured program and "
                "takes the default draws only"
            )
        with self._lock:
            self._prepare_locked()
            stream = torch.cuda.current_stream(self._device)
            if self._done is not None:
                stream.wait_event(self._done)
            out = _clone_tree(self._run(seed, warm_v, warm_l, warm_n))
            self._done = torch.cuda.Event()
            self._done.record(stream)
        return out


def make_fused_sweep_fn(
    eval_fn: Optional[Callable[[torch.Tensor, float], torch.Tensor]],
    plans: Sequence[BracketPlan],
    codec: SpaceCodec,
    *,
    device,
    tables: Optional[CodecTables] = None,
    num_samples: int = 64,
    random_fraction: float = 1 / 3,
    top_n_percent: int = 15,
    min_points_in_model: Optional[int] = None,
    bandwidth_factor: float = 3.0,
    min_bandwidth: float = 1e-3,
    warm_counts: Optional[dict] = None,
    rank_fn: Optional[Callable] = None,
    active_mask_fn: Optional[Callable] = None,
    forbidden_fn: Optional[Callable] = None,
    fallback_vector: Optional[np.ndarray] = None,
    max_forbidden_retries: int = 8,
    dynamic_counts: bool = False,
    capacities: Optional[dict] = None,
    return_state: bool = False,
    resident: bool = False,
    mesh=None,
    shard_sampling: bool = False,
    incumbent_only: bool = False,
    device_metrics: bool = False,
    stateful_eval: Optional[StatefulEval] = None,
    _eager: bool = False,
) -> Callable[..., List[SweepBracketOutput]]:
    """Build the sweep; returns
    ``fn(seed, warm_v=None, warm_l=None, warm_n=None, draws=None)``.

    ``eval_fn(vectors f32[n, d], budget) -> f32[n]`` is batched. Model
    bookkeeping mirrors the reference: a budget's KDE pair exists once it
    holds ``min_points_in_model + 2`` observations and both split sides
    exceed ``d``; proposals use the largest such budget, refit at every
    bracket start from all observations so far. ``draws`` replaces the
    default :class:`GeneratorDraws` seeded with ``seed``. ``tables`` are
    ``codec``'s constants on ``device`` from their owner (``FusedBOHB``
    builds them once for all its chunks); without them the builder uploads
    its own.

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
    agree. ``return_state=True`` makes ``fn`` also return ``(obs_v, obs_l,
    counts)``, the end-of-sweep state the next chunk takes back as its warm
    inputs. Where the reference donates the warm buffers to that state,
    the port never writes to its inputs: it builds the state from them once
    and then updates it in place.

    ``rank_fn`` (``fused_sh_bracket``'s promotion scorer, e.g.
    ``ops.bracket.power_law_extrapolate``) replaces the raw stage loss as
    the promotion score. ``active_mask_fn`` (:func:`compile_active_mask`)
    makes the sweep conditional: evaluation sees 0 in inactive dims, the
    observations and outputs carry NaN there, and every KDE fit imputes
    them per split side. ``forbidden_fn`` (:func:`compile_forbidden_mask`)
    redraws forbidden proposals in ``max_forbidden_retries`` fixed passes
    (:func:`resample_forbidden`, all passes' draws tested at once) and
    clamps what is still forbidden to ``fallback_vector``, a host-verified
    valid configuration (numpy, or a tensor already on ``device``); a
    redrawn row is not model-based. Every tier takes all three.

    On CUDA the dynamic-count tier runs as one captured CUDA graph
    (``ops/graphs.py``, name ``sweep_chunk``) replayed once per call: the
    default draws only, since a replay cannot hand a bracket index to the
    host. ``fn.prepare()`` captures it (the first call does if nobody did);
    every call copies its warm inputs into the captured buffers, reseeds
    the graph's generator with ``seed`` and replays, so ``fn`` serves any
    number of calls with one capture. A call returns copies of the
    outputs and state, so they stay valid after later calls, and calls
    from several threads take turns (:class:`_Sweep`). ``_eager=True``
    runs the same body eagerly on CUDA (the graph's twin in the card's
    checks). On the CPU the body runs eagerly.

    ``resident=True`` (needs ``dynamic_counts=True``) runs the HyperBand
    rotation's repeating round of brackets round after round
    (:func:`resident_rotation`), the partial last round after them. On
    CUDA the round is the captured graph, replayed once per round over
    state that each call resets in place; the tail runs eagerly. ``fn``
    returns :class:`ResidentSweepOutputs`; flatten it with
    :func:`unstack_resident_outputs`. It equals the unrolled dynamic tier
    bit for bit on the same seed and capacities. On CUDA ``fn.graph`` is
    the :class:`~hpbandster_tpu_torch.ops.graphs.RoundGraph` once captured
    (capture, instantiate and replay times); otherwise None.

    ``incumbent_only=True`` makes ``fn`` return one
    :class:`SweepIncumbent` instead of per-bracket outputs.
    ``device_metrics=True`` accumulates a :class:`DeviceMetrics` through
    every bracket and ``fn`` returns ``(result, metrics)``, or ``(result,
    metrics, state)`` with ``return_state``; decode it with
    ``obs.device_metrics.decode_device_metrics``. ``stateful_eval`` (a
    :class:`~hpbandster_tpu_torch.ops.fused.StatefulEval`, exclusive with
    ``eval_fn``) trains each bracket's configs with warm continuation
    across its rungs; the lanes' state stays inside the bracket.

    Meshes (``mesh``, ``shard_sampling``) are not ported yet and raise
    ``NotImplementedError``.
    """
    if mesh is not None or shard_sampling:
        raise NotImplementedError(
            "meshes (mesh, shard_sampling) are not ported to the PyTorch sweep yet"
        )
    if (eval_fn is None) == (stateful_eval is None):
        raise ValueError(
            "provide exactly one evaluation seam: eval_fn (stateless) or "
            "stateful_eval (StatefulEval warm continuation)"
        )
    if forbidden_fn is not None and fallback_vector is None:
        raise ValueError("forbidden_fn requires a fallback_vector")
    if return_state and not dynamic_counts:
        raise ValueError(
            "return_state=True requires dynamic_counts=True: the static "
            "tier's counts are host ints, there is no reusable state"
        )
    if incumbent_only and not plans:
        raise ValueError("incumbent_only=True needs at least one bracket")
    if resident and not dynamic_counts:
        raise ValueError(
            "resident=True requires dynamic_counts=True: the rounds carry "
            "observation counts on the device"
        )
    if resident and not plans:
        raise ValueError("resident=True needs at least one bracket")
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

    if tables is None:
        tables = codec_tables(codec, device)
    # the kernels take the float32 vartypes and cards as they are
    vartypes_dev, cards_dev = tables.vartypes, tables.cards
    fallback_dev = (
        None if forbidden_fn is None
        else quantize_unit(
            tables, torch.as_tensor(fallback_vector, dtype=_F32, device=device)
        )
    )
    if device_metrics:
        dm_edges = _bin_edges_on(device)
        dm_rungs = max(len(p.num_configs) for p in plans) if plans else 0
        # each bracket's first rung's position in the execution order
        dm_seq_base = torch.as_tensor(
            np.cumsum([0] + [len(p.num_configs) for p in plans])[:-1],
            dtype=torch.int64, device=device,
        )

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

    def impute_draws(draws, b_i, n_good, n_bad):
        """The split sides' imputation uniforms, on conditional spaces."""
        if active_mask_fn is None:
            return None
        return (
            tuple(u.to(device) for u in draws.impute(b_i, 0, n_good, d)),
            tuple(u.to(device) for u in draws.impute(b_i, 1, n_bad, d)),
        )

    def dynamic_proposals(b_i, draws, obs_v, obs_l, counts, rand_vecs, n0):
        """Largest-trained-budget choice, fit and proposal, all on the
        device. Budget priority is a descending loop; the chosen budget's
        buffer is widened to ``capmax`` so one fit serves whichever budget
        wins. With no gate open the fit runs on empty buffers (finite, the
        donor draw is :func:`~hpbandster_tpu_torch.ops.kde._masked_donors`)
        and the mask discards every model pick, like the static tier's
        all-random bracket. Also returns whether a gate was open."""
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
            impute_draws=impute_draws(draws, b_i, capmax, capmax),
        )
        cands = draws.candidates(b_i, good, n0 * num_samples)
        model_vecs = propose_from_candidates(
            cands, good, bad, vartypes_dev, cards_dev, n0
        )
        mb_mask = any_model & draws.model_mask(b_i, n0).to(device)
        return torch.where(mb_mask[:, None], model_vecs, rand_vecs), mb_mask, any_model

    if resident:
        period, n_rounds, _ = resident_rotation(plans)
        round_plans = plans[:period]
        tail_plans = plans[period * n_rounds:]

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
            have = _has_warm(b, warm_v, warm_l, warm_n)
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

    def init_incumbent():
        """The cross-bracket incumbent carry, updated in place: (rank key,
        loss, vector, bracket, per-bracket best), scalars as one-element
        tensors."""
        return (
            torch.full((1,), float("inf"), dtype=_F32, device=device),
            torch.full((1,), float("nan"), dtype=_F32, device=device),
            torch.zeros((d,), dtype=_F32, device=device),
            torch.full((1,), -1, dtype=torch.int32, device=device),
            torch.zeros((len(plans),), dtype=_F32, device=device),
        )

    def best_row(losses: torch.Tensor) -> torch.Tensor:
        """Index (``int64[1]``) of the best loss, crashes ranked behind any
        real loss; the first on ties, like ``jnp.argmin``."""
        key = torch.where(torch.isnan(losses),
                          torch.full_like(losses, float(_CRASH_RANK)), losses)
        return torch.argmin(key).view(1)

    def run_bracket(b_i, b_idx, plan, draws, obs_v, obs_l, counts, inc, metrics):
        """One bracket: sample/propose -> forbidden resampling -> rung
        ladder -> observation append -> incumbent fold -> metrics. Updates
        ``obs_v``/``obs_l``/``counts`` (dynamic counts in place), ``inc`` and
        ``metrics`` in place, so a captured bracket carries its state into
        the next replay. ``b_i`` is the bracket's index for the draw
        source (None inside a graph, where the default draws ignore it);
        ``b_idx`` (``int64[1]`` on the device) is the row the incumbent and
        the metrics write. Returns the :class:`SweepBracketOutput`, or None
        under ``incumbent_only``."""
        n0 = plan.num_configs[0]
        rand_vecs = draws.stage0(b_i, n0).to(device)
        # the metrics' refit flag: was the model gate open this bracket
        fit_flag = None
        if dynamic_counts:
            if any_trainable:
                proposals, mb_mask, any_model = dynamic_proposals(
                    b_i, draws, obs_v, obs_l, counts, rand_vecs, n0
                )
                fit_flag = any_model.to(torch.int32)
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
                fit_flag = torch.ones((), dtype=torch.int32, device=device)
                n = counts[model_budget]
                n_good, n_bad = trained_split(n)
                good, bad = _fit_kde_pair_device(
                    obs_v[model_budget][:n], obs_l[model_budget][:n],
                    n_good, n_bad, cards_dev, min_bandwidth,
                    impute_draws=impute_draws(draws, b_i, n_good, n_bad),
                )
                cands = draws.candidates(b_i, good, n0 * num_samples)
                model_vecs = propose_from_candidates(
                    cands, good, bad, vartypes_dev, cards_dev, n0
                )
                mb_mask = draws.model_mask(b_i, n0).to(device)
                proposals = torch.where(mb_mask[:, None], model_vecs, rand_vecs)

        vectors = quantize_unit(tables, proposals)
        if forbidden_fn is not None:
            redraws = torch.stack([draws.forbidden_redraw(b_i, t, n0).to(device)
                                   for t in range(max_forbidden_retries)])
            vectors, resampled = resample_forbidden(
                vectors, forbidden_fn, active_mask_fn,
                quantize_unit(tables, redraws), fallback_dev,
            )
            # a redrawn or clamped row is uniform (or the fallback), not a
            # model pick
            mb_mask = mb_mask & ~resampled
        if active_mask_fn is not None:
            # evaluation sees 0 in inactive dims (the host's to_vector ->
            # NaN -> 0), while observations and outputs carry NaN, so the
            # host decoder and the fit's imputation see the activity pattern
            active = active_mask_fn(vectors)
            eval_vectors = torch.where(active, vectors, torch.zeros_like(vectors))
            out_vectors = torch.where(active, vectors, torch.full_like(vectors, float("nan")))
        else:
            eval_vectors = out_vectors = vectors
        stages = fused_sh_bracket(
            eval_fn, eval_vectors, plan.num_configs, plan.budgets, rank_fn=rank_fn,
            stateful=stateful_eval,
        )
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
                obs_v[b].index_copy_(0, rows, out_vectors[idx_s])
                obs_l[b].index_copy_(0, rows, upd_l)
                c.add_(k_s)
            else:
                obs_v[b][c:c + k_s] = out_vectors[idx_s]
                obs_l[b][c:c + k_s] = upd_l
                counts[b] = c + k_s

        idx_fin, loss_fin = stages[-1]
        if metrics is not None or incumbent_only:
            a_fin = best_row(loss_fin)
        if metrics is not None:
            depth = len(plan.num_configs)
            for s, ((_, losses_s), k_s) in enumerate(zip(stages, plan.num_configs)):
                hist, crashes = stage_telemetry(losses_s, dm_edges)
                metrics.loss_hist[:, s].index_copy_(0, b_idx, hist[None])
                metrics.evals[:, s].index_fill_(0, b_idx, k_s)
                metrics.crashes[:, s].index_copy_(0, b_idx, crashes.view(1))
                metrics.promotions[:, s].index_fill_(
                    0, b_idx, plan.num_configs[s + 1] if s + 1 < depth else 0)
                metrics.rung_seq[:, s].index_copy_(
                    0, b_idx, (dm_seq_base.index_select(0, b_idx) + s).to(torch.int32))
            if fit_flag is not None:
                metrics.model_fits.index_copy_(0, b_idx, fit_flag.view(1))
            metrics.best_final.index_copy_(0, b_idx, loss_fin.gather(0, a_fin))

        if incumbent_only:
            # fold the bracket's best final-stage row into the running
            # incumbent; crashes rank behind every real loss
            best_key, best_loss, best_vec, best_bracket, per_bracket = inc
            cand_loss = loss_fin.gather(0, a_fin)
            cand_key = torch.where(torch.isnan(cand_loss),
                                   torch.full_like(cand_loss, float(_CRASH_RANK)),
                                   cand_loss)
            take = cand_key < best_key
            best_key.copy_(torch.where(take, cand_key, best_key))
            best_loss.copy_(torch.where(take, cand_loss, best_loss))
            best_vec.copy_(torch.where(
                take, out_vectors.index_select(0, idx_fin.gather(0, a_fin))[0], best_vec))
            best_bracket.copy_(torch.where(take, b_idx.to(torch.int32), best_bracket))
            per_bracket.index_copy_(0, b_idx, cand_loss)
            return None
        idx_packed, loss_packed = _pack_stages(stages)
        return SweepBracketOutput(out_vectors[:n0], mb_mask, idx_packed, loss_packed)

    def make_round(draws, state, inc, metrics):
        """The rotation's round over the carried state: the ``[n_rounds,
        ...]`` output buffers it writes at a device round index, that
        index, and the round's body (``r`` is the round for the draw
        source; None inside a graph)."""
        obs_v, obs_l, counts = state
        r_idx = torch.zeros(1, dtype=torch.int64, device=device)
        stacked = []
        if not incumbent_only:
            for plan in round_plans:
                n0, total = plan.num_configs[0], sum(plan.num_configs)
                stacked.append(SweepBracketOutput(
                    torch.empty((n_rounds, n0, d), dtype=_F32, device=device),
                    torch.empty((n_rounds, n0), dtype=torch.bool, device=device),
                    torch.empty((n_rounds, total), dtype=torch.int64, device=device),
                    torch.empty((n_rounds, total), dtype=_F32, device=device),
                ))

        def round_body(r=None):
            for pos, plan in enumerate(round_plans):
                out = run_bracket(
                    None if r is None else r * period + pos, r_idx * period + pos,
                    plan, draws, obs_v, obs_l, counts, inc, metrics,
                )
                if out is not None:
                    for buf, leaf in zip(stacked[pos], out):
                        buf.index_copy_(0, r_idx, leaf[None])
            r_idx.add_(1)

        return r_idx, tuple(stacked), round_body

    def run_tail(draws, row, state, inc, metrics):
        """The partial last round, eagerly, after the rounds."""
        tail = []
        for j, plan in enumerate(tail_plans):
            b_i = period * n_rounds + j
            out = run_bracket(b_i, row(b_i), plan, draws, *state, inc, metrics)
            if out is not None:
                tail.append(out)
        return tuple(tail)

    def run_unrolled(draws, row, state, inc, metrics):
        return [run_bracket(b_i, row(b_i), plan, draws, *state, inc, metrics)
                for b_i, plan in enumerate(plans)]

    def package(result, inc, metrics, state):
        if incumbent_only:
            best_key, best_loss, best_vec, best_bracket, per_bracket = inc
            result = SweepIncumbent(best_vec, best_loss[0], best_bracket[0], per_bracket)
        out = (result,) + ((metrics,) if device_metrics else ())
        if return_state:
            out += (state,)
        return out if len(out) > 1 else result

    def row_fn():
        # the brackets' rows for the incumbent and the metrics, made on the
        # device rather than uploaded
        rows = (torch.arange(len(plans), device=device)
                if incumbent_only or device_metrics else None)
        return lambda b_i: None if rows is None else rows[b_i:b_i + 1]

    def fresh_metrics():
        return (init_device_metrics(len(plans), dm_rungs, N_BINS, device)
                if device_metrics else None)

    def eager_sweep(seed, warm_v, warm_l, warm_n, draws):
        if draws is None:
            draws = GeneratorDraws(
                tables, int(seed), random_fraction, bandwidth_factor, min_bandwidth
            )
        state = init_obs_state(warm_v, warm_l, warm_n)
        inc = init_incumbent() if incumbent_only else None
        metrics = fresh_metrics()
        row = row_fn()
        if resident:
            _, stacked, round_body = make_round(draws, state, inc, metrics)
            for r in range(n_rounds):
                round_body(r)
            result = ResidentSweepOutputs(stacked, run_tail(draws, row, state, inc, metrics))
        else:
            result = run_unrolled(draws, row, state, inc, metrics)
        return package(result, inc, metrics, state)

    def capture():
        """On a card, the dynamic tiers' program captured once: the chunk's
        brackets as one graph, or the resident round. Returns the graph and
        ``run(seed, warm_v, warm_l, warm_n)``, which writes a call's inputs
        into the buffers made here, reseeds, replays and returns the
        outputs."""
        from hpbandster_tpu_torch.ops.graphs import RoundGraph

        draws = GeneratorDraws(tables, 0, random_fraction, bandwidth_factor, min_bandwidth)
        row = row_fn()
        caps_sig = ",".join(f"{b:g}:{c}" for b, c in sorted(caps.items()))
        flags = "".join(f" {k}" for k, on in (("metrics", device_metrics),
                                             ("incumbent", incumbent_only)) if on)
        if resident:
            # the carried state, reset in place by every call
            state = init_obs_state(None, None, None)
            inc = init_incumbent() if incumbent_only else None
            metrics = fresh_metrics()
            r_idx, stacked, round_body = make_round(draws, state, inc, metrics)
            graph = RoundGraph(round_body, device, generators=[draws.generator],
                               signature=_sig(caps_sig, round_plans, flags))

            def run(seed, warm_v, warm_l, warm_n):
                _copy_into(state, init_obs_state(warm_v, warm_l, warm_n))
                if inc is not None:
                    _copy_into(inc, init_incumbent())
                if metrics is not None:
                    _copy_into(metrics, fresh_metrics())
                r_idx.zero_()
                graph.reseed(seed)
                for _ in range(n_rounds):
                    graph.replay()
                tail = run_tail(draws, row, state, inc, metrics)
                return package(ResidentSweepOutputs(stacked, tail), inc, metrics, state)

            return graph, run
        # the warm inputs the captured chunk starts from; it builds its
        # state, incumbent and metrics from them inside the graph
        inp_v = {b: torch.zeros((cap, d), dtype=_F32, device=device) for b, cap in caps.items()}
        inp_l = {b: torch.full((cap,), float("inf"), dtype=_F32, device=device)
                 for b, cap in caps.items()}
        inp_n = {b: torch.zeros((), dtype=torch.int32, device=device) for b in caps}
        holder = {}

        def chunk_body():
            state = init_obs_state(inp_v, inp_l, inp_n)
            inc = init_incumbent() if incumbent_only else None
            metrics = fresh_metrics()
            holder["out"] = package(run_unrolled(draws, row, state, inc, metrics),
                                    inc, metrics, state)

        graph = RoundGraph(chunk_body, device, generators=[draws.generator],
                           name="sweep_chunk", signature=_sig(caps_sig, plans, flags))

        def run(seed, warm_v, warm_l, warm_n):
            for b in caps:
                if _has_warm(b, warm_v, warm_l, warm_n):
                    inp_v[b].copy_(torch.as_tensor(warm_v[b]))
                    inp_l[b].copy_(torch.as_tensor(warm_l[b]))
                    inp_n[b].copy_(torch.as_tensor(warm_n[b]))
                else:
                    inp_v[b].zero_()
                    inp_l[b].fill_(float("inf"))
                    inp_n[b].zero_()
            graph.reseed(seed)
            graph.replay()
            return holder["out"]

        return graph, run

    graphed = device.type == "cuda" and dynamic_counts and not _eager
    return _Sweep(eager_sweep, capture if graphed else None, device)
