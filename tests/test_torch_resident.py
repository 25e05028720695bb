"""The resident tier on the CPU: the rotation helpers, the resident sweep
against the port's unrolled dynamic tier and against the reference's
resident sweep, and the optimizer's ``run(resident=True)`` and
``run_incumbent``.

On the CPU the resident round runs eagerly, round after round, through the
same body a card captures into a CUDA graph: the state it carries is
updated in place and each round's outputs land in ``[n_rounds, ...]``
buffers at a device round index. Tolerances: the port's resident sweep
equals its unrolled dynamic sweep bit for bit (same code, same draws);
against the reference's resident sweep, on the reference's draws, the
dynamic tier's parity tolerances hold (``tests/test_torch_dynamic.py``:
vectors ``1e-6``, model masks and stage indices exact, losses
``LOSS_TOL``).
"""

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch import FusedBOHB, space as tspace
from hpbandster_tpu_torch.ops.bracket import BracketPlan
from hpbandster_tpu_torch.ops.sweep import (
    ResidentSweepOutputs,
    SweepBracketOutput,
    build_space_codec,
    make_fused_sweep_fn,
    plan_additions,
    pow2_capacities,
    resident_rotation,
    unstack_resident_outputs,
)
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_conditions import cond_loss
from tests.test_torch_conditions_sweep import (
    LOSS_TOL as COND_LOSS_TOL,
    assert_conditional_sweeps_match,
    run_conditional_pair,
)
from tests.test_torch_dynamic import assert_states_match
from tests.test_torch_harness import ReferenceDraws, codecs, cond_space, eval_fns, plans_for, ref  # noqa: F401
from tests.test_torch_sweep import LOSS_TOL, NUM_SAMPLES, _assert_sweeps_match

#: schedules of the rotation cases: (name, plans as (num_configs, budgets))
SCHEDULES = {
    "periodic": [((9, 3, 1), (1.0, 3.0, 9.0)), ((5, 1), (3.0, 9.0)), ((3,), (9.0,))] * 2,
    "tailed": [((9, 3, 1), (1.0, 3.0, 9.0)), ((5, 1), (3.0, 9.0)), ((3,), (9.0,))] * 2
    + [((9, 3, 1), (1.0, 3.0, 9.0))],
    "aperiodic": [((9, 3), (1.0, 3.0)), ((4, 2), (1.0, 3.0)), ((5,), (3.0,))],
    "one_bracket": [((9, 3), (1.0, 3.0))],
    "hyperband_27": [(p.num_configs, p.budgets) for p in plans_for(9)],
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_rotation_and_unstack_match_reference(ref, name):
    """``resident_rotation`` gives the reference's ``(period, n_rounds,
    n_tail)``, and ``unstack_resident_outputs`` flattens the same stacked
    outputs into the same per-bracket list (exact)."""
    shapes = SCHEDULES[name]
    got = resident_rotation([BracketPlan(*s) for s in shapes])
    want = ref.sweep.resident_rotation([ref.bracket.BracketPlan(*s) for s in shapes])
    assert got == tuple(want)
    period, n_rounds, n_tail = got
    rng = np.random.default_rng(len(shapes))

    def leaves(lead, nc):
        n0, total = nc[0], sum(nc)
        return (rng.normal(size=lead + (n0, 2)).astype(np.float32),
                rng.uniform(size=lead + (n0,)) < 0.5,
                rng.integers(0, n0, size=lead + (total,)),
                rng.normal(size=lead + (total,)).astype(np.float32))

    stacked = [leaves((n_rounds,), shapes[i][0]) for i in range(period)]
    tail = [leaves((), shapes[period * n_rounds + j][0]) for j in range(n_tail)]
    mine = unstack_resident_outputs(ResidentSweepOutputs(
        tuple(SweepBracketOutput(*x) for x in stacked),
        tuple(SweepBracketOutput(*x) for x in tail)), n_rounds)
    theirs = ref.sweep.unstack_resident_outputs(ref.sweep.ResidentSweepOutputs(
        tuple(ref.sweep.SweepBracketOutput(*x) for x in stacked),
        tuple(ref.sweep.SweepBracketOutput(*x) for x in tail)), n_rounds)
    assert len(mine) == len(theirs) == len(shapes)
    for m, t in zip(mine, theirs):
        for a, b in zip(m, t):
            np.testing.assert_array_equal(a, b)


def test_empty_schedule_raises(ref):
    with pytest.raises(ValueError, match="at least one bracket"):
        resident_rotation([])
    with pytest.raises(ValueError):
        ref.sweep.resident_rotation([])


# ------------------------------------------------ resident against unrolled
def _branin_pair(plans, num_samples=16, **modes):
    codec = build_space_codec(branin_space(seed=0))
    kw = dict(device="cpu", num_samples=num_samples, dynamic_counts=True,
              capacities=pow2_capacities(plan_additions(plans)), return_state=True,
              **modes)
    return (make_fused_sweep_fn(branin, plans, codec, **kw),
            make_fused_sweep_fn(branin, plans, codec, resident=True, **kw))


def _assert_bitwise(a, b):
    """Equal structure, dtypes, shapes and bits (NaN where NaN)."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.is_floating_point():
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            a, b = torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_bitwise(a[k], b[k])
    else:
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_bitwise(x, y)


@pytest.mark.parametrize("n_iterations", [4, 9, 11])
def test_resident_equals_unrolled_bit_for_bit(n_iterations):
    """One round, two rounds and a tail, two rounds and three tail brackets
    at max budget 27: every bracket's outputs and the end state equal the
    unrolled dynamic sweep's bit for bit."""
    plans = plans_for(n_iterations)
    unrolled, resident = _branin_pair(plans)
    outs_u, state_u = unrolled(11)
    raw, state_r = resident(11)
    _, n_rounds, n_tail = resident_rotation(plans)
    assert len(raw.tail) == n_tail and all(leaf.shape[0] == n_rounds
                                           for pos in raw.stacked for leaf in pos)
    _assert_bitwise(unstack_resident_outputs(raw, n_rounds), outs_u)
    _assert_bitwise(state_r, state_u)
    assert resident.graph is None  # no graph on the CPU


def test_resident_conditional_equals_unrolled_bit_for_bit():
    """The conditional space with its forbidden clause (masks, the
    resampling and the per-side imputation inside the round): two rounds
    and a tail at max budget 9, bit for bit."""
    from hpbandster_tpu_torch.ops.sweep import (
        codec_tables,
        compile_active_mask,
        compile_forbidden_mask,
    )
    from tests.test_torch_conditions_sweep import FALLBACK

    cs = cond_space(tspace)
    codec = build_space_codec(cs)
    tables = codec_tables(codec, "cpu")
    plans = plans_for(7, max_budget=9.0)
    kw = dict(device="cpu", tables=tables, num_samples=16, dynamic_counts=True,
              capacities=pow2_capacities(plan_additions(plans)), return_state=True,
              active_mask_fn=compile_active_mask(cs, tables),
              forbidden_fn=compile_forbidden_mask(cs, tables), fallback_vector=FALLBACK)
    outs_u, state_u = make_fused_sweep_fn(cond_loss, plans, codec, **kw)(5)
    raw, state_r = make_fused_sweep_fn(cond_loss, plans, codec, resident=True, **kw)(5)
    _assert_bitwise(unstack_resident_outputs(raw, resident_rotation(plans)[1]), outs_u)
    _assert_bitwise(state_r, state_u)
    assert any(bool(torch.isnan(o.vectors).any()) for o in outs_u)


@pytest.mark.parametrize("resident", [False, True])
def test_incumbent_and_metrics_equal_across_tiers(resident):
    """``incumbent_only`` and ``device_metrics`` give the same leaves on the
    resident tier as on the unrolled one (exact), and the incumbent is the
    best final-stage row of the full outputs."""
    plans = plans_for(9)
    outs, _ = _branin_pair(plans)[0](3)
    fns = _branin_pair(plans, incumbent_only=True, device_metrics=True)
    inc_u, dm_u, _ = fns[0](3)
    inc, dm, _ = fns[int(resident)](3)
    _assert_bitwise(inc, inc_u)
    _assert_bitwise(dm, dm_u)
    finals = [o.loss_packed[-p.num_configs[-1]:] for o, p in zip(outs, plans)]
    best = [f.min() for f in finals]
    assert torch.equal(inc.per_bracket_loss, torch.stack(best))
    b = int(torch.argmin(inc.per_bracket_loss))
    assert int(inc.bracket) == b and float(inc.loss) == float(best[b])
    o, p = outs[b], plans[b]
    row = o.idx_packed[-p.num_configs[-1]:][int(torch.argmin(finals[b]))]
    assert torch.equal(inc.vector, o.vectors[row])
    assert torch.equal(dm.best_final, inc.per_bracket_loss)


# ---------------------------------------------------- against the reference
def _resident_pair(ref, name, n_iterations, seed=1234):
    rc, codec = codecs(ref, name)
    ref_eval, port_eval = eval_fns(ref, name)
    plans = plans_for(n_iterations)
    kw = dict(num_samples=NUM_SAMPLES, dynamic_counts=True,
              capacities=pow2_capacities(plan_additions(plans)), return_state=True,
              resident=True)
    want = ref.sweep.make_fused_sweep_fn(
        ref_eval, plans, rc, use_pallas=True, pallas_interpret=True, **kw
    )(np.uint32(seed))
    got = make_fused_sweep_fn(port_eval, plans, codec, device="cpu", **kw)(
        seed, draws=ReferenceDraws(ref, rc, seed))
    return plans, want, got


def test_resident_sweep_matches_reference(ref, monkeypatch):
    """Branin, max budget 27, nine brackets (two rounds of four and a tail),
    on the reference's draws: the port's resident sweep against the
    reference's ``lax.scan`` one, bracket by bracket and the end state."""
    monkeypatch.delenv("HPB_PALLAS_KDE_FIT", raising=False)
    plans, (want, want_state), (got, got_state) = _resident_pair(ref, "branin", 9)
    n_rounds = resident_rotation(plans)[1]
    want = ref.sweep.unstack_resident_outputs(want, n_rounds)
    n_model = _assert_sweeps_match(want, unstack_resident_outputs(got, n_rounds),
                                   LOSS_TOL["branin"])
    assert n_model > 0, "no bracket ran the model path"
    assert_states_match(want_state, got_state, LOSS_TOL["branin"])


def test_resident_conditional_sweep_matches_reference(ref):
    """The conditional space with a forbidden clause, max budget 9, seven
    brackets (two rounds of three and a tail), on the reference's draws."""
    (want, want_state), (got, got_state), seen = run_conditional_pair(
        ref, dynamic=True, n_iterations=7, resident=True)
    n_rounds = resident_rotation(plans_for(7, max_budget=9.0))[1]
    want = ref.sweep.unstack_resident_outputs(want, n_rounds)
    got = unstack_resident_outputs(got, n_rounds)
    assert assert_conditional_sweeps_match(want, got) > 0, "no model-based pick"
    assert sum(seen) > 0, "no forbidden proposal was redrawn"
    assert_states_match(want_state, got_state, COND_LOSS_TOL)


# --------------------------------------------------------------- optimizer
def _make(space="branin", seed=3):
    if space == "branin":
        kw = dict(configspace=branin_space(seed=0), eval_fn=branin)
    else:
        kw = dict(configspace=cond_space(tspace), eval_fn=cond_loss)
    return FusedBOHB(min_budget=1, max_budget=27, eta=3, seed=seed, num_samples=16,
                     device="cpu", **kw)


def _runs(result):
    return sorted((r.config_id, r.budget, r.loss) for r in result.get_all_runs())


@pytest.mark.parametrize("space", ["branin", "conditional"])
def test_run_resident_equals_unrolled_dynamic(space):
    """``run(resident=True)`` replays the same ``Result`` as a same-seed
    ``run(dynamic_counts=True)``: runs, configurations, model flags and the
    observations folded for later runs, exactly; a second ``run()`` call
    continues both alike."""
    a, b = _make(space), _make(space)
    for n in (5, 9):
        res_u = a.run(n_iterations=n, dynamic_counts=True)
        res_r = b.run(n_iterations=n, resident=True)
        assert _runs(res_r) == _runs(res_u)
        assert res_r.get_id2config_mapping() == res_u.get_id2config_mapping()
    for bud in a._warm_v:
        np.testing.assert_array_equal(a._warm_v[bud], b._warm_v[bud])
        np.testing.assert_array_equal(a._warm_l[bud], b._warm_l[bud])
    assert [s["dynamic_counts"] for s in b.run_stats] == [True, True]


def test_run_incumbent_agrees_with_the_resident_result():
    """``run_incumbent`` on a fresh optimizer returns the best final-stage
    row of the same-seed resident run: per-bracket bests, the winner's
    bracket, loss and vector; it does not advance ``iterations``; its
    transfer counts name what moved."""
    opt = _make()
    out = opt.run_incumbent(n_iterations=9)
    assert opt.iterations == []
    ref_opt = _make()
    res = ref_opt.run(n_iterations=9, resident=True)
    finals = {}
    for r in res.get_all_runs():
        if r.budget == 27.0:
            finals.setdefault(r.config_id[0], []).append(r)
    per_bracket = [min(x.loss for x in finals[b]) for b in range(9)]
    inc = out["incumbent"]
    assert inc["per_bracket_loss"] == per_bracket
    assert inc["bracket"] == int(np.argmin(per_bracket))
    assert inc["loss"] == per_bracket[inc["bracket"]]
    best = min(finals[inc["bracket"]], key=lambda x: x.loss)
    vec = ref_opt.configspace.to_vector(res.get_id2config_mapping()[best.config_id]["config"])
    np.testing.assert_allclose(inc["vector"], vec, rtol=0, atol=1e-6)
    assert out["evaluations"] == len(res.get_all_runs())
    t = out["transfers"]
    assert t["transfers_h2d"] == 3 * len(ref_opt._warm_v) and t["transfer_bytes_h2d"] > 0
    assert t["transfers_d2h"] == 4 and t["transfer_bytes_d2h"] == 4 * (2 + 1 + 1 + 9)
    # the unrolled incumbent-only sweep gives the same payload
    assert _make().run_incumbent(n_iterations=9, resident=False)["incumbent"] == inc
