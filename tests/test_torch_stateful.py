"""The ``StatefulEval`` seam against the reference: a per-lane toy
trainer written in both frameworks from the same seeded numpy weights
(linear regression lanes whose learning rate and start come from the
configuration, a diverging corner reporting NaN), through
``fused_sh_bracket(stateful=...)``, through a whole dynamic sweep, on the
resident tier and through ``FusedBOHB(stateful_eval=...)``.

Tolerances: stage indices exact; losses and the final lanes' state within
``1e-5`` (float32 matrix products and their sums in another order), NaN
where the reference has NaN. The port's resident sweep equals its
unrolled one bit for bit.
"""

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch import FusedBOHB
from hpbandster_tpu_torch.ops.bracket import BracketPlan
from hpbandster_tpu_torch.ops.fused import StatefulEval, fused_sh_bracket, tree_map
from hpbandster_tpu_torch.ops.sweep import (
    build_space_codec,
    make_fused_sweep_fn,
    plan_additions,
    pow2_capacities,
    resident_rotation,
    unstack_resident_outputs,
)
from hpbandster_tpu_torch.workloads.toys import branin_space
from tests.test_torch_harness import ReferenceDraws, codecs, plans_for, ref  # noqa: F401
from tests.test_torch_resident import _assert_bitwise
from tests.test_torch_sweep import NUM_SAMPLES, _assert_sweeps_match

TOL = 1e-5
_RNG = np.random.default_rng(42)
#: the toy's data and the map from a configuration to its lane's start
X = _RNG.normal(size=(16, 3)).astype(np.float32)
Y = (X @ np.array([1.0, -2.0, 0.5], np.float32) + 0.1 * _RNG.normal(size=16)).astype(np.float32)
W0 = _RNG.normal(size=(2, 3)).astype(np.float32)


def toy(xp, where):
    """The toy trainer over ``xp`` (numpy-like: ``torch`` or ``jax.numpy``):
    state ``{"w": f32[n, 3], "trained": (f32[n],)}``; each step is one
    gradient step per budget unit with learning rate ``0.02 + 0.05 v0``;
    a lane with ``v1 > 0.9`` diverges (NaN)."""
    x, y, w0 = (xp.asarray(a) for a in (X, Y, W0))

    def init_fn(v):
        return {"w": v @ w0, "trained": (v[:, 0] * 0.0,)}

    def step_fn(state, v, budget, prev_budget):
        w = state["w"]
        lr = (0.02 + 0.05 * v[:, 0])[:, None]
        for _ in range(int(round(budget - prev_budget))):
            resid = w @ x.T - y[None, :]
            w = w - lr * (2.0 / x.shape[0]) * (resid @ x)
        loss = ((w @ x.T - y[None, :]) ** 2).mean(axis=1)
        loss = where(v[:, 1] > 0.9, float("nan"), loss)
        return {"w": w, "trained": (state["trained"][0] + (budget - prev_budget),)}, loss

    return StatefulEval(init_fn, step_fn)


def port_toy():
    return toy(torch, lambda c, a, b: torch.where(c, torch.full_like(b, a), b))


def ref_toy(ref):
    import jax.numpy as jnp

    return ref.fused.StatefulEval(*toy(jnp, jnp.where))


def test_tree_map_keeps_structure():
    t = torch.arange(6.0)
    tree = {"a": t, "b": (t, [t, {"c": t}]), "d": BracketPlan(t, t)}
    out = tree_map(lambda x: x[[0, 2]], tree)
    assert out["b"][1][1]["c"].tolist() == [0.0, 2.0]
    assert isinstance(out["d"], BracketPlan) and isinstance(out["b"][1], list)


@pytest.mark.parametrize("num_configs,budgets,pad", [
    ((27, 9, 3, 1), (1.0, 3.0, 9.0, 27.0), 0),
    ((9, 3, 1), (3.0, 9.0, 27.0), 3),
    ((5,), (27.0,), 0),
])
def test_stateful_bracket_matches_reference(ref, num_configs, budgets, pad):
    """Stage indices exact, losses and the surviving lanes' final state
    within ``1e-5``; padding rows train but are never promoted."""
    import jax.numpy as jnp

    rng = np.random.default_rng(len(num_configs) + pad)
    v = rng.uniform(size=(num_configs[0] + pad, 2)).astype(np.float32)
    v[::4, 1] = 0.95  # some diverging lanes
    want, want_state = ref.fused.fused_sh_bracket(
        None, jnp.asarray(v), num_configs, budgets, stateful=ref_toy(ref),
        return_final_state=True)
    got, state = fused_sh_bracket(None, torch.from_numpy(v), num_configs, budgets,
                                  stateful=port_toy(), return_final_state=True)
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(state["w"].numpy(), np.asarray(want_state["w"]), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(state["trained"][0].numpy(),
                                  np.asarray(want_state["trained"][0]))
    assert state["trained"][0].shape == (num_configs[-1],)


def test_stateful_seam_guards():
    v = torch.rand(3, 2)
    for kw in (dict(eval_fn=None), dict(eval_fn=lambda x, b: x[:, 0], stateful=port_toy())):
        with pytest.raises(ValueError, match="exactly one"):
            fused_sh_bracket(vectors=v, num_configs=(3,), budgets=(1.0,), **kw)
    with pytest.raises(ValueError, match="requires stateful"):
        fused_sh_bracket(lambda x, b: x[:, 0], v, (3,), (1.0,), return_final_state=True)


def test_stateful_sweep_matches_reference(ref, monkeypatch):
    """A whole dynamic-tier sweep (Branin's space, the toy trainer as the
    evaluation, max budget 9) on the reference's draws, bracket by
    bracket; the port's resident tier then equals its unrolled tier bit
    for bit."""
    monkeypatch.delenv("HPB_PALLAS_KDE_FIT", raising=False)
    rc, codec = codecs(ref, "branin")
    plans = plans_for(7, max_budget=9.0)
    kw = dict(num_samples=NUM_SAMPLES, dynamic_counts=True,
              capacities=pow2_capacities(plan_additions(plans)))
    want = ref.sweep.make_fused_sweep_fn(
        None, plans, rc, use_pallas=True, pallas_interpret=True,
        stateful_eval=ref_toy(ref), **kw)(np.uint32(9))
    got = make_fused_sweep_fn(None, plans, codec, device="cpu", stateful_eval=port_toy(),
                              **kw)(9, draws=ReferenceDraws(ref, rc, 9))
    assert _assert_sweeps_match(want, got, TOL) > 0, "no bracket ran the model path"
    resident = make_fused_sweep_fn(None, plans, codec, device="cpu", stateful_eval=port_toy(),
                                   resident=True, **kw)(9)
    unrolled = make_fused_sweep_fn(None, plans, codec, device="cpu",
                                   stateful_eval=port_toy(), **kw)(9)
    _assert_bitwise(unstack_resident_outputs(resident, resident_rotation(plans)[1]), unrolled)


def test_fused_bohb_takes_a_stateful_eval():
    """``FusedBOHB(stateful_eval=...)`` runs the plan on every tier, with
    the crashed lanes as crashed runs; its constructor probes the seam
    and refuses a broken one, or one beside an ``eval_fn``."""
    def make(**kw):
        return FusedBOHB(configspace=branin_space(seed=0), min_budget=1, max_budget=9,
                         eta=3, seed=4, num_samples=8, device="cpu", **kw)

    for run_kw in ({}, {"chunk_brackets": 2}, {"resident": True}):
        opt = make(stateful_eval=port_toy())
        res = opt.run(n_iterations=4, **run_kw)
        runs = res.get_all_runs()
        assert len(runs) == sum(sum(p.num_configs) for p in (opt._plan(i) for i in range(4)))
        assert any(r.loss is None for r in runs) and any(r.loss is not None for r in runs)
    good = port_toy()
    with pytest.raises(ValueError, match="exclusive"):
        make(eval_fn=lambda v, b: v[:, 0], stateful_eval=good)
    with pytest.raises(ValueError, match="needs"):
        make()
    with pytest.raises(ValueError, match="per-lane losses"):
        make(stateful_eval=StatefulEval(good.init_fn, lambda s, v, b, p: (s, v)))
    with pytest.raises(ValueError, match="stateful_eval failed"):
        make(stateful_eval=StatefulEval(lambda v: 1 / 0, good.step_fn))
