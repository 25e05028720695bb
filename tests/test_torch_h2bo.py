"""``power_law_extrapolate``, the ``rank_fn`` seam of ``fused_sh_bracket``
and the fused optimizer subclasses (``FusedHyperBand``, ``FusedH2BO``,
``FusedRandomSearch``) against the reference.

Tolerances: the extrapolation ``rtol 1e-5, atol 1e-6`` (float32 ``log`` and
``exp`` of torch and XLA may differ in the last bit), NaN where the
reference has NaN; promotions under ``rank_fn`` exact on inputs whose
scores have no near-ties; the optimizers' ``Result`` shapes and runs per
budget exact.
"""

import math
import pickle

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch import (
    FusedBOHB,
    FusedH2BO,
    FusedHyperBand,
    FusedRandomSearch,
)
from hpbandster_tpu_torch import space as tspace
from hpbandster_tpu_torch.ops import cuda_kde, kde
from hpbandster_tpu_torch.ops import sweep as tsweep
from hpbandster_tpu_torch.ops.bracket import hyperband_bracket, power_law_extrapolate
from hpbandster_tpu_torch.ops.fused import fused_sh_bracket
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_conditions import check_conditional_result, cond_loss
from tests.test_torch_harness import cond_space, ref  # noqa: F401


def _curves(s, n=200, seed=0):
    """Noisy decreasing power-law curves at budgets 1, 3, 9, ... and rows
    that take each fallback (all increasing, a positive slope, a linear
    curve, a NaN)."""
    rng = np.random.default_rng(seed + s)
    budgets = 3.0 ** np.arange(s)
    c = rng.uniform(0.0, 1.0, size=(n, 1))
    a = rng.uniform(0.1, 2.0, size=(n, 1))
    alpha = rng.uniform(0.2, 1.5, size=(n, 1))
    losses = c + a * budgets[None, :] ** -alpha + rng.normal(0, 0.02, size=(n, s))
    special = {
        "increasing": np.linspace(1.0, 2.0, s),
        "positive_slope": np.r_[0.45, np.full(s - 2, 0.4), 0.5] if s >= 3 else np.ones(s),
        "linear": np.linspace(3.0, 1.0, s),
        "nan": np.r_[1.0, np.nan, np.full(s - 2, 0.5)] if s >= 2 else np.ones(s),
    }
    losses = np.concatenate([losses, np.stack(list(special.values()))])
    return budgets.astype(np.float32), losses.astype(np.float32)


@pytest.mark.parametrize("s", [1, 2, 3, 4, 5])
def test_power_law_matches_reference(ref, s):
    import jax.numpy as jnp

    budgets, losses = _curves(s)
    target = float(3.0 ** s)
    want = np.asarray(ref.bracket.power_law_extrapolate(
        jnp.asarray(budgets), jnp.asarray(losses), target))
    got = power_law_extrapolate(torch.from_numpy(budgets), torch.from_numpy(losses),
                                target).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    last = losses[:, -1]
    if s < 3:
        np.testing.assert_array_equal(got, last)
    else:
        n = len(losses) - 4
        # the increasing and positive-slope rows fall back, most fits do not
        np.testing.assert_array_equal(got[n:n + 2], last[n:n + 2])
        assert np.isnan(got[-1])
        assert (got[:n] != last[:n]).mean() > 0.9


def test_power_law_non_positive_residual_falls_back(ref):
    """With ``floor=0`` and a minimum of 0 the residual at the minimum is 0:
    the last value stands."""
    import jax.numpy as jnp

    budgets = np.array([1.0, 3.0, 9.0], np.float32)
    losses = np.array([[0.0, 1.0, 0.5], [2.0, 1.0, 0.7]], np.float32)
    want = np.asarray(ref.bracket.power_law_extrapolate(
        jnp.asarray(budgets), jnp.asarray(losses), 27.0, floor=0.0))
    got = power_law_extrapolate(torch.from_numpy(budgets), torch.from_numpy(losses),
                                27.0, floor=0.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[0] == 0.5 and got[1] != 0.7


def _curve_loss(xp, v, budget):
    """A learning curve per configuration that crashes (NaN) at budget 1
    where ``v[3] > 0.5``."""
    val = v[..., 0] + (0.2 + v[..., 1]) * budget ** (-(0.3 + v[..., 2]))
    return xp.where((v[..., 3] > 0.5) & (budget == 1), math.nan, val)


def _curve_vectors(seed):
    """27 configurations, 20 of which crash at budget 1 and then learn
    well, so crashed ones are promoted and carry NaN in their history."""
    vecs = np.random.default_rng(seed).uniform(size=(27, 4)).astype(np.float32)
    vecs[:20, 3] = 0.9
    vecs[:20, 0] *= 0.1
    vecs[20:, 3] = 0.1
    vecs[20:, 0] = 0.3 + 0.7 * vecs[20:, 0]
    return vecs


#: three learning curves that cross after budget 9: the first is best at
#: budget 9, the second's extrapolation to 27 is best
CROSSING = np.array([[0.2, -0.1, 0.0, 0.1], [0.0, 5.8, 0.9, 0.1],
                     [0.6, 0.0, 0.0, 0.1]], np.float32)


@pytest.mark.parametrize("case", ["crashes_0", "crashes_1", "crashes_2", "crossing"])
def test_rank_fn_promotions_match_reference(ref, case):
    """``fused_sh_bracket`` with ``power_law_extrapolate`` as ``rank_fn``
    over four rungs (the extrapolation decides the last promotion): the same
    survivors at every stage, with crashed configurations in the survivors'
    history, and on crossing curves, where the extrapolation promotes
    another configuration than the raw stage loss would."""
    import jax.numpy as jnp

    budgets = (1.0, 3.0, 9.0, 27.0)
    if case == "crossing":
        vecs, num_configs = CROSSING, (3, 3, 3, 1)
    else:
        vecs, num_configs = _curve_vectors(int(case[-1])), (27, 9, 3, 1)
    want = ref.fused.fused_sh_bracket(
        lambda v, b: _curve_loss(jnp, v, b), jnp.asarray(vecs), num_configs,
        budgets, rank_fn=ref.bracket.power_law_extrapolate,
    )
    got = fused_sh_bracket(
        lambda v, b: _curve_loss(torch, v, b), torch.from_numpy(vecs), num_configs,
        budgets, rank_fn=power_law_extrapolate,
    )
    for (wi, wl), (gi, gl) in zip(want, got):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-6, atol=1e-6)
    if case == "crossing":
        plain = fused_sh_bracket(lambda v, b: _curve_loss(torch, v, b),
                                 torch.from_numpy(vecs), num_configs, budgets)
        assert plain[3][0].tolist() == [0] and got[3][0].tolist() == [1]
    else:
        # a stage-2 survivor crashed at stage 0: its score falls back
        assert bool(torch.isnan(got[0][1][got[2][0]]).any())


# -------------------------------------------------------------- optimizers
CLASSES = {"FusedHyperBand": FusedHyperBand, "FusedH2BO": FusedH2BO,
           "FusedRandomSearch": FusedRandomSearch}


def _runs_per_budget(result):
    out = {}
    for r in result.get_all_runs():
        out[r.budget] = out.get(r.budget, 0) + 1
    return out


@pytest.mark.parametrize("name", list(CLASSES))
def test_optimizer_classes_match_reference_shapes(ref, name):
    from hpbandster_tpu.optimizers import fused_bohb as ref_fused

    kw = dict(min_budget=1, max_budget=9, eta=3, num_samples=16, seed=0)
    ref_opt = getattr(ref_fused, name)(
        configspace=ref.toys.branin_space(seed=0), eval_fn=ref.toys.branin_from_vector,
        use_pallas=False, **kw)
    want = ref_opt.run(n_iterations=3)
    opt = CLASSES[name](configspace=branin_space(seed=0), eval_fn=branin,
                        device="cpu", **kw)
    got = opt.run(n_iterations=3)
    assert _runs_per_budget(got) == _runs_per_budget(want)
    assert [(it.num_configs, it.budgets) for it in opt.iterations] == \
        [(it.num_configs, it.budgets) for it in ref_opt.iterations]
    assert opt.config == {k: v for k, v in ref_opt.config.items() if k != "time_ref"} | \
        {"time_ref": opt.config["time_ref"]}
    assert got.num_iterations() == want.num_iterations() == 3
    assert len(got.get_id2config_mapping()) == len(want.get_id2config_mapping())
    model = [d.config_info["model_based_pick"] for d in got.data.values()]
    assert any(model) == (name == "FusedH2BO")
    if name == "FusedRandomSearch":
        assert set(_runs_per_budget(got)) == {9.0}
        assert _runs_per_budget(got)[9.0] == sum(
            hyperband_bracket(i, 1, 9, 3).num_configs[0] for i in range(3))


@pytest.mark.parametrize("name", list(CLASSES))
@pytest.mark.parametrize("chunk", [None, 2])
def test_optimizer_classes_take_conditional_spaces(name, chunk):
    """Every subclass runs the conditional space with its forbidden clause
    on both tiers, with host semantics intact."""
    opt = CLASSES[name](configspace=cond_space(tspace, seed=0), eval_fn=cond_loss,
                        min_budget=1, max_budget=9, eta=3, seed=0, num_samples=16,
                        device="cpu")
    res = opt.run(n_iterations=3, chunk_brackets=chunk)
    n_model = check_conditional_result(opt.configspace, res)
    assert (n_model > 0) == (name == "FusedH2BO")
    want = {}
    for i in range(3):
        p = opt._plan(i)
        for k, b in zip(p.num_configs, p.budgets):
            want[b] = want.get(b, 0) + k
    assert _runs_per_budget(res) == want


@pytest.mark.parametrize("name", ["FusedHyperBand", "FusedRandomSearch"])
def test_model_free_classes_run_no_model_math(monkeypatch, name):
    """HyperBand and random search never fit, score or draw candidates, on
    either tier."""
    def boom(*a, **k):
        raise AssertionError("model math ran")

    for mod, attr in ((cuda_kde, "score_candidates"), (tsweep, "fit_kde_pair_masked"),
                      (tsweep, "_fit_kde_pair_device"), (kde, "generate_candidates")):
        monkeypatch.setattr(mod, attr, boom)
    for chunk in (None, 2):
        opt = CLASSES[name](configspace=branin_space(seed=1), eval_fn=branin,
                            min_budget=1, max_budget=9, eta=3, seed=1, device="cpu")
        res = opt.run(n_iterations=3, chunk_brackets=chunk)
        assert not any(d.config_info["model_based_pick"] for d in res.data.values())


def test_h2bo_resume_and_checkpoint_guard(tmp_path):
    """A chunked H2BO run resumes to the uninterrupted result; its
    checkpoint names the promotion scorer, and another class refuses it."""
    def make(cls=FusedH2BO):
        return cls(configspace=branin_space(seed=2), eval_fn=branin, min_budget=1,
                   max_budget=9, eta=3, seed=2, num_samples=16, device="cpu")

    path = str(tmp_path / "h2bo.pkl")
    want = make().run(n_iterations=4, chunk_brackets=2)
    make().run(n_iterations=2, chunk_brackets=2, checkpoint_path=path)
    with open(path, "rb") as fh:
        state = pickle.load(fh)
    assert state["optimizer_class"] == "FusedH2BO"
    assert state["promotion_rank_fn"] == "power_law_extrapolate"
    resumed = make()
    resumed.load_checkpoint(path)
    got = resumed.run(n_iterations=4, chunk_brackets=2)
    assert sorted((r.config_id, r.budget, r.loss) for r in got.get_all_runs()) == \
        sorted((r.config_id, r.budget, r.loss) for r in want.get_all_runs())
    with pytest.raises(ValueError, match="FusedH2BO"):
        make(FusedBOHB).load_checkpoint(path)


def test_unported_optimizer_modes_raise():
    """On every optimizer class and a conditional space: a mesh is refused
    as an unknown argument, a ``stateful_eval`` beside an ``eval_fn`` is
    refused, the resident tier refuses chunking and the static tier
    (``ValueError``, nothing runs), and ``run(resident=True,
    device_metrics=True)`` runs the plan with its telemetry."""
    for cls in (FusedBOHB, *CLASSES.values()):
        kw = dict(configspace=cond_space(tspace), eval_fn=cond_loss, min_budget=1,
                  max_budget=9, seed=0, device="cpu")
        with pytest.raises(TypeError):
            cls(**kw, mesh=object())
        with pytest.raises(ValueError, match="exclusive"):
            cls(**kw, stateful_eval=object())
        opt = cls(**kw)
        for run_kw in ({"chunk_brackets": 2, "resident": True},
                       {"dynamic_counts": False, "resident": True}):
            with pytest.raises(ValueError, match="resident"):
                opt.run(n_iterations=1, **run_kw)
        assert opt.iterations == []
        res = opt.run(n_iterations=2, resident=True, device_metrics=True)
        assert len(opt.iterations) == 2 and opt.run_stats[-1]["dynamic_counts"]
        assert opt.last_device_telemetry["evaluations"] == len(res.get_all_runs())