"""Conditions and forbidden clauses: the port's decode, activity mask,
forbidden mask, imputation and imputing fits against the reference, and
``FusedBOHB`` on a conditional space with a forbidden clause.

Tolerances: the masks exact, against the reference and against the host's
``from_vector`` / ``is_forbidden``. ``_decode_values`` exact on every dim but
log-scaled floats, which may differ in the last bit: torch's float32 ``exp``
is not XLA's (seen on 226 of 3072 log-dim entries here, never flipping a
mask bit). Imputation exact with the reference's uniforms; the fits'
bandwidths within ``1e-6`` (``tests/test_torch_dynamic.py``).
"""

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch import FusedBOHB
from hpbandster_tpu_torch import space as tspace
from hpbandster_tpu_torch.ops import kde
from hpbandster_tpu_torch.ops import sweep as tsweep
from hpbandster_tpu_torch.ops.sweep import (
    build_space_codec,
    codec_tables,
    compile_active_mask,
    compile_forbidden_mask,
    quantize_unit,
    resample_forbidden,
)
from hpbandster_tpu_torch.workloads.toys import branin
from tests.test_torch_harness import cond_space, ref  # noqa: F401


def full_space(m, seed=0):
    """Every condition form (Equals, NotEquals, In, GreaterThan on an
    ordinal and on an integer, LessThan on a linear and on a log float, And,
    Or, a grandchild, a Constant parent) and every clause form
    (ForbiddenEquals on a quantized linear and a quantized log float,
    ForbiddenIn on an integer, ForbiddenAnd, a clause on a conditional
    child), built with either package's ``space`` module."""
    cs = m.ConfigurationSpace(seed=seed)
    hp = {
        "c_grand": m.UniformFloatHyperparameter("c_grand", 0.0, 1.0),
        "a": m.CategoricalHyperparameter("a", ["x", "y", "z"]),
        "b": m.OrdinalHyperparameter("b", [1, 2, 4, 8]),
        "c": m.UniformFloatHyperparameter("c", 0.0, 10.0),
        "lr": m.UniformFloatHyperparameter("lr", 1e-4, 1e-1, log=True),
        "k": m.UniformIntegerHyperparameter("k", 2, 9),
        "units": m.UniformIntegerHyperparameter("units", 8, 256, log=True),
        "qf": m.UniformFloatHyperparameter("qf", 0.0, 1.0, q=0.25),
        "qlog": m.UniformFloatHyperparameter("qlog", 1.0, 64.0, log=True, q=1.0),
        "const": m.Constant("const", "v"),
        "c_eq": m.UniformFloatHyperparameter("c_eq", 0.0, 1.0),
        "c_ne": m.UniformIntegerHyperparameter("c_ne", 1, 5),
        "c_in": m.CategoricalHyperparameter("c_in", ["m", "n"]),
        "c_gt": m.UniformFloatHyperparameter("c_gt", 0.0, 1.0),
        "c_lt": m.UniformFloatHyperparameter("c_lt", -1.0, 1.0),
        "c_and": m.OrdinalHyperparameter("c_and", [0.1, 0.2, 0.3]),
        "c_or": m.UniformFloatHyperparameter("c_or", 1.0, 100.0, log=True),
        "c_const": m.UniformFloatHyperparameter("c_const", 0.0, 1.0),
    }
    cs.add_hyperparameters(list(hp.values()))
    cs.add_conditions([
        m.EqualsCondition(hp["c_eq"], hp["a"], "x"),
        m.NotEqualsCondition(hp["c_ne"], hp["a"], "y"),
        m.InCondition(hp["c_in"], hp["a"], ["x", "z"]),
        m.GreaterThanCondition(hp["c_gt"], hp["b"], 2),
        m.LessThanCondition(hp["c_lt"], hp["c"], 5.0),
        m.AndConjunction(m.EqualsCondition(hp["c_and"], hp["a"], "x"),
                         m.GreaterThanCondition(hp["c_and"], hp["k"], 4)),
        m.OrConjunction(m.EqualsCondition(hp["c_or"], hp["a"], "y"),
                        m.LessThanCondition(hp["c_or"], hp["lr"], 0.01)),
        m.EqualsCondition(hp["c_grand"], hp["c_in"], "m"),
        m.EqualsCondition(hp["c_const"], hp["const"], "v"),
    ])
    cs.add_forbidden_clauses([
        m.ForbiddenEqualsClause(hp["qf"], 0.5),
        m.ForbiddenEqualsClause(hp["qlog"], 8.0),
        m.ForbiddenInClause(hp["k"], [3, 7]),
        m.ForbiddenAndConjunction(m.ForbiddenEqualsClause(hp["a"], "x"),
                                  m.ForbiddenInClause(hp["b"], [4, 8])),
        m.ForbiddenEqualsClause(hp["c_in"], "n"),
        m.ForbiddenAndConjunction(m.ForbiddenEqualsClause(hp["c_and"], 0.2),
                                  m.ForbiddenEqualsClause(hp["c_ne"], 3)),
    ])
    return cs


N_VECTORS = 1024


@pytest.fixture(scope="module")
def full(ref):
    """Both packages' full spaces, their codecs and 1024 quantized vectors
    from a numpy seed (the port's quantization, checked against the
    reference's to a float32 ulp)."""
    import jax
    import jax.numpy as jnp

    rcs, tcs = full_space(ref.space), full_space(tspace)
    rc, tc = ref.sweep.build_space_codec(rcs), build_space_codec(tcs)
    for a, b in zip(rc, tc):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    rng = np.random.default_rng(0)
    u = rng.uniform(size=(N_VECTORS, len(tc.kind))).astype(np.float32)
    for j, k in enumerate(tc.cards):
        if tc.kind[j] == 2:
            u[:, j] = rng.integers(k, size=N_VECTORS)
    q = quantize_unit(codec_tables(tc, "cpu"), torch.from_numpy(u)).numpy()
    want_q = np.asarray(jax.vmap(lambda v: ref.sweep.quantize_unit(rc, v))(jnp.asarray(u)))
    np.testing.assert_allclose(q, want_q, rtol=0, atol=1.2e-7)
    return rcs, tcs, rc, tc, q


def _host_patterns(cs, q):
    """The host's activity pattern and forbidden flag of each vector."""
    cfgs = [cs.from_vector(v) for v in q.astype(np.float64)]
    act = np.array([~np.isnan(cs.to_vector(c)) for c in cfgs])
    return act, np.array([cs.is_forbidden(c) for c in cfgs])


def test_decode_values_match_reference(ref, full):
    import jax
    import jax.numpy as jnp

    rcs, tcs, rc, tc, q = full
    want = np.asarray(jax.vmap(lambda v: ref.sweep._decode_values(rc, v))(jnp.asarray(q)))
    got = tsweep._decode_values(codec_tables(tc, "cpu"), torch.from_numpy(q)).numpy()
    log_float = (tc.kind == 0) & tc.log
    np.testing.assert_array_equal(got[:, ~log_float], want[:, ~log_float])
    np.testing.assert_array_max_ulp(got[:, log_float], want[:, log_float], maxulp=1)


def test_active_mask_matches_reference_and_host(ref, full):
    import jax
    import jax.numpy as jnp

    rcs, tcs, rc, tc, q = full
    want = np.asarray(jax.vmap(ref.sweep.compile_active_mask(rcs, rc))(jnp.asarray(q)))
    got = compile_active_mask(tcs, codec_tables(tc, "cpu"))(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _host_patterns(tcs, q)[0])
    # every conditional dim is both active and inactive somewhere
    cond = [tcs.get_hyperparameter_names().index(c.child_name)
            for c in tcs.get_conditions() if c.child_name != "c_const"]
    assert got[:, cond].any(0).all() and (~got[:, cond]).any(0).all()


def test_forbidden_mask_matches_reference_and_host(ref, full):
    import jax
    import jax.numpy as jnp

    rcs, tcs, rc, tc, q = full
    act = np.array(jax.vmap(ref.sweep.compile_active_mask(rcs, rc))(jnp.asarray(q)))
    want = np.asarray(jax.vmap(ref.sweep.compile_forbidden_mask(rcs, rc))(
        jnp.asarray(q), jnp.asarray(act)))
    tables = codec_tables(tc, "cpu")
    got = compile_forbidden_mask(tcs, tables)(torch.from_numpy(q), torch.from_numpy(act)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _host_patterns(tcs, q)[1])
    assert 0 < got.mean() < 1
    # each clause on its own fires somewhere and misses somewhere
    for clause in tcs.get_forbiddens():
        one = tspace.ConfigurationSpace()
        one.add_hyperparameters(tcs.get_hyperparameters())
        one.add_conditions(tcs.get_conditions())
        one.add_forbidden_clause(clause)
        hits = compile_forbidden_mask(one, tables)(torch.from_numpy(q), torch.from_numpy(act))
        assert 0 < int(hits.sum()) < N_VECTORS, clause


def _order_on_categorical(m):
    cs = m.ConfigurationSpace()
    a = m.CategoricalHyperparameter("a", [4, 2, 8])
    b = m.UniformFloatHyperparameter("b", 0.0, 1.0)
    cs.add_hyperparameters([a, b])
    cs.add_condition(m.GreaterThanCondition(b, a, 4))
    return cs, "categorical"


def _order_on_ordinal(seq, msg):
    def build(m):
        cs = m.ConfigurationSpace()
        a = m.OrdinalHyperparameter("a", seq)
        b = m.UniformFloatHyperparameter("b", 0.0, 1.0)
        cs.add_hyperparameters([a, b])
        cs.add_condition(m.LessThanCondition(b, a, seq[1]))
        return cs, msg
    return build


def _unknown_condition(m):
    class Odd(m.conditions._BinaryCondition):
        def _test(self, parent_value):
            return int(parent_value) % 2 == 1

    cs = m.ConfigurationSpace()
    a = m.UniformIntegerHyperparameter("a", 1, 9)
    b = m.UniformFloatHyperparameter("b", 0.0, 1.0)
    cs.add_hyperparameters([a, b])
    cs.add_condition(Odd(b, a, None))
    return cs, "no device compilation"


def _unknown_clause(m):
    cs = m.ConfigurationSpace()
    cs.add_hyperparameter(m.UniformFloatHyperparameter("b", 0.0, 1.0))
    cs.add_forbidden_clause(m.ForbiddenClause())
    return cs, "no device compilation"


def _clause_on_unknown_parameter(m):
    cs = m.ConfigurationSpace()
    cs.add_hyperparameter(m.UniformFloatHyperparameter("b", 0.0, 1.0))
    cs.add_forbidden_clause(m.ForbiddenEqualsClause("nope", 0.5))
    return cs, "unknown parameter"


@pytest.mark.parametrize("build", [
    _order_on_categorical,
    _order_on_ordinal(["lo", "mid", "hi"], "numeric ordinal"),
    _order_on_ordinal([4, 1, 2], "not numerically sorted"),
    _unknown_condition,
    _unknown_clause,
    _clause_on_unknown_parameter,
], ids=["order_on_categorical", "order_on_non_numeric_ordinal",
        "order_on_unsorted_ordinal", "unknown_condition", "unknown_clause",
        "clause_on_unknown_parameter"])
def test_reference_value_errors_raise(ref, build):
    """The forms the reference cannot compile raise ``ValueError`` in both."""
    for m, compile_mask, compile_forb, codec_of in (
        (ref.space, ref.sweep.compile_active_mask, ref.sweep.compile_forbidden_mask,
         ref.sweep.build_space_codec),
        (tspace, compile_active_mask, compile_forbidden_mask,
         lambda cs: codec_tables(build_space_codec(cs), "cpu")),
    ):
        cs, msg = build(m)
        compile_fn = compile_forb if cs.get_forbiddens() else compile_mask
        with pytest.raises(ValueError, match=msg):
            compile_fn(cs, codec_of(cs))


# ---------------------------------------------------------------- imputation
def _conditional_data(rng, n, cards):
    """``f32[n, d]`` with NaN holes, a column with no active row and discrete
    columns holding choice indices."""
    d = len(cards)
    x = rng.uniform(size=(n, d)).astype(np.float32)
    for j, k in enumerate(cards):
        if k:
            x[:, j] = rng.integers(k, size=n)
    x[rng.uniform(size=(n, d)) < 0.4] = np.nan
    x[:, 1] = np.nan
    return x


def test_impute_matches_reference(ref):
    import jax
    import jax.numpy as jnp

    cards = np.array([0, 0, 3, 0, 4, 2], np.int32)
    data = _conditional_data(np.random.default_rng(1), 64, cards)
    key = jax.random.key(7)
    want = np.asarray(ref.kde.impute_conditional_masked(key, jnp.asarray(data), jnp.asarray(cards)))
    k_pick, k_fb = jax.random.split(key)
    u, u_fb = (torch.from_numpy(np.array(jax.random.uniform(k, data.shape)))
               for k in (k_pick, k_fb))
    got = kde.impute_conditional_masked(
        torch.from_numpy(data), torch.from_numpy(cards).float(), u, u_fb).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.isnan(got).any()
    # donors come from the column's own active rows
    for j in (0, 2, 3):
        assert set(got[:, j]) <= set(data[~np.isnan(data[:, j]), j])


def _impute_uniforms(jax, key, n, d):
    kg, kb = jax.random.split(key)
    out = []
    for k in (kg, kb):
        k_pick, k_fb = jax.random.split(k)
        out.append(tuple(torch.from_numpy(np.array(jax.random.uniform(kk, (n, d))))
                         for kk in (k_pick, k_fb)))
    return tuple(out)


@pytest.mark.parametrize("flag", [None, "1"])
def test_masked_fit_with_imputation_matches_reference(ref, monkeypatch, flag):
    """The dynamic tier's fit on a conditional buffer (NaN holes, crashes,
    +inf pads): the imputed data and masks exact, bandwidths within 1e-6,
    with the two-pass bandwidths and with the masked-moment pass."""
    import jax
    import jax.numpy as jnp

    if flag is None:
        monkeypatch.delenv("HPB_PALLAS_KDE_FIT", raising=False)
    else:
        monkeypatch.setenv("HPB_PALLAS_KDE_FIT", flag)
    cards = np.array([0, 0, 2, 0, 4, 0], np.int32)
    cap, count = 256, 70
    rng = np.random.default_rng(5)
    vecs = _conditional_data(rng, cap, cards)
    vecs[count:] = 0.0
    losses = np.full(cap, np.inf, np.float32)
    losses[:count] = np.round(rng.normal(size=count), 1)
    losses[[3, 17]] = np.inf
    n_good, n_bad = 10, 59
    args = (np.int32(count), np.int32(n_good), np.int32(n_bad))
    key = jax.random.key(11)
    want = ref.kde.fit_kde_pair_masked(
        jnp.asarray(vecs), jnp.asarray(losses), *map(jnp.asarray, args),
        jnp.asarray(cards), 1e-3, impute_key=key,
    )
    got = kde.fit_kde_pair_masked(
        torch.from_numpy(vecs), torch.from_numpy(losses),
        *(torch.tensor(int(a), dtype=torch.int32) for a in args),
        torch.from_numpy(cards).float(), 1e-3,
        impute_draws=_impute_uniforms(jax, key, cap, len(cards)),
    )
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
        np.testing.assert_allclose(g.bw.numpy(), np.asarray(w.bw), rtol=0, atol=1e-6)
        assert np.isfinite(g.data.numpy()).all() and np.isfinite(g.bw.numpy()).all()


def test_static_fit_with_imputation_matches_reference(ref):
    import jax
    import jax.numpy as jnp

    cards = np.array([0, 0, 2, 0, 4, 0], np.int32)
    rng = np.random.default_rng(6)
    vecs = _conditional_data(rng, 40, cards)
    losses = rng.normal(size=40).astype(np.float32)
    n_good, n_bad = 7, 34
    key = jax.random.key(3)
    want = ref.sweep._fit_kde_pair_device(
        jnp.asarray(vecs), jnp.asarray(losses), n_good, n_bad,
        jnp.asarray(cards), 1e-3, impute_key=key,
    )
    kg, kb = jax.random.split(key)
    draws = []
    for k, n in ((kg, n_good), (kb, n_bad)):
        k_pick, k_fb = jax.random.split(k)
        draws.append(tuple(torch.from_numpy(np.array(jax.random.uniform(kk, (n, 6))))
                           for kk in (k_pick, k_fb)))
    got = tsweep._fit_kde_pair_device(
        torch.from_numpy(vecs), torch.from_numpy(losses), n_good, n_bad,
        torch.from_numpy(cards).float(), 1e-3, impute_draws=tuple(draws),
    )
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        np.testing.assert_allclose(g.bw.numpy(), np.asarray(w.bw), rtol=0, atol=1e-6)


# ----------------------------------------------------- rejection resampling
def _resample_in_passes(vectors, forbidden_fn, mask_fn, redraws, fallback):
    """The reference's loop, pass by pass (``ops/sweep.py`` run_bracket)."""
    resampled = torch.zeros(vectors.shape[0], dtype=torch.bool)
    for fresh in redraws:
        rows = forbidden_fn(vectors, mask_fn(vectors))
        resampled = resampled | rows
        vectors = torch.where(rows[:, None], fresh, vectors)
    rows = forbidden_fn(vectors, mask_fn(vectors))
    return torch.where(rows[:, None], fallback[None, :], vectors), resampled


def test_resample_forbidden_equals_the_pass_loop():
    """The closed form gives the pass-by-pass loop's rows and marks, on
    random proposals and redraws of the conditional space (a quarter of
    them forbidden, some rows forbidden in every pass)."""
    cs = cond_space(tspace)
    tables = codec_tables(build_space_codec(cs), "cpu")
    forb, mask = compile_forbidden_mask(cs, tables), compile_active_mask(cs, tables)
    gen = torch.Generator().manual_seed(0)

    def draw(n, forbidden_share):
        v = quantize_unit(tables, tsweep.random_unit(tables, gen, n))
        hit = torch.rand(n, generator=gen) < forbidden_share
        v[hit, 2], v[hit, 4] = 1.0, 3.0  # adam, depth 8
        return v

    vecs = draw(200, 0.5)
    redraws = torch.stack([draw(200, 0.6) for _ in range(8)])
    fallback = torch.tensor([0.2, 0.8, 0.0, 0.5, 0.0, 0.0])
    got, got_marks = resample_forbidden(vecs, forb, mask, redraws, fallback)
    want, want_marks = _resample_in_passes(vecs, forb, mask, redraws, fallback)
    assert torch.equal(got, want) and torch.equal(got_marks, want_marks)
    assert 0 < int(got_marks.sum()) < 200
    assert bool((got == fallback).all(1).any()), "no row fell back"
    assert not forb(got, mask(got)).any()


def test_forbidden_fn_needs_a_fallback():
    cs = cond_space(tspace)
    codec = build_space_codec(cs)
    with pytest.raises(ValueError, match="fallback_vector"):
        tsweep.make_fused_sweep_fn(
            branin, [], codec, device="cpu",
            forbidden_fn=compile_forbidden_mask(cs, codec_tables(codec, "cpu")),
        )


# ------------------------------------------------------------- the optimizer
def cond_loss(v, budget):
    return branin(v[:, :2], budget) + 0.1 * v[:, 3] + 0.05 * v[:, 5]


def make_cond(seed=0, **kw):
    return FusedBOHB(configspace=cond_space(tspace, seed=seed), eval_fn=cond_loss,
                     min_budget=1, max_budget=9, eta=3, seed=seed, num_samples=16,
                     device="cpu", **kw)


def check_conditional_result(cs, res):
    """Every config round-trips through the host codec, respects the
    activity pattern and is allowed; returns the model-based picks."""
    n_model = 0
    for entry in res.get_id2config_mapping().values():
        cfg = entry["config"]
        assert dict(cs.from_vector(cs.to_vector(cfg))) == cfg, cfg
        assert ("momentum" in cfg) == (cfg["opt"] == "sgd"), cfg
        assert ("extra" in cfg) == (cfg["depth"] > 2), cfg
        assert not cs.is_forbidden(cfg), cfg
        n_model += bool(entry["config_info"]["model_based_pick"])
    assert all(np.isfinite(r.loss) for r in res.get_all_runs())
    return n_model


@pytest.mark.parametrize("chunk", [None, 2])
def test_fused_bohb_runs_conditional_space(chunk):
    """Both tiers accept the conditional space: host semantics hold for
    every config, the model engages, and the observations carry NaN exactly
    in the inactive dims."""
    opt = make_cond()
    res = opt.run(n_iterations=3, chunk_brackets=chunk)
    assert len(res.get_all_runs()) == 13 + 6 + 3
    assert check_conditional_result(opt.configspace, res) > 0
    names = opt.configspace.get_hyperparameter_names()
    for v in opt._warm_v.values():
        opt_is_sgd = v[:, names.index("opt")] == 0
        deep = v[:, names.index("depth")] >= 2
        np.testing.assert_array_equal(np.isnan(v[:, names.index("momentum")]), ~opt_is_sgd)
        np.testing.assert_array_equal(np.isnan(v[:, names.index("extra")]), ~deep)


def test_fallback_vector_matches_reference(ref):
    """The clamp fallback is the reference's: the same seeded host draw."""
    from hpbandster_tpu.optimizers.fused_bohb import FusedBOHB as RefFusedBOHB

    for seed in (None, 0, 5):
        want = RefFusedBOHB(
            configspace=cond_space(ref.space), eval_fn=lambda v, b: v[0],
            min_budget=1, max_budget=9, seed=seed, use_pallas=False,
        )._fallback_vector
        got = FusedBOHB(
            configspace=cond_space(tspace), eval_fn=cond_loss, min_budget=1,
            max_budget=9, seed=seed, device="cpu",
        )._fallback_vector.numpy()
        np.testing.assert_array_equal(got, want)


def test_conditional_resume_equals_uninterrupted(tmp_path):
    path = str(tmp_path / "cond.pkl")
    want = make_cond(seed=4).run(n_iterations=4, chunk_brackets=2)
    make_cond(seed=4).run(n_iterations=2, chunk_brackets=2, checkpoint_path=path)
    resumed = make_cond(seed=4)
    resumed.load_checkpoint(path)
    got = resumed.run(n_iterations=4, chunk_brackets=2)

    def runs(r):
        return sorted((x.config_id, x.budget, x.loss) for x in r.get_all_runs())

    assert runs(got) == runs(want)
    assert got.get_id2config_mapping() == want.get_id2config_mapping()
    assert got.get_incumbent_id() == want.get_incumbent_id()


def test_warm_start_from_conditional_result_keeps_nan():
    """Warm vectors from a conditional ``previous_result`` keep NaN in the
    inactive dims (the fit imputes them), and the warm run's first bracket
    already makes model-based picks."""
    prev = make_cond(seed=1).run(n_iterations=3)
    warm = make_cond(seed=2, previous_result=prev)
    cs = warm.configspace
    n_nan = sum(int(np.isnan(v).sum()) for v in warm._warm_v.values())
    want_nan = sum(int(np.isnan(cs.to_vector(prev.get_id2config_mapping()[r.config_id]["config"])).sum())
                   for r in prev.get_all_runs(only_largest_budget=False))
    assert n_nan == want_nan > 0
    res = warm.run(n_iterations=1, chunk_brackets=1)
    live = {cid: e for cid, e in res.get_id2config_mapping().items() if cid[0] >= 0}
    assert any(e["config_info"]["model_based_pick"] for e in live.values())
    check_conditional_result(cs, res)


def test_record_facts_reads_a_launch():
    """``chip_smoke.record_facts`` tells finite from non-finite inputs, the
    scorer's mixed-vartype launches and discrete cards of the launches
    ``cuda_kde.RECORD`` kept."""
    from chip_smoke import record_facts

    side = kde.KDE(torch.rand(8, 3), torch.ones(8), torch.full((3,), 0.1))
    cont, mixed = torch.zeros(3), torch.tensor([0.0, 1.0, 2.0])
    cards = torch.tensor([0.0, 3.0, 4.0])
    assert record_facts("kde_score", (torch.rand(4, 3), side, side, cont, torch.zeros(3))) == \
        dict(finite=True, mixed_vartypes=False, discrete_cards=False)
    assert record_facts("kde_score", (torch.rand(4, 3), side, side, mixed, cards)) == \
        dict(finite=True, mixed_vartypes=True, discrete_cards=True)
    bad = kde.KDE(side.data.clone(), side.mask, side.bw)
    bad.data[2, 1] = float("nan")
    assert not record_facts("kde_score", (torch.rand(4, 3), side, bad, mixed, cards))["finite"]
    masks = torch.ones(1, 8)
    assert record_facts("kde_moments", (torch.rand(8, 3), masks, cards, 1e-3)) == \
        dict(finite=True, mixed_vartypes=False, discrete_cards=True)
    assert record_facts("kde_moments", (torch.rand(8, 3), masks, None, 1e-3))["discrete_cards"] is False
    assert not record_facts("kde_moments", (bad.data, masks, None, 1e-3))["finite"]


def test_random_search_baseline_draws_through_the_space():
    """``chip_smoke.py``'s random-search baseline draws through the space:
    on the all-float smoke spaces it is the plain unit-cube draw of the
    same seed, bit for bit; on the conditional space no baseline
    configuration is forbidden or carries a value in an inactive dim."""
    import chip_smoke
    from hpbandster_tpu_torch.workloads.toys import branin_space, hartmann6, hartmann6_space

    for space, fn in ((hartmann6_space, hartmann6), (branin_space, branin)):
        opt = FusedBOHB(configspace=space(seed=0), eval_fn=fn, min_budget=1,
                        max_budget=9, device="cpu")
        gen = torch.Generator().manual_seed(0)
        d = len(opt.codec.kind)
        v = torch.rand((chip_smoke.RANDOM_SEARCH_REPLICATES * 20, d), generator=gen)
        plain = float(fn(v, 9.0).reshape(chip_smoke.RANDOM_SEARCH_REPLICATES, 20)
                      .min(dim=1).values.median())
        assert chip_smoke.random_search_median_best(torch, torch.device("cpu"), fn,
                                                    opt, 20, 9.0) == plain
    seen = []

    def recording(v, budget):
        seen.append(v.clone())
        return cond_loss(v, budget)

    opt = make_cond()
    chip_smoke.random_search_median_best(torch, torch.device("cpu"), recording, opt, 20, 9.0)
    (v,) = seen
    active = opt.active_mask_fn(v)
    assert not opt.forbidden_fn(v, active).any()
    assert bool((v[~active] == 0).all()) and bool((~active).any())
