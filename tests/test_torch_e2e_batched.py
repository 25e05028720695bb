"""End to end: the port's Master-driven optimizers on the batched executor,
on the CPU (``device="cpu"``).

The classes of the reference's ``tests/test_e2e_batched.py`` (HyperBand,
BOHB, pipelined brackets, fused failure containment, random search, result
logging, warm start) and its ``tests/test_fused.py`` executor checks, run on
the port; then the port against the reference: a whole ``BOHB`` run with the
reference's candidates fed through the draw seam, and ``H2BO``'s
promotions. Losses agree within ``atol 1e-4, rtol 1e-4``: XLA contracts
Branin's cancelling polynomial differently from eager PyTorch (ROADMAP
C.15).
"""

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch.core.result import json_result_logger, logged_results_to_HBS_result
from hpbandster_tpu_torch.core.successive_halving import (
    JaxSuccessiveHalving,
    SuccessiveResampling,
)
from hpbandster_tpu_torch.models.learning_curves import LastValueModel, PowerLawModel
from hpbandster_tpu_torch.ops.fused import make_fused_bracket_fn
from hpbandster_tpu_torch.optimizers import BOHB, H2BO, HyperBand, RandomSearch
from hpbandster_tpu_torch.parallel import BatchedExecutor, VmapBackend
from hpbandster_tpu_torch.workloads.toys import BRANIN_OPT, branin, branin_space
from tests.test_torch_harness import ReferenceKDEDraws, ref, ref_opt  # noqa: F401

LOSS_ATOL = LOSS_RTOL = 1e-4


def make_optimizer(cls, seed=0, executor_kw=None, **kwargs):
    cs = branin_space(seed=seed)
    executor = BatchedExecutor(VmapBackend(branin, device="cpu"), cs, **(executor_kw or {}))
    if cls in (BOHB, H2BO):
        kwargs["device"] = "cpu"
    opt = cls(configspace=cs, run_id=f"test-{cls.__name__}", executor=executor,
              min_budget=1, max_budget=9, eta=3, seed=seed, **kwargs)
    return opt, executor


def runs_by_budget(res):
    out = {}
    for r in res.get_all_runs():
        out[r.budget] = out.get(r.budget, 0) + 1
    return out


class TestHyperBandBatched:
    def test_run_counts_match_sh_arithmetic(self):
        opt, executor = make_optimizer(HyperBand)
        res = opt.run(n_iterations=3)
        opt.shutdown()
        # brackets (9,3,1)@(1,3,9), (5,1)@(3,9), (3)@(9): 22 evaluations
        assert len(res.get_all_runs()) == 22
        assert executor.total_evaluated == 22
        assert runs_by_budget(res) == {1.0: 9, 3.0: 3 + 5, 9.0: 1 + 1 + 3}

    def test_incumbent_and_trajectory(self):
        opt, _ = make_optimizer(HyperBand, seed=1)
        res = opt.run(n_iterations=6)
        opt.shutdown()
        assert res.get_incumbent_id() is not None
        traj = res.get_incumbent_trajectory()
        assert len(traj["losses"]) >= 1
        assert traj["losses"][-1] <= traj["losses"][0] + 1e-9
        assert traj["losses"][-1] < 30.0

    def test_id2config_complete(self):
        opt, _ = make_optimizer(HyperBand, seed=2)
        res = opt.run(n_iterations=2)
        opt.shutdown()
        id2c = res.get_id2config_mapping()
        for r in res.get_all_runs():
            assert r.config_id in id2c
            assert "x" in id2c[r.config_id]["config"]


class TestBOHBBatched:
    def test_full_run_and_model_usage(self):
        opt, _ = make_optimizer(BOHB, seed=3, min_points_in_model=4)
        res = opt.run(n_iterations=8)
        opt.shutdown()
        picks = [v["config_info"].get("model_based_pick")
                 for v in res.get_id2config_mapping().values()]
        assert any(picks), "no model-based picks in a full BOHB run"
        assert res.get_incumbent_id() is not None

    def test_bohb_converges_toward_optimum(self):
        opt, _ = make_optimizer(BOHB, seed=4, min_points_in_model=4)
        res = opt.run(n_iterations=10)
        opt.shutdown()
        assert res.data[res.get_incumbent_id()].results[9.0] < 5.0 + BRANIN_OPT

    def test_device_ranked_iterations(self):
        """``JaxSuccessiveHalving`` ranks on the optimizer's device and
        promotes what the host rule promotes: the same run."""
        results = []
        for cls in (JaxSuccessiveHalving, None):
            kw = {} if cls is None else {"iteration_class": cls}
            opt, _ = make_optimizer(BOHB, seed=5, min_points_in_model=4, **kw)
            results.append({(r.config_id, r.budget): r.loss
                            for r in opt.run(n_iterations=4).get_all_runs()})
            if cls is not None:
                assert all(it.device.type == "cpu" for it in opt.iterations)
        assert results[0] == results[1]


class TestPipelinedBrackets:
    def test_parallel_brackets_two_pipelines_and_matches_counts(self):
        opt, executor = make_optimizer(HyperBand, seed=2,
                                       executor_kw={"parallel_brackets": 2})
        res = opt.run(n_iterations=4)
        opt.shutdown()
        assert executor.total_evaluated == 13 + 6 + 3 + 13
        assert len(res.get_all_runs()) == 35
        # every multi-stage bracket fused despite concurrent buffering
        assert executor.fused_brackets_run == 3
        assert res.get_incumbent_id() is not None


class TestFusedFailureContainment:
    def test_fused_dispatch_failure_crashes_only_its_wave(self):
        """A bracket whose fused dispatch raises crashes only that wave's
        jobs; the run continues on the stage-batched path."""

        def spiteful(vectors, budget):
            # the fused stage-0 batch of bracket 0 is 9 rows; the stage
            # batches pad to a power of two, so they never see 9 rows
            if vectors.shape[0] == 9 and budget == 1.0:
                raise ValueError("refusing the fused bracket")
            return branin(vectors, budget)

        cs = branin_space(seed=3)
        executor = BatchedExecutor(VmapBackend(spiteful, device="cpu"), cs)
        opt = HyperBand(configspace=cs, run_id="contain", executor=executor,
                        min_budget=1, max_budget=9, eta=3, seed=3)
        res = opt.run(n_iterations=2)  # (9,3,1)@(1,3,9), (5,1)@(3,9)
        opt.shutdown()
        runs = res.get_all_runs()
        assert [r for r in runs if r.loss is None], "expected the fused wave to crash"
        assert [r for r in runs if r.loss is not None], "the rest of the run must survive"
        b1 = [r for r in runs if r.config_id[0] == 1]
        assert b1 and all(r.loss is not None for r in b1)

    def test_nan_objective_crashes_rank_last(self):
        """A NaN-ing objective: crashed configs are recorded as crashed and
        never promoted ahead of a finite loss."""

        def nan_corner(vectors, budget):
            loss = branin(vectors, budget)
            return loss.masked_fill(vectors[:, 0] > 0.6, float("nan"))

        cs = branin_space(seed=4)
        executor = BatchedExecutor(VmapBackend(nan_corner, device="cpu"), cs)
        opt = BOHB(configspace=cs, run_id="nan", executor=executor, min_budget=1,
                   max_budget=9, eta=3, seed=4, min_points_in_model=4, device="cpu")
        res = opt.run(n_iterations=4)
        opt.shutdown()
        runs = res.get_all_runs()
        assert len(runs) == 13 + 6 + 3 + 13
        crashed = [r for r in runs if r.loss is None]
        assert crashed and all("non-finite" in r.error_logs for r in crashed)
        for it in opt.iterations:
            for s in range(1, len(it.budgets)):
                prev = [d for d in it.data.values() if it.budgets[s - 1] in d.results]
                promoted = [d for d in prev if it.budgets[s] in d.results]
                finite = [d for d in prev if d.results[it.budgets[s - 1]] is not None]
                # a crash is promoted only once every finite loss was
                n_crash_promoted = sum(d.results[it.budgets[s - 1]] is None for d in promoted)
                assert n_crash_promoted == max(0, len(promoted) - len(finite))


class TestRandomSearchBatched:
    def test_all_runs_at_max_budget(self):
        opt, _ = make_optimizer(RandomSearch)
        res = opt.run(n_iterations=2)
        opt.shutdown()
        runs = res.get_all_runs()
        assert len(runs) == 9 + 5
        assert all(r.budget == 9.0 for r in runs)


class TestResultLogging:
    def test_jsonl_roundtrip(self, tmp_path):
        logger = json_result_logger(str(tmp_path), overwrite=True)
        opt, _ = make_optimizer(HyperBand, result_logger=logger)
        res = opt.run(n_iterations=3)
        opt.shutdown()
        reloaded = logged_results_to_HBS_result(str(tmp_path))
        assert len(reloaded.get_all_runs()) == len(res.get_all_runs())
        assert reloaded.get_incumbent_id() == res.get_incumbent_id()
        orig = res.data[res.get_incumbent_id()].results[9.0]
        back = reloaded.data[reloaded.get_incumbent_id()].results[9.0]
        assert back == pytest.approx(orig)

    def test_fanova_and_dataframe_exports(self):
        pytest.importorskip("pandas")
        opt, _ = make_optimizer(HyperBand, seed=6)
        res = opt.run(n_iterations=2)
        opt.shutdown()
        X, y, cs = res.get_fANOVA_data(opt.configspace)
        assert X.shape[0] == y.shape[0] > 0
        assert X.shape[1] == 2
        assert np.isfinite(X).all()
        df_x, df_y = res.get_pandas_dataframe()
        assert len(df_x) == len(df_y) == len(res.get_all_runs())


class TestWarmStart:
    def test_previous_result_feeds_model(self):
        opt1, _ = make_optimizer(BOHB, seed=7, min_points_in_model=4)
        res1 = opt1.run(n_iterations=6)
        opt1.shutdown()
        opt2, _ = make_optimizer(BOHB, seed=8, min_points_in_model=4, previous_result=res1)
        # the model exists before any new evaluation
        assert opt2.config_generator.largest_budget_with_model() is not None
        res2 = opt2.run(n_iterations=1)
        opt2.shutdown()
        assert any(cid[0] < 0 for cid in res2.data)
        assert res2.get_incumbent_id() is not None


class TestFusedExecutorPath:
    def test_hyperband_uses_fusion_and_matches_counts(self):
        opt, executor = make_optimizer(HyperBand, executor_kw={"fuse_brackets": True})
        res = opt.run(n_iterations=3)
        opt.shutdown()
        assert executor.fused_brackets_run == 2  # the brackets with >= 2 stages
        assert executor.total_evaluated == 22
        assert len(res.get_all_runs()) == 22
        assert not executor._fused_cache, "unused fused results leaked"
        # every later-stage result came from the cache: 3 + 1 + 1
        assert (executor.fused_cache_hits, executor.fused_cache_misses) == (5, 0)

    def test_fused_equals_unfused_results(self):
        def run(fuse):
            opt, _ = make_optimizer(BOHB, seed=1, min_points_in_model=4,
                                    executor_kw={"fuse_brackets": fuse})
            res = opt.run(n_iterations=4)
            opt.shutdown()
            return {(r.config_id, r.budget): r.loss for r in res.get_all_runs()}

        runs_f, runs_u = run(True), run(False)
        assert set(runs_f) == set(runs_u)
        for key in runs_f:
            assert runs_f[key] == pytest.approx(runs_u[key], rel=1e-5), key


class TestFusedKernelAndBackend:
    def test_fused_bracket_matches_reference(self, ref):  # noqa: F811
        """``make_fused_bracket_fn`` against the reference's on the same
        vectors, a crash corner included: the same survivors at every
        stage and the same losses."""
        import jax.numpy as jnp

        def ref_eval(vec, budget):
            val = jnp.sum(jnp.square(vec - 0.3)) + 1.0 / budget
            return jnp.where(vec[0] > 0.8, jnp.nan, val)

        def port_eval(v, budget):
            val = torch.square(v - 0.3).sum(1) + 1.0 / budget
            return val.masked_fill(v[:, 0] > 0.8, float("nan"))

        x = np.random.default_rng(0).uniform(size=(27, 3)).astype(np.float32)
        x[3] = x[5]  # a tie
        shape = ((27, 9, 3, 1), (1.0, 3.0, 9.0, 27.0))
        want = ref.fused.make_fused_bracket_fn(ref_eval, *shape)(jnp.asarray(x))
        runner = make_fused_bracket_fn(port_eval, *shape, device="cpu")
        got = runner(x)
        assert make_fused_bracket_fn(port_eval, *shape, device="cpu") is runner
        assert runner.fetch(runner.dispatch(x))[-1][0].tolist() == got[-1][0].tolist()
        for (idx, losses), (idx_r, losses_r) in zip(got, want):
            np.testing.assert_array_equal(idx, np.asarray(idx_r))
            np.testing.assert_allclose(losses, np.asarray(losses_r), rtol=1e-6)

    def test_backend_pads_waves_to_a_power_of_two(self):
        seen = []

        def fn(v, budget):
            seen.append(v.shape[0])
            return branin(v, budget)

        backend = VmapBackend(fn, min_pad=8, device="cpu")
        x = np.random.default_rng(1).uniform(size=(9, 2))
        out = backend.evaluate(x, 3.0)
        assert seen == [16] and out.shape == (9,)
        np.testing.assert_array_equal(
            out, branin(torch.as_tensor(x, dtype=torch.float32), 3.0).numpy())
        backend.evaluate(x[:3], 1.0)
        assert seen[-1] == 8


# ------------------------------------------------------- against the reference
def _reference_run(ref, ref_opt, cls, seed, max_budget, n_iterations, **kw):  # noqa: F811
    cs = ref.toys.branin_space(seed=seed)
    ex = ref_opt.parallel.BatchedExecutor(ref_opt.parallel.VmapBackend(
        ref.toys.branin_from_vector), cs, bucket_brackets=False)
    opt = cls(configspace=cs, run_id="ref", executor=ex, min_budget=1,
              max_budget=max_budget, eta=3, seed=seed, **kw)
    res = opt.run(n_iterations=n_iterations)
    opt.shutdown()
    return opt, res


def _port_run(ref, cls, seed, max_budget, n_iterations, **kw):  # noqa: F811
    cs = branin_space(seed=seed)
    ex = BatchedExecutor(VmapBackend(branin, device="cpu"), cs)
    opt = cls(configspace=cs, run_id="port", executor=ex, min_budget=1,
              max_budget=max_budget, eta=3, seed=seed, device="cpu", **kw)
    opt.config_generator.draws = ReferenceKDEDraws(ref, trickle_seed=seed)
    res = opt.run(n_iterations=n_iterations)
    opt.shutdown()
    return opt, res


def _assert_same_runs(res_ref, res):
    runs_ref = sorted(res_ref.get_all_runs(), key=lambda r: (r.config_id, r.budget))
    runs = sorted(res.get_all_runs(), key=lambda r: (r.config_id, r.budget))
    assert [(r.config_id, r.budget) for r in runs] == [(r.config_id, r.budget) for r in runs_ref]
    id2c_ref, id2c = res_ref.get_id2config_mapping(), res.get_id2config_mapping()
    for cid in id2c_ref:
        assert id2c[cid]["config"] == id2c_ref[cid]["config"], cid
        info, info_ref = id2c[cid]["config_info"], id2c_ref[cid]["config_info"]
        assert info["model_based_pick"] == info_ref["model_based_pick"], cid
        if "lg_score" in info_ref:
            assert abs(info["lg_score"] - info_ref["lg_score"]) <= 1e-4 + 2e-6
    np.testing.assert_allclose([r.loss for r in runs], [r.loss for r in runs_ref],
                               atol=LOSS_ATOL, rtol=LOSS_RTOL)


def test_whole_run_parity_with_reference_candidates(ref, ref_opt):  # noqa: F811
    """``BOHB`` + ``BatchedExecutor`` + ``VmapBackend`` on Branin at
    ``max_budget=27``, 3 iterations, seed 0: every run has the reference's
    config and budget, the same ``model_based_pick`` and ``lg_score``
    within 1e-4, and losses within ``LOSS_ATOL``/``LOSS_RTOL``."""
    _, res_ref = _reference_run(ref, ref_opt, ref_opt.optimizers.BOHB, 0, 27, 3)
    opt, res = _port_run(ref, BOHB, 0, 27, 3)
    _assert_same_runs(res_ref, res)
    assert sum(v["config_info"]["model_based_pick"]
               for v in res.get_id2config_mapping().values()) > 10


def test_h2bo_promotes_what_the_reference_promotes(ref, ref_opt):  # noqa: F811
    """``H2BO``'s learning-curve promotions, with the reference's
    candidates: the same runs, so the same configs promoted at every
    rung, and the same extrapolated scores."""
    opt_ref, res_ref = _reference_run(ref, ref_opt, ref_opt.h2bo.H2BO, 2, 27, 3,
                                      min_points_in_model=4)
    opt, res = _port_run(ref, H2BO, 2, 27, 3, min_points_in_model=4)
    _assert_same_runs(res_ref, res)
    assert opt.iterations[0].promotion_rule == opt_ref.iterations[0].promotion_rule
    # the scores bracket 0's last promotion ranked by: power-law
    # extrapolations of 3-point curves, equal on both sides
    curves = [[(b, v) for b, v in sorted(d.results.items()) if v is not None]
              for d in opt.iterations[0].data.values() if len(d.results) >= 3]
    assert curves
    for c in curves:
        assert opt.lc_model.predict(c, 27.0) == opt_ref.lc_model.predict(c, 27.0)


def test_successive_resampling_matches_reference(ref, ref_opt):  # noqa: F811
    """``SuccessiveResampling``: fewer promotions, the rest of each later
    stage sampled afresh (model waves at later stages too), with the
    reference's candidates: the same runs."""
    _, res_ref = _reference_run(
        ref, ref_opt, ref_opt.optimizers.BOHB, 1, 27, 2, min_points_in_model=4,
        iteration_class=ref_opt.successive_halving.SuccessiveResampling)
    _, res = _port_run(ref, BOHB, 1, 27, 2, min_points_in_model=4,
                       iteration_class=SuccessiveResampling)
    _assert_same_runs(res_ref, res)
    assert any(cid[1] > 0 for cid in res.get_id2config_mapping())


def test_learning_curve_models_match_reference(ref_opt):  # noqa: F811
    """``LastValueModel`` and ``PowerLawModel`` predict what the
    reference's do, on seeded curves with crashes and rising tails."""
    lc = ref_opt.learning_curves
    rng = np.random.default_rng(3)
    for i in range(60):
        budgets = [1.0, 3.0, 9.0, 27.0][: 1 + i % 4]
        losses = list(2.0 * np.array(budgets) ** -rng.uniform(0.1, 1.0) + rng.normal(0, 0.05))
        if i % 7 == 0:
            losses[-1] = float("nan")
        curve = list(zip(budgets, losses))
        for mine, theirs in ((LastValueModel(), lc.LastValueModel()),
                             (PowerLawModel(), lc.PowerLawModel()),
                             (PowerLawModel(floor=1e-9), lc.PowerLawModel(floor=1e-9))):
            a, b = mine.predict(curve, 81.0), theirs.predict(curve, 81.0)
            assert a == b or (np.isnan(a) and np.isnan(b))
