"""The slice as a whole: the port's static-tier sweep and ``FusedBOHB.run()``
against the reference.

Through the draw seam the port consumes the reference's own random draws
(``ReferenceDraws``), so the two sweeps must agree bracket by bracket: the
reference runs its Pallas scorer in the interpreter, the port its plain
scorer. Tolerances: vectors ``1e-6`` (the same float32 codec and candidate
math), model-based masks and stage indices identical, losses ``1e-5`` on the
mixed space. Branin's losses get ``atol 1e-4, rtol 1e-4``: the reference
evaluates Branin inside its compiled sweep, where XLA contracts the
polynomial differently from eager PyTorch; its terms reach a few hundred (a
float32 ulp of 3e-5) and cancel, so the error is absolute (measured up to
6.3e-5 on a loss of 0.08).
"""

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch import FusedBOHB
from hpbandster_tpu_torch.convert import warm_obs_from_numpy
from hpbandster_tpu_torch.ops.bracket import hyperband_bracket
from hpbandster_tpu_torch.ops.sweep import make_fused_sweep_fn
from hpbandster_tpu_torch.workloads.toys import (
    branin,
    branin_space,
    hartmann6,
    hartmann6_space,
)
from tests.test_torch_harness import (  # noqa: F401
    ReferenceDraws,
    codecs,
    eval_fns,
    plans_for,
    ref,
)

NUM_SAMPLES = 32


def _warm(seed=3):
    """Warm Branin observations at budgets 9 and 27 (a few crashes): the
    model gate is open from the first bracket on."""
    rng = np.random.default_rng(seed)
    warm_v, warm_l = {}, {}
    for b, n in ((9.0, 30), (27.0, 12)):
        v = rng.uniform(size=(n, 2)).astype(np.float32)
        l = branin(torch.from_numpy(v), b).numpy()
        l[:2] = np.nan
        warm_v[b], warm_l[b] = v, l
    return warm_v, warm_l


#: loss tolerance of the whole-sweep comparison, per objective (see above)
LOSS_TOL = {"branin": 1e-4, "mixed": 1e-5}


def _assert_sweeps_match(want, got, loss_tol):
    assert len(want) == len(got)
    n_model = 0
    for b_i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(
            g.vectors.numpy(), np.asarray(w.vectors), rtol=0, atol=1e-6,
            err_msg=f"bracket {b_i} vectors")
        np.testing.assert_array_equal(
            g.model_based.numpy(), np.asarray(w.model_based),
            err_msg=f"bracket {b_i} model_based")
        np.testing.assert_array_equal(
            g.idx_packed.numpy(), np.asarray(w.idx_packed),
            err_msg=f"bracket {b_i} stage indices")
        np.testing.assert_allclose(
            g.loss_packed.numpy(), np.asarray(w.loss_packed), rtol=loss_tol,
            atol=loss_tol, err_msg=f"bracket {b_i} losses")
        n_model += int(np.asarray(w.model_based).sum())
    return n_model


@pytest.mark.parametrize(
    "name,n_iterations,warm",
    [("branin", 6, False), ("mixed", 5, False), ("branin", 3, True)],
)
def test_sweep_matches_reference(ref, name, n_iterations, warm):
    rc, codec = codecs(ref, name)
    ref_eval, port_eval = eval_fns(ref, name)
    plans = plans_for(n_iterations)
    seed = 1234
    warm_v, warm_l = _warm() if warm else ({}, {})
    warm_counts = {b: len(l) for b, l in warm_l.items()}
    ref_fn = ref.sweep.make_fused_sweep_fn(
        ref_eval, plans, rc, num_samples=NUM_SAMPLES, warm_counts=warm_counts,
        use_pallas=True, pallas_interpret=True,
    )
    want = ref_fn(np.uint32(seed), warm_v, warm_l) if warm else ref_fn(np.uint32(seed))

    port_fn = make_fused_sweep_fn(
        port_eval, plans, codec, device="cpu", num_samples=NUM_SAMPLES,
        warm_counts=warm_counts,
    )
    tv, tl = warm_obs_from_numpy(warm_v, warm_l)
    got = port_fn(seed, tv, tl, draws=ReferenceDraws(ref, rc, seed))
    n_model = _assert_sweeps_match(want, got, LOSS_TOL[name])
    assert n_model > 0, "no bracket ran the model path"


@pytest.mark.parametrize(
    "space,eval_fn,ref_name",
    [(branin_space, branin, "branin_from_vector"),
     (hartmann6_space, hartmann6, "hartmann6_from_vector")],
)
def test_objectives_match(ref, space, eval_fn, ref_name):
    import jax
    import jax.numpy as jnp

    d = len(space().get_hyperparameters())
    v = np.random.default_rng(d).uniform(size=(64, d)).astype(np.float32)
    for budget in (1.0, 9.0, 81.0):
        want = jax.vmap(lambda x: getattr(ref.toys, ref_name)(x, budget))(jnp.asarray(v))
        got = eval_fn(torch.from_numpy(v), budget).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-5)


def _runs_per_budget(result):
    out = {}
    for r in result.get_all_runs():
        out[r.budget] = out.get(r.budget, 0) + 1
    return out


def _expected_runs_per_budget(n_iterations, max_budget):
    out = {}
    for i in range(n_iterations):
        p = hyperband_bracket(i, 1.0, max_budget, 3.0)
        for k, b in zip(p.num_configs, p.budgets):
            out[b] = out.get(b, 0) + k
    return out


def test_fused_bohb_run_matches_reference_shapes(ref):
    """A seeded end-to-end ``FusedBOHB.run()`` with the port's own
    generator: the ``Result`` has the reference's bracket shapes and runs
    per budget, and a second call continues the rotation."""
    from hpbandster_tpu.optimizers.fused_bohb import FusedBOHB as RefFusedBOHB

    kw = dict(min_budget=1, max_budget=27, eta=3, num_samples=NUM_SAMPLES, seed=0)
    ref_opt = RefFusedBOHB(configspace=ref.toys.branin_space(seed=0),
                           eval_fn=ref.toys.branin_from_vector, use_pallas=False, **kw)
    want = ref_opt.run(n_iterations=5)
    opt = FusedBOHB(configspace=branin_space(seed=0), eval_fn=branin,
                    device="cpu", **kw)
    got = opt.run(n_iterations=5)

    assert _runs_per_budget(got) == _runs_per_budget(want) == \
        _expected_runs_per_budget(5, 27.0)
    assert [(it.num_configs, it.budgets) for it in opt.iterations] == \
        [(it.num_configs, it.budgets) for it in ref_opt.iterations]
    assert got.num_iterations() == want.num_iterations() == 5
    losses = [r.loss for r in got.get_all_runs()]
    assert all(np.isfinite(losses))
    inc = got.get_incumbent_id()
    assert inc is not None and got.get_runs_by_id(inc)[-1].budget == 27.0
    info = got.get_id2config_mapping()[inc]["config_info"]
    assert info["fused_sweep"] is True
    assert any(d.config_info["model_based_pick"] for d in got.data.values())

    # resume: the next call runs only the remaining brackets, on warm data
    more = opt.run(n_iterations=7)
    assert _runs_per_budget(more) == _expected_runs_per_budget(7, 27.0)
    assert len(opt.run_stats) == 2 and opt.run_stats[1]["brackets"] == [5, 6]


def test_fused_bohb_is_deterministic_in_its_seed():
    def run(seed):
        opt = FusedBOHB(configspace=hartmann6_space(seed=0), eval_fn=hartmann6,
                        min_budget=1, max_budget=9, eta=3, num_samples=16,
                        seed=seed, device="cpu")
        res = opt.run(n_iterations=4)
        return sorted((r.config_id, r.budget, r.loss) for r in res.get_all_runs())

    assert run(0) == run(0)
    assert run(0) != run(1)


def test_result_logger_round_trip(tmp_path):
    """The port's JSONL result logger writes every replayed run, and the
    logs reload into a Result with the same runs."""
    from hpbandster_tpu_torch.core.result import (
        json_result_logger,
        logged_results_to_HBS_result,
    )

    logger = json_result_logger(str(tmp_path), overwrite=True)
    opt = FusedBOHB(configspace=branin_space(seed=0), eval_fn=branin,
                    min_budget=1, max_budget=9, eta=3, num_samples=8, seed=2,
                    device="cpu", result_logger=logger)
    res = opt.run(n_iterations=3)
    back = logged_results_to_HBS_result(str(tmp_path))

    def runs(r):
        return sorted((r_.config_id, r_.budget, r_.loss) for r_ in r.get_all_runs())

    assert runs(back) == runs(res) and len(runs(res)) == opt.total_evaluated
