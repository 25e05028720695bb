"""The resident tier against the unrolled dynamic tier in the optimizer's
other entry states, on the CPU: after a warm start from ``previous_result=``,
across a checkpoint and ``load_checkpoint``, for ``FusedH2BO``,
``FusedRandomSearch`` and ``FusedHyperBand``, and ``run_incumbent`` after a
``run()``.

Branin at budgets 1..27 (a 4-bracket rotation, so 5 or more brackets
replay a round and run a tail). Tolerance: none. Both tiers run the same
round body on the same draws, so the ``Result`` (runs, configurations,
model flags) and the warm observation buffers are equal bit for bit.
"""

import numpy as np
import pytest

from hpbandster_tpu_torch import FusedBOHB, FusedH2BO, FusedHyperBand, FusedRandomSearch
from hpbandster_tpu_torch.workloads.toys import branin, branin_space

TIERS = (dict(dynamic_counts=True), dict(resident=True))


def _make(cls=FusedBOHB, seed=3, **kw):
    return cls(configspace=branin_space(seed=0), eval_fn=branin, min_budget=1,
               max_budget=27, eta=3, seed=seed, num_samples=16, device="cpu", **kw)


def _assert_same(pair):
    (opt_u, res_u), (opt_r, res_r) = pair

    def runs(res):
        return sorted((r.config_id, r.budget, r.loss) for r in res.get_all_runs())

    def flags(res):
        return {c: v["config_info"]["model_based_pick"]
                for c, v in res.get_id2config_mapping().items()}

    assert runs(res_r) == runs(res_u)
    assert res_r.get_id2config_mapping() == res_u.get_id2config_mapping()
    assert flags(res_r) == flags(res_u)
    assert set(opt_r._warm_v) == set(opt_u._warm_v)
    for b in opt_u._warm_v:
        np.testing.assert_array_equal(opt_r._warm_v[b], opt_u._warm_v[b])
        np.testing.assert_array_equal(opt_r._warm_l[b], opt_u._warm_l[b])


def test_resident_equals_unrolled_after_previous_result():
    """Warm data from an earlier sweep's ``Result`` feeds both tiers alike."""
    prev = _make(seed=11).run(n_iterations=3)
    pair = []
    for tier in TIERS:
        opt = _make(previous_result=prev)
        pair.append((opt, opt.run(n_iterations=6, **tier)))
    assert len(pair[0][1].get_all_runs()) > len(prev.get_all_runs())
    _assert_same(pair)


def test_resident_equals_unrolled_across_a_checkpoint(tmp_path):
    """A run that writes a checkpoint, a fresh optimizer that loads it and
    a second ``run()``: the resumed resident run equals the resumed
    unrolled run."""
    pair = []
    for i, tier in enumerate(TIERS):
        path = str(tmp_path / f"ckpt_{i}.pkl")
        _make().run(n_iterations=3, checkpoint_path=path, **tier)
        opt = _make()
        opt.load_checkpoint(path)
        pair.append((opt, opt.run(n_iterations=7, **tier)))
    assert len(pair[0][0].iterations) == 7
    _assert_same(pair)


@pytest.mark.parametrize("cls", [FusedH2BO, FusedRandomSearch, FusedHyperBand])
def test_subclass_resident_equals_unrolled(cls):
    pair = []
    for tier in TIERS:
        opt = _make(cls)
        pair.append((opt, opt.run(n_iterations=6, **tier)))
    _assert_same(pair)


def test_run_incumbent_after_a_run_is_the_same_on_both_tiers():
    """``run_incumbent(6)`` after a 3-bracket ``run()`` takes the run's
    observations as warm data; the resident and the unrolled
    incumbent-only sweeps give the same payload."""
    outs = []
    for resident in (True, False):
        opt = _make()
        opt.run(n_iterations=3)
        outs.append(opt.run_incumbent(n_iterations=6, resident=resident))
    assert outs[0]["incumbent"] == outs[1]["incumbent"]
    assert outs[0]["evaluations"] == outs[1]["evaluations"]
    assert outs[0]["transfers"] == outs[1]["transfers"]
    assert np.isfinite(outs[0]["incumbent"]["loss"])
