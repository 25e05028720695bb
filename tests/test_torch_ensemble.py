"""The batched-SGD MLP ensemble (``workloads/ensemble.py``), the port's
``StatefulEval`` workload, on the CPU.

- Warm continuation: a config promoted through the rung ladder exits with
  exactly the state an uninterrupted run of the same cumulative step
  count gives (bit for bit: each lane's arithmetic does not depend on how
  many lanes train beside it).
- Crash containment: a poisoned lane leaves every other lane bit for bit
  unchanged, ranks last and is never promoted.
- ``FusedBOHB(stateful_eval=...)``: the resident tier equals the unrolled
  dynamic tier bit for bit.
- Against the reference's ensemble on its own dataset and initial
  weights: losses and state within 1e-5 (float32 sums in another order
  through a few steps; the unit-scale init scaled per lane is an ulp from
  the reference's scaled normals).
"""

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch import FusedBOHB
from hpbandster_tpu_torch.convert import dataset_from_numpy, params_from_numpy
from hpbandster_tpu_torch.ops.fused import StatefulEval, fused_sh_bracket, tree_leaves, tree_map
from hpbandster_tpu_torch.workloads.ensemble import (
    EnsembleState,
    ensemble_lane_bytes,
    make_mlp_ensemble,
    make_uninterrupted_train_fn,
)
from hpbandster_tpu_torch.workloads.mlp import MLPConfig, mlp_space
from tests.test_torch_harness import ref, ref_wl  # noqa: F401

CFG = MLPConfig(d_in=8, width=16, n_classes=4, n_train=128, n_val=64, batch_size=32)
TOL = 1e-5


def _vectors(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).random((n, 4)).astype(np.float32))


def _assert_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(torch.nan_to_num(x, nan=7.0), torch.nan_to_num(y, nan=7.0))
        assert torch.equal(torch.isnan(x), torch.isnan(y))


def test_promoted_lanes_equal_the_uninterrupted_run():
    se = make_mlp_ensemble(CFG, device="cpu")
    v = 0.9 * _vectors(9, seed=3)
    stages, state = fused_sh_bracket(None, v, (9, 3, 1), (1.0, 3.0, 9.0), stateful=se,
                                     return_final_state=True)
    survivors = stages[-1][0]
    want_state, want_loss = make_uninterrupted_train_fn(CFG, device="cpu")(v[survivors], 9)
    _assert_bitwise(state, want_state)
    assert torch.equal(stages[-1][1], want_loss)
    # the middle rung too: its survivors after 3 cumulative steps
    mid = make_uninterrupted_train_fn(CFG, device="cpu")(v[stages[1][0]], 3)[1]
    assert torch.equal(stages[1][1], mid)


def test_budget_ladder_must_not_decrease():
    se = make_mlp_ensemble(CFG, device="cpu")
    with pytest.raises(ValueError, match="non-decreasing"):
        se.step_fn(se.init_fn(_vectors(2)), _vectors(2), 1.0, 5.0)


def test_poisoned_lane_leaves_other_lanes_bitwise_unchanged():
    se = make_mlp_ensemble(CFG, device="cpu")
    v = _vectors(4, seed=11)
    clean = se.init_fn(v)
    poisoned = tree_map(lambda t: t.clone().index_fill_(0, torch.tensor([1]), float("nan")),
                        clean)
    clean_state, clean_loss = se.step_fn(clean, v, 5.0, 0.0)
    pois_state, pois_loss = se.step_fn(poisoned, v, 5.0, 0.0)
    assert torch.isnan(pois_loss[1])
    assert all(bool(torch.isnan(leaf[1]).all()) for leaf in tree_leaves(pois_state))
    keep = [0, 2, 3]
    assert torch.equal(clean_loss[keep], pois_loss[keep])
    _assert_bitwise(tree_map(lambda t: t[keep], clean_state),
                    tree_map(lambda t: t[keep], pois_state))


def test_crashed_lane_ranks_last_and_never_promotes():
    se = make_mlp_ensemble(CFG, device="cpu")

    def crash_step(state, vectors, budget, prev_budget):
        state, losses = se.step_fn(state, vectors, budget, prev_budget)
        crashed = vectors[:, 3] >= 0.999
        losses = torch.where(crashed, torch.full_like(losses, float("nan")), losses)
        state = tree_map(lambda t: torch.where(
            crashed.reshape((-1,) + (1,) * (t.dim() - 1)), torch.full_like(t, float("nan")), t),
            state)
        return state, losses

    doomed = 2
    v = 0.9 * _vectors(8, seed=5)
    v[doomed, 3] = 1.0
    stages, state = fused_sh_bracket(None, v, (8, 4, 2), (1.0, 3.0, 9.0),
                                     stateful=StatefulEval(se.init_fn, crash_step),
                                     return_final_state=True)
    assert torch.isnan(stages[0][1][doomed])
    for idx, _ in stages[1:]:
        assert doomed not in idx.tolist()
    assert all(bool(torch.isfinite(leaf).all()) for leaf in tree_leaves(state))


def test_fused_bohb_resident_equals_unrolled():
    se = make_mlp_ensemble(CFG, device="cpu")
    out = []
    for kw in (dict(resident=True), dict(dynamic_counts=True)):
        opt = FusedBOHB(configspace=mlp_space(seed=0), stateful_eval=se, min_budget=1,
                        max_budget=9, eta=3, seed=0, num_samples=16, device="cpu")
        res = opt.run(n_iterations=4, **kw)
        out.append((opt, sorted((r.config_id, r.budget, r.loss) for r in res.get_all_runs())))
    (opt_r, runs_r), (opt_u, runs_u) = out
    assert runs_r == runs_u and len(runs_r) == 9 + 3 + 1 + 5 + 1 + 3 + 9 + 3 + 1
    for b in opt_u._warm_v:
        np.testing.assert_array_equal(opt_r._warm_v[b], opt_u._warm_v[b])
        np.testing.assert_array_equal(opt_r._warm_l[b], opt_u._warm_l[b])
    assert all(np.isfinite(loss) for _, _, loss in runs_r)


def test_state_layout_and_lane_bytes(ref_wl):
    se = make_mlp_ensemble(CFG, device="cpu")
    state = se.init_fn(_vectors(3))
    assert isinstance(state, EnsembleState)
    assert state.params["w1"].shape == (3, 8, 16) and not state.velocity["w1"].any()
    lane = sum(t[0].numel() * t.element_size() for t in tree_leaves(state))
    rcfg = ref_wl.mlp.MLPConfig(**CFG._asdict())
    assert ensemble_lane_bytes(CFG) == lane == ref_wl.ensemble.ensemble_lane_bytes(rcfg)


def test_matches_the_reference_ensemble(ref_wl):
    """The reference's ensemble and the port's on the reference's dataset
    and initial weights: a rung of 4 lanes to 3 steps, then 2 survivors
    continued to 9."""
    import jax

    rcfg = ref_wl.mlp.MLPConfig(**CFG._asdict())
    data = ref_wl.mlp.make_synthetic_dataset(jax.random.key(0), rcfg)
    unit = ref_wl.mlp.init_mlp_params(jax.random.key(1), rcfg, 1.0)
    port = make_mlp_ensemble(CFG, device="cpu",
                             data=dataset_from_numpy(jax.tree.map(np.asarray, data)),
                             init=params_from_numpy(jax.tree.map(np.asarray, unit)))
    ref_se = ref_wl.ensemble.make_mlp_ensemble(rcfg, 0)
    v = (0.8 * np.random.default_rng(2).random((4, 4))).astype(np.float32)
    keep = np.array([0, 3])

    @jax.jit
    def ref_run(v):
        s, l1 = ref_se.step_fn(ref_se.init_fn(v), v, 3.0, 0.0)
        s = jax.tree.map(lambda t: t[keep], s)
        s, l2 = ref_se.step_fn(s, v[keep], 9.0, 3.0)
        return s, l1, l2

    want_state, want_l1, want_l2 = ref_run(v)
    tv = torch.from_numpy(v)
    state, l1 = port.step_fn(port.init_fn(tv), tv, 3.0, 0.0)
    state, l2 = port.step_fn(tree_map(lambda t: t[keep], state), tv[keep], 9.0, 3.0)
    np.testing.assert_allclose(l1.numpy(), np.asarray(want_l1), rtol=TOL)
    np.testing.assert_allclose(l2.numpy(), np.asarray(want_l2), rtol=TOL)
    for part in ("params", "velocity"):
        for k, w in getattr(want_state, part).items():
            np.testing.assert_allclose(getattr(state, part)[k].numpy(), np.asarray(w),
                                       rtol=TOL, atol=TOL)
