"""The dynamic-count tier: the port's ``fit_kde_pair_masked`` and dynamic
sweep against the reference's, and the tier's guards.

The whole-sweep cases feed the reference's own random draws into the port
(``ReferenceDraws``) and compare bracket by bracket at the tolerances of
``tests/test_torch_sweep.py``: vectors ``1e-6``, model masks and stage
indices exact, losses ``LOSS_TOL``; the returned state must agree too
(buffers at the same tolerances, counts exact). The reference runs its
Pallas scorer and, with ``HPB_PALLAS_KDE_FIT=1``, its Pallas moment kernel in
the interpreter; the port runs their plain versions.
"""

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch.convert import dynamic_obs_from_numpy
from hpbandster_tpu_torch.ops import cuda_kde, kde
from hpbandster_tpu_torch.ops import sweep as tsweep
from hpbandster_tpu_torch.ops.fused import _unpack_stages
from hpbandster_tpu_torch.ops.sweep import (
    build_space_codec,
    make_fused_sweep_fn,
    plan_additions,
    pow2_capacities,
)
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_harness import (  # noqa: F401
    ReferenceDraws,
    codecs,
    eval_fns,
    plans_for,
    ref,
)
from tests.test_torch_sweep import LOSS_TOL, NUM_SAMPLES, _assert_sweeps_match


# ------------------------------------------------------------------- the fit
@pytest.mark.parametrize("flag", [None, "1"])
def test_fit_matches_reference(ref, monkeypatch, flag):
    """Same sorted rows, same rank masks, bandwidths within 1e-6, on a
    buffer with ties, crashes (+inf) and +inf pads, over the mixed space's
    discrete dims."""
    import jax.numpy as jnp

    if flag is None:
        monkeypatch.delenv("HPB_PALLAS_KDE_FIT", raising=False)
    else:
        monkeypatch.setenv("HPB_PALLAS_KDE_FIT", flag)
    rc, codec = codecs(ref, "mixed")
    cap, count = 256, 60
    rng = np.random.default_rng(5)
    d = len(codec.cards)
    vecs = rng.uniform(size=(cap, d)).astype(np.float32)
    for j, k in enumerate(codec.cards):
        if k:
            vecs[:, j] = rng.integers(k, size=cap)
    losses = np.full(cap, np.inf, np.float32)
    losses[:count] = np.round(rng.normal(size=count), 1)  # ties
    losses[[3, 17]] = np.inf  # crashes
    vecs[count:] = 0.0
    n_good, n_bad = 9, 51
    args = (np.int32(count), np.int32(n_good), np.int32(n_bad))

    want = ref.kde.fit_kde_pair_masked(
        jnp.asarray(vecs), jnp.asarray(losses), *map(jnp.asarray, args),
        jnp.asarray(codec.cards), 1e-3,
    )
    got = kde.fit_kde_pair_masked(
        torch.from_numpy(vecs), torch.from_numpy(losses),
        *(torch.tensor(int(a), dtype=torch.int32) for a in args),
        torch.from_numpy(codec.cards), 1e-3,
    )
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
        np.testing.assert_allclose(g.bw.numpy(), np.asarray(w.bw), rtol=0, atol=1e-6)


def test_empty_mask_donors_stay_finite():
    """A fit on empty buffers (no gate open) still draws candidates: every
    donor is the last row, and the draw never raises. With rows masked in,
    donors land only on them."""
    mask = torch.zeros(256)
    u = torch.rand(1000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(kde._masked_donors(mask, u), torch.full((1000,), 255))
    mask[[4, 9, 200]] = 1.0
    idx = kde._masked_donors(mask, u)
    assert set(idx.tolist()) == {4, 9, 200}
    good = kde.KDE(torch.rand(256, 2), torch.zeros(256), torch.full((2,), 0.1))
    cands = kde.generate_candidates(
        torch.Generator().manual_seed(1), good, torch.zeros(2, dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32), 64,
    )
    assert bool(torch.isfinite(cands).all())


# ------------------------------------------------------------ whole sweeps
def _warm_dynamic(caps, d, seed=3):
    """Warm Branin observations at budgets 9 and 27 (two crashes each) as
    full-capacity numpy buffers with counts."""
    rng = np.random.default_rng(seed)
    warm_v, warm_l, warm_n = {}, {}, {}
    for b, cap in caps.items():
        warm_v[b] = np.zeros((cap, d), np.float32)
        warm_l[b] = np.full(cap, np.inf, np.float32)
        warm_n[b] = np.int32(0)
    for b, n in ((9.0, 30), (27.0, 12)):
        v = rng.uniform(size=(n, d)).astype(np.float32)
        l = branin(torch.from_numpy(v), b).numpy()
        l[:2] = np.nan
        warm_v[b][:n], warm_l[b][:n], warm_n[b] = v, l, np.int32(n)
    return warm_v, warm_l, warm_n


def run_dynamic_pair(ref, name, n_iterations, warm=False, seed=1234):
    """The reference's and the port's dynamic sweep on the same draws:
    returns ``((want, want_state), (got, got_state))``."""
    rc, codec = codecs(ref, name)
    ref_eval, port_eval = eval_fns(ref, name)
    plans = plans_for(n_iterations)
    counts = plan_additions(plans)
    if warm:
        counts[9.0] += 30
        counts[27.0] += 12
    caps = pow2_capacities(counts)
    d = len(codec.cards)
    ref_fn = ref.sweep.make_fused_sweep_fn(
        ref_eval, plans, rc, num_samples=NUM_SAMPLES, use_pallas=True,
        pallas_interpret=True, dynamic_counts=True, capacities=caps,
        return_state=True,
    )
    port_fn = make_fused_sweep_fn(
        port_eval, plans, codec, device="cpu", num_samples=NUM_SAMPLES,
        dynamic_counts=True, capacities=caps, return_state=True,
    )
    draws = ReferenceDraws(ref, rc, seed)
    if warm:
        wv, wl, wn = _warm_dynamic(caps, d)
        want = ref_fn(np.uint32(seed), wv, wl, wn)
        got = port_fn(seed, *dynamic_obs_from_numpy(wv, wl, wn), draws=draws)
    else:
        want = ref_fn(np.uint32(seed))
        got = port_fn(seed, draws=draws)
    return want, got


def assert_states_match(want_state, got_state, loss_tol):
    (wv, wl, wn), (gv, gl, gn) = want_state, got_state
    assert set(gv) == {float(b) for b in wv}
    for b in wv:
        assert int(gn[float(b)]) == int(wn[b]), f"count at budget {b}"
        np.testing.assert_allclose(gv[float(b)].numpy(), np.asarray(wv[b]),
                                   rtol=0, atol=1e-6, err_msg=f"buffer {b}")
        np.testing.assert_allclose(gl[float(b)].numpy(), np.asarray(wl[b]),
                                   rtol=loss_tol, atol=loss_tol, err_msg=f"losses {b}")


def check_dynamic_sweep(ref, monkeypatch, name, n_iterations, warm, flag):
    if flag is None:
        monkeypatch.delenv("HPB_PALLAS_KDE_FIT", raising=False)
    else:
        monkeypatch.setenv("HPB_PALLAS_KDE_FIT", flag)
    (want, want_state), (got, got_state) = run_dynamic_pair(
        ref, name, n_iterations, warm=warm
    )
    n_model = _assert_sweeps_match(want, got, LOSS_TOL[name])
    assert n_model > 0, "no bracket ran the model path"
    # cold: bracket 0 fits on empty buffers and discards every pick; warm:
    # the gate is open from the first bracket on
    assert bool(got[0].model_based.any()) == warm
    assert_states_match(want_state, got_state, LOSS_TOL[name])


@pytest.mark.parametrize(
    "name,n_iterations,warm,flag",
    [("branin", 6, False, None), ("branin", 3, True, None)],
)
def test_dynamic_sweep_matches_reference(ref, monkeypatch, name, n_iterations,
                                         warm, flag):
    """Branin, six brackets at max_budget 27 (the gate opens mid-sweep, so
    early brackets fit on empty or closed buffers), and three brackets on
    warm buffers."""
    check_dynamic_sweep(ref, monkeypatch, name, n_iterations, warm, flag)


# ---------------------------------------------------------------- guards
def _branin_dynamic(caps, plans, **kw):
    return make_fused_sweep_fn(
        branin, plans, build_space_codec(branin_space(seed=3)), device="cpu",
        num_samples=8, dynamic_counts=True, capacities=caps, return_state=True,
        **kw,
    )


def test_warm_count_is_clamped_to_leave_room_for_the_appends():
    """An oversized warm count keeps only ``capacity - additions`` warm rows,
    so every append stays inside the buffer: the newest warm rows are
    dropped, the fresh observations all land."""
    plans = plans_for(1, max_budget=9.0)
    adds = plan_additions(plans)
    caps = {b: k + 4 for b, k in adds.items()}
    wv = {b: np.full((cap, 2), 0.5, np.float32) for b, cap in caps.items()}
    wl = {b: np.full(cap, 1.0, np.float32) for b, cap in caps.items()}
    wn = {b: np.int32(cap) for b, cap in caps.items()}  # full: no room left
    outs, (ov, ol, on) = _branin_dynamic(caps, plans)(
        0, *dynamic_obs_from_numpy(wv, wl, wn)
    )
    for b, cap in caps.items():
        assert int(on[b]) == cap
        assert bool((ol[b][:4] == 1.0).all())
        assert bool((ol[b][4:] != 1.0).all()), f"budget {b} lost fresh rows"
        fresh = np.sort(ol[b][4:].numpy())
        stage = [i for i, bb in enumerate(plans[0].budgets) if float(bb) == b][0]
        _, losses = _unpack_stages(
            (outs[0].idx_packed, outs[0].loss_packed), plans[0].num_configs
        )[stage]
        np.testing.assert_array_equal(fresh, np.sort(losses))


def test_oversized_capacities_default_missing_budgets_to_empty():
    """A budget in ``capacities`` but in none of the warm dicts starts as
    an empty buffer instead of raising."""
    plans = plans_for(1, max_budget=9.0)
    adds = plan_additions(plans)
    caps = dict(adds)
    caps[27.0] = 8  # capacity, but no warm data for it
    wv = {b: np.zeros((adds[b], 2), np.float32) for b in adds}
    wl = {b: np.full(adds[b], np.inf, np.float32) for b in adds}
    wn = {b: np.int32(0) for b in adds}
    outs, (_, ol, on) = _branin_dynamic(caps, plans)(
        0, *dynamic_obs_from_numpy(wv, wl, wn)
    )
    assert len(outs) == len(plans)
    assert int(on[27.0]) == 0 and bool(torch.isinf(ol[27.0]).all())
    assert bool(torch.isfinite(outs[0].loss_packed).any())


def test_partially_missing_warm_budget_is_named():
    plans = plans_for(1, max_budget=9.0)
    adds = plan_additions(plans)
    wv = {b: np.zeros((adds[b], 2), np.float32) for b in adds}
    wl = {b: np.full(adds[b], np.inf, np.float32) for b in adds}
    wn = {b: np.int32(0) for b in adds}
    tv, tl, tn = dynamic_obs_from_numpy(wv, wl, wn)
    del tv[sorted(adds)[0]]  # in warm_n and warm_l, not in warm_v
    with pytest.raises(ValueError, match="inconsistent warm inputs"):
        _branin_dynamic(adds, plans)(0, tv, tl, tn)


def test_capacities_must_hold_the_sweep():
    plans = plans_for(2, max_budget=9.0)
    caps = {b: 1 for b in plan_additions(plans)}
    with pytest.raises(ValueError, match="cannot hold"):
        _branin_dynamic(caps, plans)


def test_unreachable_model_skips_fit_and_scorer(monkeypatch):
    """With ``min_points_in_model`` out of reach no gate can open even at
    full capacity: every pick is random and neither the fit, the moment
    pass nor the scorer runs, plain or kernel."""
    def boom(*a, **k):
        raise AssertionError("model math ran with no trainable budget")

    monkeypatch.setenv("HPB_PALLAS_KDE_FIT", "1")
    for mod, name in ((cuda_kde, "score_candidates"), (cuda_kde, "masked_moments"),
                      (cuda_kde, "moment_bandwidths"), (tsweep, "fit_kde_pair_masked"),
                      (kde, "normal_reference_bandwidths")):
        monkeypatch.setattr(mod, name, boom)
    plans = plans_for(4, max_budget=9.0)
    caps = pow2_capacities(plan_additions(plans))
    outs, (_, _, on) = _branin_dynamic(caps, plans, min_points_in_model=10**6)(0)
    assert not any(bool(o.model_based.any()) for o in outs)
    assert sum(int(n) for n in on.values()) == sum(sum(p.num_configs) for p in plans)
