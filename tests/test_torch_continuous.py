"""The port's continuous batching (``hpbandster_tpu_torch/serve/continuous.py``)
against the reference's (``hpbandster_tpu/serve/continuous.py``), on the CPU.

The lane allocator is host code and places every chunk as the reference's
does. The resident lane program's carry folds, resets and decodes as the
reference's (NaN for a lane that has only crashed), incumbents within
``atol 1e-4, rtol 1e-4`` (Branin evaluated by XLA and by eager PyTorch,
ROADMAP C.15). Inside the port each lane's results equal a solo dispatch
bit for bit across tenant churn, the family's program is built once, no
incumbent leaks from one lane owner to the next, and churning pool
tenants equal their solo runs.
"""

import threading

import numpy as np
import pytest

from hpbandster_tpu_torch.ops.bracket import BracketPlan
from hpbandster_tpu_torch.ops.buckets import build_bucket_set, make_bucketed_bracket_fn
from hpbandster_tpu_torch.optimizers import BOHB
from hpbandster_tpu_torch.parallel import VmapBackend
from hpbandster_tpu_torch.serve import ContinuousRunner, LaneAllocator, PackEntry, ServePool
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_harness import ref  # noqa: F401

LOSS_ATOL = LOSS_RTOL = 1e-4
JOIN_S = 120
PLAN = BracketPlan((9, 3, 1), (1.0, 3.0, 9.0))


@pytest.fixture(scope="module")
def rc(ref):  # noqa: F811
    """The reference's ``serve.continuous`` and ``ops.buckets``, inside the
    ``ref`` window."""
    import importlib
    from types import SimpleNamespace

    return SimpleNamespace(
        continuous=importlib.import_module("hpbandster_tpu.serve.continuous"),
        buckets=importlib.import_module("hpbandster_tpu.ops.buckets"))


def _bucket():
    return build_bucket_set([PLAN]).buckets[0]


def _vectors(seed, n=9, d=2):
    return np.random.default_rng(seed).uniform(0.0, 1.0, size=(n, d)).astype(np.float32)


def _crash_corner(v, budget):
    return branin(v, budget).masked_fill(v[:, 0] > 0.5, float("nan"))


def _all_crash(v, budget):
    return branin(v, budget) * float("nan")


# --------------------------------------------------------------- allocator
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lane_allocator_equals_reference(rc, seed):
    """A seeded churn sequence (chunks boarding subsets of tenants, a
    tenant boarding twice in one chunk, releases): the same placements,
    owners, dirty lanes and occupancy after every step."""
    rng = np.random.default_rng(seed)
    mine, theirs = LaneAllocator(4), rc.continuous.LaneAllocator(4)
    tenants = [f"t{i}" for i in range(7)]
    for step in range(80):
        if rng.random() < 0.25:
            gone = tenants[int(rng.integers(len(tenants)))]
            assert mine.release_tenant(gone) == theirs.release_tenant(gone)
        else:
            k = int(rng.integers(1, 5))
            boarding = [tenants[int(i)] for i in rng.integers(0, len(tenants), size=k)]
            assert mine.assign(boarding) == theirs.assign(boarding)
            if rng.random() < 0.7:  # a chunk resets every dirty lane
                mine.dirty.clear()
                theirs.dirty.clear()
        assert mine.owners == theirs.owners
        assert mine.dirty == theirs.dirty
        assert mine.occupied() == theirs.occupied()
    with pytest.raises(ValueError):
        mine.assign(tenants[:5])


def test_lane_allocator_policy():
    """Sticky lanes, LRU steals that mark the lane dirty, and a steal that
    never evicts a boarding tenant's warm lane."""
    a = LaneAllocator(2)
    assert a.assign(["B", "C"]) == [(0, False), (1, False)]
    a.assign(["C"])  # B's lane is now the least recently used
    a.dirty.clear()
    placements = dict(zip(["A", "B"], a.assign(["A", "B"])))
    assert placements == {"B": (0, True), "A": (1, False)}
    assert a.dirty == {1}
    assert a.release_tenant("A") == [1] and a.owners == ["B", None]


# ------------------------------------------------------------- the carry
def _chunks():
    """A seeded sequence of (entries, release-after) chunks over 3 lanes:
    tenants board and leave, one tenant's brackets crash in a corner and
    one tenant only ever crashes."""
    rng = np.random.default_rng(9)
    out = []
    for step in range(6):
        boarding = sorted({f"t{int(i)}" for i in rng.integers(0, 4, size=3)})
        entries = [PackEntry(t, _vectors(int(rng.integers(1 << 30))), PLAN, 0) for t in boarding]
        out.append((entries, f"t{int(rng.integers(0, 4))}" if step % 2 else None))
    return out


@pytest.mark.parametrize("objective", ["crash_corner", "all_crash"])
def test_carry_equals_reference(ref, rc, objective):  # noqa: F811
    """The same chunk sequence through the port's runner and the
    reference's: every member's stages (survivors exactly, losses within
    1e-4) and, after every chunk, the decoded lane incumbents (None for an
    empty lane, NaN for a crash-only one)."""
    import jax.numpy as jnp

    port_fn = {"crash_corner": _crash_corner, "all_crash": _all_crash}[objective]

    def ref_fn(vec, budget):
        loss = ref.toys.branin_from_vector(vec, budget)
        if objective == "all_crash":
            return loss * jnp.nan
        return jnp.where(vec[0] > 0.5, jnp.nan, loss)

    bucket = _bucket()
    rbucket = rc.buckets.BucketPlan(bucket.widths, bucket.budgets)
    rplan = ref.bracket.BracketPlan(PLAN.num_configs, PLAN.budgets)
    mine = ContinuousRunner(port_fn, bucket, lane_count=3, device="cpu")
    theirs = rc.continuous.ContinuousRunner(ref_fn, rbucket, lane_count=3)
    assert mine.lane_incumbents() == [None] * 3
    for entries, leaver in _chunks():
        got = mine.run_chunk(entries, d=2)
        want = theirs.run_chunk([rc.continuous.PackEntry(e.tenant, e.vectors, rplan, e.entry)
                                 for e in entries], d=2)
        for g_member, w_member in zip(got, want):
            for (gi, gl), (wi, wl) in zip(g_member, w_member):
                np.testing.assert_array_equal(gi, np.asarray(wi))
                np.testing.assert_allclose(gl, np.asarray(wl), atol=LOSS_ATOL, rtol=LOSS_RTOL)
        inc, inc_ref = mine.lane_incumbents(), theirs.lane_incumbents()
        assert [v is None for v in inc] == [v is None for v in inc_ref]
        assert [v is not None and np.isnan(v) for v in inc] == \
            [v is not None and np.isnan(v) for v in inc_ref]
        np.testing.assert_allclose([v for v in inc if v is not None],
                                   [v for v in inc_ref if v is not None],
                                   atol=LOSS_ATOL, rtol=LOSS_RTOL)
        assert mine.lanes.owners == theirs.lanes.owners
        if leaver is not None:
            mine.release_tenant(leaver)
            theirs.release_tenant(leaver)
    if objective == "all_crash":
        assert any(v is not None and np.isnan(v) for v in mine.lane_incumbents())


def test_churn_equals_solo_and_builds_once():
    """Across a seeded join/leave schedule every member's stages equal its
    solo dispatch bit for bit, and the family's program is built once."""
    bucket = _bucket()
    solo = make_bucketed_bracket_fn(branin, bucket, device="cpu")
    runner = ContinuousRunner(branin, bucket, lane_count=3, device="cpu")
    builds = []
    make = runner.program._make_buffers
    runner.program._make_buffers = lambda d: builds.append(d) or make(d)
    rng = np.random.default_rng(42)
    tenants = [f"t{i}" for i in range(6)]
    for _ in range(8):
        boarding = [t for t in tenants if rng.random() < 0.5][: runner.lane_count]
        entries = [PackEntry(t, _vectors(int(rng.integers(1 << 30))), PLAN, 0)
                   for t in boarding]
        if entries:
            for e, got in zip(entries, runner.run_chunk(entries, d=2)):
                for (si, sl), (gi, gl) in zip(solo.run_member(e.vectors, PLAN, 0), got):
                    np.testing.assert_array_equal(si, gi)
                    np.testing.assert_array_equal(sl, gl)
        if rng.random() < 0.5:
            runner.release_tenant(tenants[int(rng.integers(len(tenants)))])
    assert builds == [2] and runner.chunks_run >= 1
    assert runner.snapshot()["warm_age_s"] is not None


def test_incumbent_never_leaks_across_owners():
    """A tenant's lane keeps its incumbent across chunks (warm), and a
    newcomer landing on a departed tenant's lane starts from nothing."""
    bucket = _bucket()
    runner = ContinuousRunner(branin, bucket, lane_count=2, device="cpu")
    solo = make_bucketed_bracket_fn(branin, bucket, device="cpu")
    va, vb = _vectors(1), _vectors(2)
    best = {k: float(np.nanmin(solo.run_member(v, PLAN, 0)[-1][1]))
            for k, v in (("a", va), ("b", vb))}
    runner.run_chunk([PackEntry("a", va, PLAN, 0), PackEntry("b", vb, PLAN, 0)], d=2)
    assert runner.lane_incumbents() == [best["a"], best["b"]]
    runner.run_chunk([PackEntry("a", vb, PLAN, 0)], d=2)
    assert runner.lane_incumbents()[0] == min(best["a"], best["b"])
    runner.release_tenant("b")
    runner.run_chunk([PackEntry("c", va, PLAN, 0)], d=2)
    inc = runner.lane_incumbents()
    assert runner.lanes.owners == ["a", "c"]
    assert inc[1] == best["a"]  # c's own bracket, not b's incumbent


# ------------------------------------------------------------------ pool
def _tenant(pool, tenant, seed, results, barrier=None):
    opt = BOHB(configspace=branin_space(seed=seed), run_id=f"cont-{tenant}", tenant_id=tenant,
               executor=pool.executor_for(tenant), min_budget=1, max_budget=9, eta=3,
               seed=seed, device="cpu")
    if barrier is not None:
        barrier.wait(timeout=JOIN_S)
    results[tenant] = opt.run(n_iterations=2)
    opt.shutdown()


def _losses_by_config(result):
    return {(tuple(r.config_id), r.budget): r.loss for r in result.get_all_runs()}


def test_churning_pool_tenants_equal_their_solo_runs():
    """Three tenants through a continuous pool with two lanes (rounds of
    several chunks, lanes changing owners): each tenant's sweep equals its
    solo run through a one-shot pool; afterwards every lane is free, and
    each family built one program."""
    pool = ServePool(VmapBackend(branin, device="cpu"), branin_space(seed=0),
                     continuous=True, lane_count=2, pack_window_s=0.2)
    results, barrier = {}, threading.Barrier(3)
    threads = [threading.Thread(target=_tenant, args=(pool, f"t{i}", 20 + i, results, barrier),
                                daemon=True) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), "a tenant thread did not finish"
    assert sorted(results) == ["t0", "t1", "t2"]
    for i in range(3):
        solo = {}
        _tenant(ServePool(VmapBackend(branin, device="cpu"), branin_space(seed=0),
                          pack_window_s=0.0), "solo", 20 + i, solo)
        assert _losses_by_config(results[f"t{i}"]) == _losses_by_config(solo["solo"])
    snap = pool.snapshot()
    assert snap["dispatches"]["continuous_brackets"] == 6
    assert snap["dispatches"]["continuous_chunks"] >= 3
    for lane_snap in snap["lanes"]:
        assert lane_snap["occupied"] == 0 and lane_snap["chunks"] >= 1
    assert all(r.program.built for r in pool._continuous_runners.values())
    assert len(pool._continuous_runners) == snap["buckets"]
