"""The port's serving tier (``hpbandster_tpu_torch/serve``) against the
reference's (``hpbandster_tpu/serve``), on the CPU.

The scheduler and the admission controller are host code and make the
reference's decisions exactly. ``pack_members`` and ``demux`` equal the
reference's. Inside the port a packed dispatch equals a solo dispatch of
each member bit for bit, and a tenant's whole sweep is the same whether it
runs alone or packed with others. A pool of ``HyperBand`` tenants (numpy
sampling: the reference's draws exactly) equals the reference's
``ServePool`` run per tenant and per ``(config_id, budget)``, losses within
``atol 1e-4, rtol 1e-4`` (XLA contracts Branin's polynomial differently
from eager PyTorch, ROADMAP C.15).

Tenants start behind a barrier, and every thread join has a timeout that is
asserted.
"""

import threading

import numpy as np
import pytest

from hpbandster_tpu_torch.ops.bracket import BracketPlan
from hpbandster_tpu_torch.ops.buckets import build_bucket_set, make_bucketed_bracket_fn
from hpbandster_tpu_torch.optimizers import BOHB, HyperBand
from hpbandster_tpu_torch.parallel import VmapBackend
from hpbandster_tpu_torch.serve import (
    AdmissionController,
    DeficitFairScheduler,
    PackEntry,
    ServePool,
    TenantQuota,
    demux,
    make_mega_runner,
    pack_members,
    work_cost,
)
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_harness import ref  # noqa: F401

LOSS_ATOL = LOSS_RTOL = 1e-4
JOIN_S = 120


@pytest.fixture(scope="module")
def rs(ref):  # noqa: F811
    """The reference's ``serve`` package and ``optimizers``, inside the
    ``ref`` window."""
    import importlib
    from types import SimpleNamespace

    return SimpleNamespace(
        serve=importlib.import_module("hpbandster_tpu.serve"),
        optimizers=importlib.import_module("hpbandster_tpu.optimizers"),
        parallel=importlib.import_module("hpbandster_tpu.parallel"))


class _Item:
    def __init__(self, i, cost):
        self.i = i
        self.cost = float(cost)


# --------------------------------------------------------------- scheduler
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_makes_the_reference_decisions(rs, seed):
    """Seeded item streams (tenants arriving and leaving, mixed costs,
    weights, capped and uncapped rounds, an oversized item): every round
    selects the reference's items, and the served costs and the deficit
    order agree."""
    rng = np.random.default_rng(seed)
    mine, theirs = DeficitFairScheduler(quantum=8.0), rs.serve.DeficitFairScheduler(quantum=8.0)
    tenants = [f"t{i}" for i in range(5)]
    weights = {t: float(rng.choice([0.5, 1.0, 2.0, 3.0])) for t in tenants}
    queues = {t: [] for t in tenants}
    next_id = 0
    for rnd in range(60):
        for t in tenants:
            for _ in range(int(rng.integers(0, 3))):
                cost = float(rng.choice([1, 3, 9, 27, 200]))
                queues[t].append(_Item(next_id, cost))
                next_id += 1
        capacity = None if rnd % 4 == 0 else float(rng.choice([10, 30, 100]))
        view = {t: list(q) for t, q in queues.items()}
        got = mine.select(view, capacity=capacity, weights=weights)
        want = theirs.select(view, capacity=capacity, weights=weights)
        assert [(t, it.i) for t, it in got] == [(t, it.i) for t, it in want]
        for t, it in got:
            queues[t].remove(it)
        if rnd % 13 == 12:
            gone = tenants[int(rng.integers(len(tenants)))]
            mine.forget(gone)
            theirs.forget(gone)
        assert mine.deficit_order(tenants) == theirs.deficit_order(tenants)
    assert mine.served_cost == theirs.served_cost
    assert mine.fair_share(tenants, weights) == theirs.fair_share(tenants, weights)
    assert work_cost((9, 3, 1), (1, 3, 9)) == rs.serve.work_cost((9, 3, 1), (1, 3, 9)) == 27.0


def test_admission_makes_the_reference_decisions(rs):
    """Seeded admission questions against per-tenant and pool-wide caps:
    the same verdicts and the same machine-readable reasons."""
    rng = np.random.default_rng(4)
    mine = AdmissionController(TenantQuota(max_active_sweeps=3, max_inflight_cost=500.0),
                               max_total_sweeps=6)
    theirs = rs.serve.AdmissionController(
        rs.serve.TenantQuota(max_active_sweeps=3, max_inflight_cost=500.0), max_total_sweeps=6)
    mine.set_quota("gold", TenantQuota(max_active_sweeps=5, weight=2.0))
    theirs.set_quota("gold", rs.serve.TenantQuota(max_active_sweeps=5, weight=2.0))
    for _ in range(300):
        tenant = str(rng.choice(["gold", "t1", "t2"]))
        active, total = int(rng.integers(0, 7)), int(rng.integers(0, 9))
        a, b = mine.admit_sweep(tenant, active, total), theirs.admit_sweep(tenant, active, total)
        assert (bool(a), a.reason) == (bool(b), b.reason)
        inflight, cost = float(rng.uniform(0, 600)), float(rng.uniform(0, 300))
        a, b = mine.admit_work(tenant, inflight, cost), theirs.admit_work(tenant, inflight, cost)
        assert (bool(a), a.reason) == (bool(b), b.reason)
    assert mine.quota("gold").to_dict() == theirs.quota("gold").to_dict()
    with pytest.raises(ValueError):
        TenantQuota(weight=0.0)


# ------------------------------------------------------------- megabatch
def _members(d=2):
    """Three member brackets over two buckets, seeded."""
    plans = [BracketPlan((9, 3, 1), (1.0, 3.0, 9.0)), BracketPlan((5, 1), (3.0, 9.0)),
             BracketPlan((6, 2, 1), (1.0, 3.0, 9.0))]
    bucket_set = build_bucket_set(plans)
    rng = np.random.default_rng(7)
    out = []
    for plan in plans:
        bi, entry = bucket_set.lookup(plan.num_configs, plan.budgets)
        vectors = rng.uniform(0.0, 1.0, size=(plan.num_configs[0], d)).astype(np.float32)
        out.append((bucket_set.buckets[bi], plan, entry, vectors))
    return bucket_set, out


def test_pack_members_and_demux_equal_reference(ref, rs):  # noqa: F811
    """``pack_members`` gives the reference's lane arrays (padding lanes
    all-zero counts; too many members raise), and ``demux`` cuts a packed
    result into the reference's per-member stages."""
    bucket_set, members = _members()
    from hpbandster_tpu.ops.buckets import BucketPlan as RBucketPlan

    bucket = members[0][0]
    rbucket = RBucketPlan(bucket.widths, bucket.budgets)
    entries = [PackEntry(f"t{i}", v, plan, entry)
               for i, (b, plan, entry, v) in enumerate(members) if b == bucket]
    rentries = [rs.serve.PackEntry(e.tenant, e.vectors,
                                   ref.bracket.BracketPlan(e.plan.num_configs, e.plan.budgets),
                                   e.entry) for e in entries]
    v, c = pack_members(entries, bucket, pack_width=4, d=2)
    rv, rc = rs.serve.pack_members(rentries, rbucket, pack_width=4, d=2)
    np.testing.assert_array_equal(v, rv)
    np.testing.assert_array_equal(c, rc)
    assert c[len(entries):].sum() == 0
    with pytest.raises(ValueError):
        pack_members(entries * 3, bucket, pack_width=4, d=2)

    total = sum(bucket.widths)
    rng = np.random.default_rng(2)
    idx = np.stack([rng.permutation(total) for _ in range(4)]).astype(np.int32)
    loss = rng.normal(size=(4, total)).astype(np.float32)
    loss[0, 3] = np.nan
    flat = np.concatenate([idx.astype(np.float32), loss], axis=1)
    runner = rs.serve.make_mega_runner(lambda x, b: x[0], rbucket, pack_width=4)
    want = runner.demux((idx, loss), rentries)
    got = demux(flat, bucket, entries)
    for g_member, w_member in zip(got, want):
        for (gi, gl), (wi, wl) in zip(g_member, w_member):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


def _crashy(v, budget):
    return branin(v, budget).masked_fill(v[:, 0] > 0.7, float("nan"))


@pytest.mark.parametrize("objective", [branin, _crashy])
def test_packed_equals_solo_bitwise(objective):
    """Per member, a packed dispatch's ``(indices, losses)`` equal a solo
    dispatch's exactly, crashes included; a packed runner is built once per
    ``(bucket, pack_width)`` however often it dispatches."""
    bucket_set, members = _members()
    by_bucket = {}
    for bucket, plan, entry, vectors in members:
        by_bucket.setdefault(bucket, []).append(PackEntry("t", vectors, plan, entry))
    for bucket, entries in by_bucket.items():
        runner = make_mega_runner(objective, bucket, pack_width=4, device="cpu")
        assert make_mega_runner(objective, bucket, pack_width=4, device="cpu") is runner
        packed_out = runner.run_packed(entries, d=2)
        runner.run_packed(entries[:1], d=2)
        solo = make_bucketed_bracket_fn(objective, bucket, device="cpu")
        for e, packed_stages in zip(entries, packed_out):
            solo_stages = solo.run_member(e.vectors, e.plan, e.entry)
            assert len(solo_stages) == len(packed_stages) == len(e.plan.num_configs)
            for (si, sl), (pi, pl) in zip(solo_stages, packed_stages):
                np.testing.assert_array_equal(si, pi)
                np.testing.assert_array_equal(sl, pl)


# ----------------------------------------------------------------- the pool
def _bohb_tenant(pool, tenant, seed, n_iterations, results, barrier=None):
    opt = BOHB(configspace=branin_space(seed=seed), run_id=f"serve-{tenant}", tenant_id=tenant,
               executor=pool.executor_for(tenant), min_budget=1, max_budget=9, eta=3,
               seed=seed, device="cpu")
    if barrier is not None:
        barrier.wait(timeout=JOIN_S)
    results[tenant] = opt.run(n_iterations=n_iterations)
    opt.shutdown()
    assert all(j.tenant_id == tenant for j in opt.jobs)


def _run_threads(target, args_list):
    threads = [threading.Thread(target=target, args=args, daemon=True) for args in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), "a tenant thread did not finish"


def _losses_by_config(result):
    return {(tuple(r.config_id), r.budget): r.loss for r in result.get_all_runs()}


def _pool(**kw):
    return ServePool(VmapBackend(branin, device="cpu"), branin_space(seed=0), **kw)


def test_serve_smoke():
    """Two tenants, one bracket each, through the megabatch machinery:
    13 finite runs each (9 + 3 + 1), released afterwards."""
    pool = _pool(pack_window_s=0.05)
    results = {}
    _run_threads(_bohb_tenant, [(pool, t, s, 1, results) for t, s in (("a", 1), ("b", 2))])
    assert sorted(results) == ["a", "b"]
    for res in results.values():
        runs = res.get_all_runs()
        assert len(runs) == 13 and all(r.loss is not None for r in runs)
    snap = pool.snapshot()
    assert snap["tenants"] == [] and snap["buckets"] == 1
    assert snap["served_cost"] == {"a": 27.0, "b": 27.0}


def test_packed_tenant_equals_itself_alone():
    """A tenant's whole sweep (loss per config per budget) is the same
    alone and packed with two others; packing engaged (the tenants start
    behind a barrier, inside a generous packing window)."""
    solo = {}
    _bohb_tenant(_pool(pack_window_s=0.0), "A", 42, 2, solo)
    pool = _pool(pack_window_s=0.5)
    results, barrier = {}, threading.Barrier(3)
    _run_threads(_bohb_tenant, [(pool, t, s, 2, results, barrier)
                                for t, s in (("A", 42), ("B", 43), ("C", 44))])
    assert _losses_by_config(results["A"]) == _losses_by_config(solo["A"])
    assert pool.dispatches["packed_brackets"] >= 2, pool.dispatches
    served = pool.scheduler.served_cost
    assert len(set(served.values())) == 1, served


def test_hyperband_pool_equals_reference_pool(ref, rs, monkeypatch):  # noqa: F811
    """``HyperBand`` tenants (numpy sampling, draw for draw the
    reference's) in the port's ``ServePool`` and the reference's: per
    tenant the same runs, configurations and crash pattern, losses within
    1e-4."""
    monkeypatch.setenv("HPB_XLA_CACHE", "0")

    def port_tenant(pool, tenant, seed, results):
        opt = HyperBand(configspace=branin_space(seed=seed), run_id=f"hb-{tenant}",
                        tenant_id=tenant, executor=pool.executor_for(tenant),
                        min_budget=1, max_budget=27, eta=3, seed=seed)
        results[tenant] = opt.run(n_iterations=4)
        opt.shutdown()

    def ref_tenant(pool, tenant, seed, results):
        opt = rs.optimizers.HyperBand(
            configspace=ref.toys.branin_space(seed=seed), run_id=f"hb-{tenant}",
            tenant_id=tenant, executor=pool.executor_for(tenant), min_budget=1,
            max_budget=27, eta=3, seed=seed)
        results[tenant] = opt.run(n_iterations=4)
        opt.shutdown()

    tenants = [("t0", 5), ("t1", 6)]
    mine, theirs = {}, {}
    pool = _pool(pack_window_s=0.05)
    _run_threads(port_tenant, [(pool, t, s, mine) for t, s in tenants])
    rpool = rs.serve.ServePool(rs.parallel.VmapBackend(ref.toys.branin_from_vector),
                               ref.toys.branin_space(seed=0), pack_window_s=0.05)
    _run_threads(ref_tenant, [(rpool, t, s, theirs) for t, s in tenants])
    assert pool.snapshot()["buckets"] == rpool.snapshot()["buckets"] == 2
    for t, _ in tenants:
        got, want = _losses_by_config(mine[t]), _losses_by_config(theirs[t])
        assert sorted(got) == sorted(want)
        keys = sorted(want)
        assert [got[k] is None for k in keys] == [want[k] is None for k in keys]
        np.testing.assert_allclose([got[k] for k in keys], [want[k] for k in keys],
                                   atol=LOSS_ATOL, rtol=LOSS_RTOL)
        id2c, id2c_ref = mine[t].get_id2config_mapping(), theirs[t].get_id2config_mapping()
        assert {c: v["config"] for c, v in id2c.items()} == \
            {c: v["config"] for c, v in id2c_ref.items()}


def test_release_prunes_scheduler_and_weights():
    """A fully released tenant's weight and round state go; its served
    cost stays (the cumulative census)."""
    pool = _pool(pack_window_s=0.0)
    for i in range(4):
        tenant = f"churn{i}"
        ex = pool.executor_for(tenant, weight=2.0)
        pool.scheduler.select({tenant: [_Item(0, 1)]}, capacity=4)
        assert tenant in pool._weights and tenant in pool.scheduler._deficit
        ex.shutdown()
        assert tenant not in pool._weights
        assert tenant not in pool.scheduler._deficit
        assert tenant in pool.scheduler.served_cost
    assert pool.tenants() == []


def test_bracket_failures_raise_on_a_card_and_crash_on_the_cpu(monkeypatch):
    """A bracket item whose dispatch fails crashes its wave on the CPU, as
    in the reference, and raises from its tenant's flush where the pool
    runs on a card; a stage batch's failure crashes its wave on both."""
    from hpbandster_tpu_torch.serve import pool as pool_mod

    def refuse(*args, **kwargs):
        raise RuntimeError("no bucket program today")

    monkeypatch.setattr(pool_mod, "make_bucketed_bracket_fn", refuse)
    pool = _pool(pack_window_s=0.0)
    res = {}
    _bohb_tenant(pool, "a", 1, 1, res)
    runs = res["a"].get_all_runs()
    crashed = [r for r in runs if r.budget == 1.0]
    assert len(runs) == 13 and len(crashed) == 9
    assert all(r.loss is None and "no bucket program" in r.error_logs for r in crashed)
    # the crashed wave still promotes; its later stages stage-batch
    assert all(r.loss is not None for r in runs if r.budget > 1.0)

    pool = _pool(pack_window_s=0.0)
    monkeypatch.setattr(pool, "_strict", lambda: True)
    with pytest.raises(RuntimeError, match="no bucket program"):
        _bohb_tenant(pool, "a", 1, 1, {})


# -------------------------------------------------------------- pack window
def _windows():
    """(closed early, ran to the deadline): the pool's pack-window counters."""
    from hpbandster_tpu_torch import obs

    m = obs.get_metrics()
    return (m.counter("serve.pack_window.closed_early").value,
            m.counter("serve.pack_window.full").value)


def test_lone_tenant_windows_close_at_once():
    """A lone tenant's sweep through a pool with a long pack window: every
    window closes early (no one else can join), and the sweep is, run for
    run, the one a pool without a window gives."""
    solo = {}
    _bohb_tenant(_pool(pack_window_s=0.0), "A", 42, 3, solo)
    early0, full0 = _windows()
    windowed = {}
    _bohb_tenant(_pool(pack_window_s=0.5), "A", 42, 3, windowed)
    early1, full1 = _windows()
    assert full1 - full0 == 0
    assert early1 - early0 >= 3  # at least one window a bracket
    assert _losses_by_config(windowed["A"]) == _losses_by_config(solo["A"])


def test_barrier_tenants_still_pack_and_close_early():
    """Three tenants behind a barrier, inside a long window: their brackets
    still pack, and a window closes once all three are waiting."""
    pool = _pool(pack_window_s=0.5)
    early0, _ = _windows()
    results, barrier = {}, threading.Barrier(3)
    _run_threads(_bohb_tenant, [(pool, t, s, 2, results, barrier)
                                for t, s in (("A", 42), ("B", 43), ("C", 44))])
    assert pool.dispatches["packed_brackets"] >= 2, pool.dispatches
    assert _windows()[0] - early0 >= 1


def test_idle_live_facade_holds_the_window_open():
    """A second tenant's facade that is live but never flushes could still
    join: the leader waits its window out, once for the one bracket."""
    pool = _pool(pack_window_s=0.5)
    idle = pool.executor_for("idle")
    early0, full0 = _windows()
    _bohb_tenant(pool, "a", 1, 1, {})
    early1, full1 = _windows()
    assert (early1 - early0, full1 - full0) == (0, 1)
    idle.shutdown()
    assert pool.tenants() == []


@pytest.mark.parametrize("second", ["u", "t"])
def test_shutting_a_facade_down_twice_keeps_the_live_set(second):
    """A facade leaves the live set once, however often it is shut down,
    and releasing its tenant once more, as a caller that shuts its
    optimizer down and then releases may, changes nothing for the others:
    a second facade, of another tenant or of the same one, stays live and
    keeps its tenant listed and weighted until its own shutdown."""
    pool = _pool(pack_window_s=0.0)
    a, b = pool.executor_for("t"), pool.executor_for(second)
    a.shutdown()
    a.shutdown()
    pool.release_tenant("t")
    assert set(pool._live) == {b}
    assert pool.tenants() == pool.snapshot()["tenants"] == [second]
    assert second in pool._weights
    b.shutdown()
    b.shutdown()
    assert len(pool._live) == 0
    assert pool.tenants() == [] and pool._weights == {}


def test_pack_window_counters_export_flat():
    """The two pack-window counters render as flat counter families, as
    ``serve.rounds`` does."""
    from hpbandster_tpu_torch import obs
    from hpbandster_tpu_torch.obs.export import parse_prometheus_text, render_registry

    reg = obs.MetricsRegistry()
    reg.counter("serve.rounds").inc(3)
    reg.counter("serve.pack_window.closed_early").inc(2)
    reg.counter("serve.pack_window.full").inc()
    families = parse_prometheus_text(render_registry(reg))
    for name, value in (("serve_rounds", 3), ("serve_pack_window_closed_early", 2),
                        ("serve_pack_window_full", 1)):
        family = f"hpbandster_{name}_total"
        assert families[family]["type"] == "counter"
        assert [v for _, v in families[family]["samples"]] == [value]


def test_many_tenants_under_contention():
    """Ten tenant threads, more than this host's cores, with a short switch
    interval: every sweep finishes and equals its run alone, and the pool
    ends with no live facade and no tenant."""
    import sys

    tenants = [(f"t{i}", 60 + i) for i in range(10)]
    solo = {}
    for t, s in tenants:
        _bohb_tenant(_pool(pack_window_s=0.0), t, s, 2, solo)
    pool = _pool(pack_window_s=0.05)
    results, barrier = {}, threading.Barrier(len(tenants))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _run_threads(_bohb_tenant, [(pool, t, s, 2, results, barrier) for t, s in tenants])
    finally:
        sys.setswitchinterval(interval)
    for t, _ in tenants:
        assert _losses_by_config(results[t]) == _losses_by_config(solo[t]), t
    assert len(pool._live) == 0 and pool.tenants() == []
