"""The serving tier's meshes on the CPU: the pool's meshed backend, the lane
meshes of the megabatched and continuous runners and of ``ServePool``, and
their per-lane device telemetry, against the reference
(``hpbandster_tpu/serve``) and against the unmeshed port.

Meshes repeat the ``cpu`` device; the reference's run on its eight virtual
CPU devices. Inside the port a meshed runner equals its unmeshed twin bit
for bit (lanes and rows only move between shards). Against the reference
two objectives are used: Branin (XLA and eager PyTorch differ by up to
1e-4, ROADMAP C.15: losses within ``atol 1e-4, rtol 1e-4``) and a linear
objective with a crash corner, ``loss = v0 * budget`` (one rounding in
both frameworks), for which the stages and the decoded ``device_telemetry``
records equal the reference's exactly. Tenants start behind a barrier, and
every thread join has an asserted timeout.
"""

import threading

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch.obs import events as E
from hpbandster_tpu_torch.ops.bracket import BracketPlan
from hpbandster_tpu_torch.ops.buckets import build_bucket_set, make_bucketed_bracket_fn
from hpbandster_tpu_torch.optimizers import BOHB, HyperBand
from hpbandster_tpu_torch.parallel import VmapBackend
from hpbandster_tpu_torch.parallel.mesh import Mesh, config_mesh
from hpbandster_tpu_torch.serve import (
    ContinuousRunner,
    MegaRunner,
    PackEntry,
    ServePool,
    make_lane_mesh,
    make_mega_runner,
)
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_harness import TIMING_FIELDS, ref  # noqa: F401

LOSS_ATOL = LOSS_RTOL = 1e-4
JOIN_S = 120
PLAN = BracketPlan((9, 3, 1), (1.0, 3.0, 9.0))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def rs(ref):  # noqa: F811
    """The reference's serving tier, buckets, optimizers, backends and
    mesh helpers and jax's eight CPU devices, inside the ``ref`` window."""
    import importlib
    from types import SimpleNamespace

    import jax

    mods = {k: importlib.import_module(f"hpbandster_tpu.{m}") for k, m in (
        ("serve", "serve"), ("continuous", "serve.continuous"), ("buckets", "ops.buckets"),
        ("optimizers", "optimizers"), ("parallel", "parallel"), ("mesh", "parallel.mesh"),
        ("events", "obs.events"))}
    return SimpleNamespace(devices=jax.devices(), **mods)


def _linear(v, budget):
    """``v0 * budget``, NaN where ``v1 > 0.8``: exact in both frameworks."""
    return (v[:, 0] * budget).masked_fill(v[:, 1] > 0.8, float("nan"))


def _ref_linear(vec, budget):
    import jax.numpy as jnp

    return jnp.where(vec[1] > 0.8, jnp.nan, vec[0] * budget)


def _counted(fn, sizes):
    """``fn`` that records each call's row count."""
    def objective(v, budget):
        sizes.append(int(v.shape[0]))
        return fn(v, budget)

    return objective


def _vectors(seed, n=9, d=2):
    return np.random.default_rng(seed).uniform(0.0, 1.0, size=(n, d)).astype(np.float32)


def _same_stages(got, want, exact=True):
    assert len(got) == len(want)
    for g_member, w_member in zip(got, want):
        assert len(g_member) == len(w_member)
        for (gi, gl), (wi, wl) in zip(g_member, w_member):
            np.testing.assert_array_equal(gi, np.asarray(wi))
            if exact:
                np.testing.assert_array_equal(gl, np.asarray(wl))
            else:
                np.testing.assert_allclose(gl, np.asarray(wl), atol=LOSS_ATOL, rtol=LOSS_RTOL)


def _telemetry(bus, run):
    """``run()``'s result and the ``device_telemetry`` records it emitted on
    ``bus`` (timing fields dropped)."""
    recs = []
    detach = bus.subscribe(lambda ev: recs.append(
        {k: v for k, v in ev.fields.items() if k not in TIMING_FIELDS})
        if ev.name == "device_telemetry" else None)
    try:
        out = run()
    finally:
        detach()
    return out, recs


def _ref_entries(rs, ref, entries):  # noqa: F811
    return [rs.serve.PackEntry(e.tenant, e.vectors,
                               ref.bracket.BracketPlan(e.plan.num_configs, e.plan.budgets),
                               e.entry) for e in entries]


# ------------------------------------------------------------ the lane mesh
def test_make_lane_mesh_shapes_and_refusals(rs):
    """A ``lane x config`` grid over the devices, the reference's shape;
    ``lane_shards`` must divide the devices; no devices means every card
    (none here: it raises, never falls back to the CPU)."""
    mesh = make_lane_mesh(2, [CPU] * 8)
    assert mesh.shape == dict(rs.continuous.make_lane_mesh(2).shape) == {"lane": 2, "config": 4}
    assert mesh.axis_names == ("lane", "config")
    assert make_lane_mesh(1, [CPU] * 3).shape == {"lane": 1, "config": 3}
    for bad in (3, 0):
        with pytest.raises(ValueError, match="divide"):
            make_lane_mesh(bad, [CPU] * 8)
    with pytest.raises(ValueError):
        rs.continuous.make_lane_mesh(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_lane_mesh(1)


def test_geometry_errors_equal_reference(rs):
    """``lane_count`` a multiple of the lane axis and the widths multiples
    of the config axis, or the reference's ``ValueError``; ``pack_width`` a
    multiple of the packed runner's axis; a lane mesh over a process group
    is refused (the port's lane meshes lie in one process)."""
    mesh, rmesh = make_lane_mesh(2, [CPU] * 8), rs.continuous.make_lane_mesh(2)
    padded = build_bucket_set([PLAN], mesh_size=4).buckets[0]
    rpadded = rs.buckets.build_bucket_set([PLAN], mesh_size=4).buckets[0]
    assert padded.widths == tuple(rpadded.widths)
    for runner in (lambda: ContinuousRunner(_linear, padded, lane_count=3, mesh=mesh),
                   lambda: rs.continuous.ContinuousRunner(_ref_linear, rpadded, lane_count=3,
                                                          mesh=rmesh)):
        with pytest.raises(ValueError, match="multiple"):
            runner()
    six, rsix = make_lane_mesh(2, [CPU] * 6), rs.continuous.make_lane_mesh(2, rs.devices[:6])
    plain = build_bucket_set([PLAN]).buckets[0]
    for runner in (lambda: ContinuousRunner(_linear, plain, lane_count=4, mesh=six),
                   lambda: rs.continuous.ContinuousRunner(
                       _ref_linear, rs.buckets.build_bucket_set([PLAN]).buckets[0],
                       lane_count=4, mesh=rsix)):
        with pytest.raises(ValueError, match="mesh_size"):
            runner()
    with pytest.raises(ValueError, match="one process"):
        ContinuousRunner(_linear, padded, lane_count=4, mesh=Mesh(
            np.array([[CPU] * 4] * 2, dtype=object), ("lane", "config"),
            ranks=[[0] * 4, [1] * 4], process_group=object()))
    with pytest.raises(ValueError, match="multiple"):
        MegaRunner(_linear, plain, pack_width=3, mesh=config_mesh([CPU] * 2))
    with pytest.raises(ValueError, match="multiple"):
        rs.serve.MegaRunner(_ref_linear, rs.buckets.build_bucket_set([PLAN]).buckets[0],
                            pack_width=3, mesh=rs.mesh.config_mesh(rs.devices[:2]))


def _churn():
    """A seeded chunk sequence over 4 lanes: tenants board and leave."""
    rng = np.random.default_rng(19)
    out = []
    for step in range(5):
        boarding = sorted({f"t{int(i)}" for i in rng.integers(0, 5, size=4)})
        entries = [PackEntry(t, _vectors(int(rng.integers(1 << 30))), PLAN, 0)
                   for t in boarding]
        out.append((entries, f"t{int(rng.integers(0, 5))}" if step % 2 else None))
    return out


def test_continuous_lane_mesh_equals_unmeshed_bitwise():
    """On a ``lane 2 x config 2`` mesh the resident lane program equals the
    unmeshed one bit for bit across churn (every member's stages and the
    lane incumbents), and each stage's rows really split: the objective
    sees a quarter of a chunk's rows per call."""
    bucket = build_bucket_set([PLAN], mesh_size=2).buckets[0]
    sizes = []
    meshed = ContinuousRunner(_counted(_linear, sizes), bucket, lane_count=4,
                              mesh=make_lane_mesh(2, [CPU] * 4))
    plain = ContinuousRunner(_linear, bucket, lane_count=4, device="cpu")
    assert meshed.program.device == CPU and meshed.program.graphed
    for entries, leaver in _churn():
        _same_stages(meshed.run_chunk(entries, d=2), plain.run_chunk(entries, d=2))
        got, want = meshed.lane_incumbents(), plain.lane_incumbents()
        assert [None if v is None else repr(v) for v in got] == \
            [None if v is None else repr(v) for v in want]
        assert meshed.lanes.owners == plain.lanes.owners
        if leaver is not None:
            meshed.release_tenant(leaver)
            plain.release_tenant(leaver)
    assert sorted(set(sizes)) == sorted(set(bucket.widths))


def test_continuous_lane_mesh_equals_reference(ref, rs):  # noqa: F811
    """``lane 2 x config 4``: the port on the ``cpu`` device repeated 8
    times, the reference on its eight devices, the same chunk sequence:
    every member's stages and every lane incumbent equal exactly (the
    linear objective)."""
    bucket = build_bucket_set([PLAN], mesh_size=4).buckets[0]
    rbucket = rs.buckets.build_bucket_set([PLAN], mesh_size=4).buckets[0]
    assert bucket.widths == tuple(rbucket.widths)
    mine = ContinuousRunner(_linear, bucket, lane_count=4, mesh=make_lane_mesh(2, [CPU] * 8))
    theirs = rs.continuous.ContinuousRunner(_ref_linear, rbucket, lane_count=4,
                                            mesh=rs.continuous.make_lane_mesh(2))
    for entries, leaver in _churn():
        _same_stages(mine.run_chunk(entries, d=2),
                     theirs.run_chunk(_ref_entries(rs, ref, entries), d=2))
        got, want = mine.lane_incumbents(), theirs.lane_incumbents()
        assert [None if v is None else repr(float(v)) for v in got] == \
            [None if v is None else repr(float(v)) for v in want]
        if leaver is not None:
            mine.release_tenant(leaver)
            theirs.release_tenant(leaver)


def test_megabatch_lanes_split_over_the_mesh():
    """``MegaRunner(mesh=)`` splits whole lanes over the config axis: the
    members' stages equal the unmeshed runner's bit for bit, and each
    objective call sees half the lanes' rows."""
    bucket = build_bucket_set([PLAN]).buckets[0]
    entries = [PackEntry(f"t{i}", _vectors(30 + i), PLAN, 0) for i in range(3)]
    sizes = []
    meshed = make_mega_runner(_counted(_linear, sizes), bucket, pack_width=4,
                              mesh=config_mesh([CPU] * 2))
    assert meshed.mesh is not None and meshed.program.device == CPU
    plain = make_mega_runner(_linear, bucket, pack_width=4, device="cpu")
    _same_stages(meshed.run_packed(entries, d=2), plain.run_packed(entries, d=2))
    assert sorted(set(sizes)) == sorted({2 * w for w in bucket.widths})
    assert make_mega_runner(_counted(_linear, []), bucket, pack_width=4,
                            mesh=config_mesh([CPU] * 2)) is not meshed


# ------------------------------------------------------------- telemetry
def test_megabatch_telemetry_records_equal_reference(ref, rs):  # noqa: F811
    """With ``device_metrics=True`` a packed dispatch emits one decoded
    ``device_telemetry`` record per member lane (none for padding lanes):
    equal to the reference's records, and to each member's solo bucketed
    record; the stages are unchanged; on a mesh the same records."""
    plans = [PLAN, BracketPlan((3, 1), (3.0, 9.0))]
    bucket_set = build_bucket_set(plans)
    rbucket = rs.buckets.build_bucket_set(plans).buckets[0]
    bucket = bucket_set.buckets[0]
    entries = [PackEntry("a", _vectors(40), PLAN, 0),
               PackEntry("b", _vectors(41, n=3), plans[1], 1),
               PackEntry("c", _vectors(42), PLAN, 0)]
    runner = make_mega_runner(_linear, bucket, pack_width=4, device="cpu", device_metrics=True)
    assert runner is not make_mega_runner(_linear, bucket, pack_width=4, device="cpu",
                                          device_metrics=False)
    out, recs = _telemetry(E.get_bus(), lambda: runner.run_packed(entries, d=2))
    assert len(recs) == 3
    theirs = rs.serve.make_mega_runner(_ref_linear, rbucket, pack_width=4, device_metrics=True)
    want_out, want = _telemetry(rs.events.get_bus(), lambda: theirs.run_packed(
        _ref_entries(rs, ref, entries), d=2))
    _same_stages(out, want_out)
    assert recs == want
    solo = make_bucketed_bracket_fn(_linear, bucket, device="cpu", device_metrics=True)
    for e, rec in zip(entries, recs):
        _, (solo_rec,) = _telemetry(E.get_bus(), lambda: solo.run_member(e.vectors, e.plan,
                                                                         e.entry))
        assert rec == solo_rec
    meshed = make_mega_runner(_linear, bucket, pack_width=4, mesh=config_mesh([CPU] * 2),
                              device_metrics=True)
    mesh_out, mesh_recs = _telemetry(E.get_bus(), lambda: meshed.run_packed(entries, d=2))
    _same_stages(mesh_out, out)
    assert mesh_recs == recs


def test_continuous_telemetry_records_equal_reference(ref, rs):  # noqa: F811
    """A telemetry-carrying chunk emits one record per occupied lane, equal
    to the reference's and to the solo bucketed records, with the stages
    bit-identical to the unmeshed, telemetry-free chunk; on a lane mesh the
    same records."""
    bucket = build_bucket_set([PLAN], mesh_size=2).buckets[0]
    rbucket = rs.buckets.build_bucket_set([PLAN], mesh_size=2).buckets[0]
    plain = ContinuousRunner(_linear, bucket, lane_count=4, device="cpu", device_metrics=False)
    mine = ContinuousRunner(_linear, bucket, lane_count=4, device="cpu", device_metrics=True)
    meshed = ContinuousRunner(_linear, bucket, lane_count=4, device_metrics=True,
                              mesh=make_lane_mesh(2, [CPU] * 4))
    theirs = rs.continuous.ContinuousRunner(_ref_linear, rbucket, lane_count=4,
                                            device_metrics=True)
    solo = make_bucketed_bracket_fn(_linear, bucket, device="cpu", device_metrics=True)
    for entries, _ in _churn()[:3]:
        out, recs = _telemetry(E.get_bus(), lambda: mine.run_chunk(entries, d=2))
        _same_stages(out, plain.run_chunk(entries, d=2))
        assert len(recs) == len(entries)
        want_out, want = _telemetry(rs.events.get_bus(), lambda: theirs.run_chunk(
            _ref_entries(rs, ref, entries), d=2))
        _same_stages(out, want_out)
        assert recs == want
        _, mesh_recs = _telemetry(E.get_bus(), lambda: meshed.run_chunk(entries, d=2))
        assert mesh_recs == recs
        for e, rec in zip(entries, recs):
            _, (solo_rec,) = _telemetry(E.get_bus(), lambda: solo.run_member(
                e.vectors, e.plan, e.entry))
            assert rec == solo_rec
            assert rec["evaluations"] == sum(PLAN.num_configs)
            assert [r["evals"] for r in rec["rungs"]] == [9, 3, 1]


# ----------------------------------------------------------------- the pool
def _run_threads(target, args_list):
    barrier = threading.Barrier(len(args_list))
    threads = [threading.Thread(target=target, args=args + (barrier,), daemon=True)
               for args in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), "a tenant thread did not finish"


def _losses_by_config(result):
    return {(tuple(r.config_id), r.budget): r.loss for r in result.get_all_runs()}


def _same_runs(got, want, exact):
    for t in want:
        g, w = _losses_by_config(got[t]), _losses_by_config(want[t])
        assert sorted(g) == sorted(w)
        keys = sorted(w)
        assert [g[k] is None for k in keys] == [w[k] is None for k in keys]
        gv, wv = [g[k] for k in keys if g[k] is not None], [w[k] for k in keys if w[k] is not None]
        if exact:
            assert gv == wv
        else:
            np.testing.assert_allclose(gv, wv, atol=LOSS_ATOL, rtol=LOSS_RTOL)
        id2c, id2c_w = got[t].get_id2config_mapping(), want[t].get_id2config_mapping()
        assert {c: v["config"] for c, v in id2c.items()} == \
            {c: v["config"] for c, v in id2c_w.items()}


def _hyperband_pools(ref, rs, port_pool, ref_pool, tenants=(("t0", 5), ("t1", 6))):  # noqa: F811
    """``HyperBand`` tenants (numpy sampling: the reference's draws) in a
    port pool and a reference pool; their results."""
    def port_tenant(pool, tenant, seed, results, barrier):
        opt = HyperBand(configspace=branin_space(seed=seed), run_id=f"hb-{tenant}",
                        tenant_id=tenant, executor=pool.executor_for(tenant),
                        min_budget=1, max_budget=27, eta=3, seed=seed)
        barrier.wait(timeout=JOIN_S)
        results[tenant] = opt.run(n_iterations=4)
        opt.shutdown()

    def ref_tenant(pool, tenant, seed, results, barrier):
        opt = rs.optimizers.HyperBand(
            configspace=ref.toys.branin_space(seed=seed), run_id=f"hb-{tenant}",
            tenant_id=tenant, executor=pool.executor_for(tenant), min_budget=1,
            max_budget=27, eta=3, seed=seed)
        barrier.wait(timeout=JOIN_S)
        results[tenant] = opt.run(n_iterations=4)
        opt.shutdown()

    mine, theirs = {}, {}
    _run_threads(port_tenant, [(port_pool, t, s, mine) for t, s in tenants])
    _run_threads(ref_tenant, [(ref_pool, t, s, theirs) for t, s in tenants])
    return mine, theirs


@pytest.mark.parametrize("n_shards", [2, 3])
def test_pool_honours_the_backend_mesh(ref, rs, monkeypatch, n_shards):  # noqa: F811
    """``ServePool`` over a meshed backend pads its bucket set to the mesh
    axis and dispatches its solo and packed programs sharded, as the
    reference's does: the same bucket widths as the reference's pool over
    as many of its devices, the same runs per tenant, every program the
    pool ran on the backend's mesh, and no objective call wider than a
    shard's block (of a solo bracket's rows, or of a packed dispatch's
    lanes)."""
    monkeypatch.setenv("HPB_XLA_CACHE", "0")
    sizes = []
    mesh = config_mesh([CPU] * n_shards)
    pool = ServePool(VmapBackend(_counted(branin, sizes), mesh=mesh),
                     branin_space(seed=0), pack_window_s=0.05, pack_width=6)
    rpool = rs.serve.ServePool(
        rs.parallel.VmapBackend(ref.toys.branin_from_vector,
                                mesh=rs.mesh.config_mesh(rs.devices[:n_shards])),
        ref.toys.branin_space(seed=0), pack_window_s=0.05, pack_width=6)
    mine, theirs = _hyperband_pools(ref, rs, pool, rpool)
    widths = [b.widths for b in pool._bucket_set.buckets]
    assert widths == [tuple(b.widths) for b in rpool._bucket_set.buckets]
    assert all(w % n_shards == 0 for ws in widths for w in ws)
    _same_runs(mine, theirs, exact=False)
    dispatched = pool.snapshot()["dispatches"]
    assert dispatched["packed_brackets"] + dispatched["solo_brackets"] >= 4, dispatched
    programs = pool.programs()
    assert programs and all(r.mesh is mesh for r in programs)
    w0 = max(ws[0] for ws in widths)
    block = (6 // n_shards) * w0 if dispatched["packed_dispatches"] else w0 // n_shards
    assert max(sizes) <= block, sorted(set(sizes))


def test_pool_lane_mesh_equals_reference(ref, rs, monkeypatch):  # noqa: F811
    """``ServePool(continuous=True, lane_mesh=)`` over a ``lane 2 x config
    3`` mesh: the bucket set pads to the config axis as the reference's,
    and each tenant's runs equal the reference's lane-meshed pool's."""
    monkeypatch.setenv("HPB_XLA_CACHE", "0")
    pool = ServePool(VmapBackend(branin, device="cpu"), branin_space(seed=0),
                     pack_window_s=0.05, continuous=True, lane_count=4,
                     lane_mesh=make_lane_mesh(2, [CPU] * 6))
    rpool = rs.serve.ServePool(rs.parallel.VmapBackend(ref.toys.branin_from_vector),
                               ref.toys.branin_space(seed=0), pack_window_s=0.05,
                               continuous=True, lane_count=4,
                               lane_mesh=rs.continuous.make_lane_mesh(2, rs.devices[:6]))
    mine, theirs = _hyperband_pools(ref, rs, pool, rpool)
    widths = [b.widths for b in pool._bucket_set.buckets]
    assert widths == [tuple(b.widths) for b in rpool._bucket_set.buckets]
    assert all(w % 3 == 0 for ws in widths for w in ws)
    _same_runs(mine, theirs, exact=False)
    assert all(r.mesh is pool.lane_mesh for r in pool._continuous_runners.values())
    assert pool.snapshot()["dispatches"]["continuous_brackets"] >= 4


def test_pool_lane_mesh_tenants_equal_unmeshed_bitwise():
    """``BOHB`` tenants in a lane-meshed continuous pool (``lane 2 x config
    2``) equal the same tenants in an unmeshed continuous pool bit for
    bit; each family builds one program."""
    def tenant(pool, name, seed, results, barrier):
        opt = BOHB(configspace=branin_space(seed=seed), run_id=f"lm-{name}", tenant_id=name,
                   executor=pool.executor_for(name), min_budget=1, max_budget=9, eta=3,
                   seed=seed, device="cpu")
        barrier.wait(timeout=JOIN_S)
        results[name] = opt.run(n_iterations=3)
        opt.shutdown()

    out = []
    for lane_mesh in (make_lane_mesh(2, [CPU] * 4), None):
        pool = ServePool(VmapBackend(branin, device="cpu"), branin_space(seed=0),
                         pack_window_s=0.05, continuous=True, lane_count=4,
                         lane_mesh=lane_mesh)
        results = {}
        _run_threads(tenant, [(pool, f"t{s}", s, results) for s in (0, 1, 2)])
        out.append((pool, results))
    (meshed, got), (_, want) = out
    _same_runs(got, want, exact=True)
    assert all(r.program.built for r in meshed._continuous_runners.values())
    assert not any(snap["occupied"] for snap in meshed.snapshot()["lanes"])
