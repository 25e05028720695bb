"""The port's shape-bucketed brackets (``hpbandster_tpu_torch/ops/buckets.py``)
against the reference's (``hpbandster_tpu/ops/buckets.py``), on the CPU.

Bucket geometry equals the reference's exactly. The bucketed kernels
(solo, lane-packed, lane-packed with the incumbent carry) promote the
reference's survivors exactly on seeded vectors and counts (promotion is a
stable sort on both sides), with losses of the 2-dim quadratic within
``KERNEL_RTOL``: XLA contracts ``a*a + b*b`` into a fused multiply-add,
eager PyTorch does not (1 ulp). Inside the port a lane equals its solo
bracket bit for bit. Whole ``BOHB`` / ``HyperBand`` runs over
``BatchedExecutor(bucket_brackets=True)`` equal ``bucket_brackets=False``
run for run, and equal the reference's bucketed executor within ``atol
1e-4, rtol 1e-4`` on the losses (XLA contracts Branin's polynomial
differently from eager PyTorch, ROADMAP C.15).
"""

import threading

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch.ops import buckets as tb
from hpbandster_tpu_torch.ops import cuda_kde
from hpbandster_tpu_torch.ops.bracket import BracketPlan, hyperband_schedule
from hpbandster_tpu_torch.ops.sweep import decode_lane_state, init_lane_state
from hpbandster_tpu_torch.optimizers import BOHB, HyperBand
from hpbandster_tpu_torch.parallel import BatchedExecutor, VmapBackend
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_harness import ReferenceKDEDraws, ref, ref_opt  # noqa: F401

LOSS_ATOL = LOSS_RTOL = 1e-4
#: the quadratic's losses against the reference's: a few ulps at most
KERNEL_RTOL, KERNEL_ATOL = 1e-6, 1e-7


@pytest.fixture(scope="module")
def rb(ref):  # noqa: F811
    """The reference's ``ops/buckets.py``, inside the ``ref`` window."""
    import importlib

    return importlib.import_module("hpbandster_tpu.ops.buckets")


def ref_quad(vec, budget):
    import jax.numpy as jnp

    return jnp.sum(jnp.square(vec - 0.3)) / budget


def ref_crashy(vec, budget):
    import jax.numpy as jnp

    return jnp.where(vec[0] > 0.5, jnp.nan, ref_quad(vec, budget))


def quad(v, budget):
    return torch.square(v - 0.3).sum(1) / budget


def crashy(v, budget):
    return quad(v, budget).masked_fill(v[:, 0] > 0.5, float("nan"))


def all_nan(v, budget):
    return v.sum(1) * float("nan")


def ref_all_nan(vec, budget):
    import jax.numpy as jnp

    return jnp.nan * jnp.sum(vec)


OBJECTIVES = {"quad": (quad, ref_quad), "crashy": (crashy, ref_crashy),
              "all_nan": (all_nan, ref_all_nan)}


def ref_plans(ref, plans):  # noqa: F811
    return [ref.bracket.BracketPlan(p.num_configs, p.budgets) for p in plans]


def assert_same_set(port_set, ref_set):
    assert [tuple(b) for b in port_set.buckets] == [tuple(b) for b in ref_set.buckets]
    assert port_set.assignment == ref_set.assignment


# --------------------------------------------------------------- geometry
@pytest.mark.parametrize("case", ["rotation_729", "foreign_ladder", "single_stage",
                                  "rotation_81", "rotation_and_foreign"])
def test_bucket_set_equals_reference(ref, rb, case):  # noqa: F811
    """The 36-bracket 1..729 rotation (at most 6 programs, 3 in fact), a
    foreign ladder (its own singleton bucket), single-stage plans (left
    out), the toy 1..81 rotation, and that rotation with a foreign ladder:
    the same buckets and placements. ``BucketSet.place`` puts every shape
    where the reference's lookup does, with its member plan, and places
    neither a left-out shape nor one no plan has."""
    plans = {
        "rotation_729": hyperband_schedule(36, 1, 729, 3),
        "foreign_ladder": [BracketPlan((9, 3, 1), (1.0, 3.0, 9.0)),
                           BracketPlan((8, 2), (5.0, 25.0))],
        "single_stage": [BracketPlan((5,), (9.0,)), BracketPlan((9, 3), (3.0, 9.0))],
        "rotation_81": hyperband_schedule(10, 1, 81, 3),
        "rotation_and_foreign": [*hyperband_schedule(4, 1, 27, 3),
                                 BracketPlan((8, 2), (5.0, 25.0))],
    }[case]
    port_set = tb.build_bucket_set(plans)
    ref_set = rb.build_bucket_set(ref_plans(ref, plans))
    assert_same_set(port_set, ref_set)
    for plan in [*plans, BracketPlan((7, 2), (2.0, 6.0))]:
        want = ref_set.lookup(plan.num_configs, plan.budgets)
        got = port_set.place(plan.num_configs, plan.budgets)
        if want is None:
            assert got is None, plan
        else:
            assert got == (port_set.buckets[want[0]], plan, want[1]), plan
    if case == "rotation_729":
        assert len(port_set.buckets) == 3
    if case == "single_stage":
        assert ((5,), (9.0,)) not in port_set.assignment
    for b in port_set.buckets:
        assert all(w1 >= w2 for w1, w2 in zip(b.widths, b.widths[1:]))
        assert all(w >= 8 and (w & (w - 1)) == 0 for w in b.widths)


# ----------------------------------------------------------------- kernels
def _counts_for(bucket_set, plan):
    bi, entry = bucket_set.lookup(plan.num_configs, plan.budgets)
    bucket = bucket_set.buckets[bi]
    return bucket, tb.member_counts_for(bucket, plan, entry), entry


def _member_vectors(rng, bucket, n0, d=2):
    x = np.zeros((bucket.widths[0], d), np.float32)
    x[:n0] = rng.uniform(size=(n0, d)).astype(np.float32)
    return x


def _assert_stages_equal(got, want, exact=False):
    """The same survivors at every stage; losses bit for bit when
    ``exact``, else within ``KERNEL_RTOL`` (NaN where NaN)."""
    assert len(got) == len(want)
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
        if exact:
            np.testing.assert_array_equal(np.asarray(gl), np.asarray(wl))
        else:
            np.testing.assert_allclose(np.asarray(gl), np.asarray(wl),
                                       rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


@pytest.mark.parametrize("case", ["entry0", "later_entry", "crashes", "all_crashed",
                                  "ties"])
def test_bucketed_bracket_equals_reference(ref, rb, case):  # noqa: F811
    """``fused_sh_bracket_bucketed`` against the reference's (jitted) on
    seeded vectors and counts: the same survivors at every stage, the same
    losses, padding never promoted."""
    import jax

    plans = hyperband_schedule(27, 1, 9, 3)
    bucket_set = tb.build_bucket_set(plans)
    plan = next(p for p in plans if len(p.budgets) == 2) if case == "later_entry" else plans[0]
    bucket, counts, entry = _counts_for(bucket_set, plan)
    assert (entry > 0) == (case == "later_entry")
    port_fn, ref_fn = OBJECTIVES[{"crashes": "crashy", "all_crashed": "all_nan"}.get(
        case, "quad")]
    rng = np.random.default_rng(7)
    x = _member_vectors(rng, bucket, plan.num_configs[0])
    if case == "ties":
        x[3] = x[5]
        x[1] = x[2]
    rbucket = rb.BucketPlan(bucket.widths, bucket.budgets)
    want = jax.jit(lambda v, c: rb.fused_sh_bracket_bucketed(ref_fn, v, c, rbucket))(x, counts)
    got = tb.fused_sh_bracket_bucketed(port_fn, torch.from_numpy(x),
                                       torch.from_numpy(counts), bucket)
    _assert_stages_equal(got, want)
    member = tb.slice_member_stages([(i.numpy(), l.numpy()) for i, l in got], plan, entry)
    for idx, losses in member:
        assert (idx < plan.num_configs[0]).all()
        if case == "all_crashed":
            assert np.isnan(losses).all()


def _lane_inputs(bucket_set, plans, rng, n_lanes):
    """Seeded lanes of one bucket: members of ``plans`` then empty lanes."""
    bucket = bucket_set.buckets[0]
    vectors = np.zeros((n_lanes, bucket.widths[0], 2), np.float32)
    counts = np.zeros((n_lanes, bucket.depth), np.int32)
    for lane, plan in enumerate(plans):
        _, c, _ = _counts_for(bucket_set, plan)
        vectors[lane] = _member_vectors(rng, bucket, plan.num_configs[0])
        counts[lane] = c
    return bucket, vectors, counts


@pytest.mark.parametrize("objective", ["quad", "crashy"])
def test_packed_and_carry_equal_reference(ref, rb, objective):  # noqa: F811
    """The lane-packed kernel and its carried form against the
    reference's: two members at different entries, a duplicate, and an
    empty lane; the carry folds, resets and passes an empty lane through;
    the per-lane telemetry equals the reference's."""
    import jax

    port_fn, ref_fn = OBJECTIVES[objective]
    plans = hyperband_schedule(27, 1, 9, 3)
    bucket_set = tb.build_bucket_set(plans)
    members = [plans[0], plans[1], plans[0]]
    bucket, vectors, counts = _lane_inputs(bucket_set, members, np.random.default_rng(3), 4)
    rbucket = rb.BucketPlan(bucket.widths, bucket.budgets)
    edges = ref.device_metrics.bin_edges().astype(np.float32)
    want = jax.jit(lambda v, c: rb.fused_sh_bracket_bucketed_packed(
        ref_fn, v, c, rbucket, telemetry_edges=edges))(vectors, counts)
    v_t, c_t = torch.from_numpy(vectors), torch.from_numpy(counts)
    got = tb.fused_sh_bracket_bucketed_packed(port_fn, v_t, c_t, bucket,
                                              telemetry_edges=torch.from_numpy(edges))
    idx, loss, hist, crashes = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[0].numpy(), idx)
    np.testing.assert_allclose(got[1].numpy(), loss, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    np.testing.assert_array_equal(got[2].numpy(), hist)
    np.testing.assert_array_equal(got[3].numpy(), crashes)

    carry = np.array([np.inf, 0.5, -1.0, 7.0], np.float32)
    reset = np.array([False, False, True, True])
    want_out, want_carry = jax.jit(lambda v, c, k, r: rb.fused_sh_bracket_bucketed_packed_carry(
        ref_fn, v, c, k, r, rbucket))(vectors, counts, carry, reset)
    (idx, loss), new_carry = tb.fused_sh_bracket_bucketed_packed_carry(
        port_fn, v_t, c_t, torch.from_numpy(carry), torch.from_numpy(reset), bucket)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_out[0]))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_out[1]),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    np.testing.assert_allclose(new_carry.numpy(), np.asarray(want_carry),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    # the empty, reset lane folds nothing: back to "observed nothing"
    assert decode_lane_state(new_carry)[3] is None
    # each lane equals its solo bracket
    for lane in range(3):
        solo = tb.fused_sh_bracket_bucketed(port_fn, v_t[lane], c_t[lane], bucket)
        np.testing.assert_array_equal(torch.cat([i for i, _ in solo]).numpy(),
                                      idx[lane].numpy())
        np.testing.assert_array_equal(torch.cat([l for _, l in solo]).numpy(),
                                      loss[lane].numpy())


def test_lane_state_equals_reference(ref):  # noqa: F811
    """``init_lane_state`` / ``decode_lane_state``: +inf is empty, the
    crash rank decodes to NaN, a loss to itself."""
    carry = init_lane_state(3)
    assert torch.isinf(carry).all() and carry.dtype == torch.float32
    np.testing.assert_array_equal(carry.numpy(), np.asarray(ref.sweep.init_lane_state(3)))
    state = np.array([np.inf, 3e38, 0.25, -2.0], np.float32)
    got, want = decode_lane_state(torch.from_numpy(state)), ref.sweep.decode_lane_state(state)
    assert got[0] is None and want[0] is None
    assert np.isnan(got[1]) and np.isnan(want[1])
    assert got[2:] == want[2:]


# ---------------------------------------------------------- member helpers
def test_member_helpers_equal_reference(ref, rb):  # noqa: F811
    """``member_counts_for``, ``slice_member_stages``,
    ``bucketed_stage_telemetry`` and ``member_telemetry_record`` (the
    decoded ``device_telemetry`` record) equal the reference's, for an
    entry-0 member with crashes, a later-entry member and a padding lane."""
    import jax.numpy as jnp

    plans = hyperband_schedule(27, 1, 9, 3)
    bucket_set = tb.build_bucket_set(plans)
    edges = ref.device_metrics.bin_edges().astype(np.float32)
    rng = np.random.default_rng(11)
    for plan in (plans[0], plans[1], None):
        bucket = bucket_set.buckets[0]
        if plan is None:
            counts, entry = np.zeros(bucket.depth, np.int32), 0
        else:
            _, counts, entry = _counts_for(bucket_set, plan)
            rplan = ref.bracket.BracketPlan(plan.num_configs, plan.budgets)
            np.testing.assert_array_equal(
                counts, rb.member_counts_for(rb.BucketPlan(*bucket), rplan, entry))
        x = _member_vectors(rng, bucket, int(counts.max()) or 1)
        stages = tb.fused_sh_bracket_bucketed(crashy, torch.from_numpy(x),
                                              torch.from_numpy(counts), bucket)
        tel = tb.bucketed_stage_telemetry(stages, torch.from_numpy(counts),
                                          torch.from_numpy(edges))
        ref_stages = [(jnp.asarray(i.numpy()), jnp.asarray(l.numpy())) for i, l in stages]
        ref_tel = rb.bucketed_stage_telemetry(ref_stages, counts, edges)
        for (h, c), (rh, rc) in zip(tel, ref_tel):
            np.testing.assert_array_equal(h.numpy(), np.asarray(rh))
            assert int(c) == int(rc)
        hist = np.stack([h.numpy() for h, _ in tel])
        crashes = np.stack([c.numpy() for _, c in tel])
        host = [(i.numpy(), l.numpy()) for i, l in stages]
        if plan is None:
            assert tb.member_telemetry_record(hist, crashes, counts, bucket.budgets, host) is None
            assert rb.member_telemetry_record(hist, crashes, counts, bucket.budgets, host) is None
            continue
        member = tb.slice_member_stages(host, plan, entry)
        ref_member = rb.slice_member_stages(host, rplan, entry)
        _assert_stages_equal(member, ref_member, exact=True)
        got = tb.member_telemetry_record(hist, crashes, counts, bucket.budgets, member)
        want = rb.member_telemetry_record(hist, crashes, counts, bucket.budgets, ref_member)
        assert got == want


# ------------------------------------------------------------ the runners
def test_one_build_per_bucket_and_dimension_guard():
    """A precompile and later dispatches build each bucket's program once
    (the runner is cached per objective, bucket and device); a wrong ``d``
    raises; a failed build keeps its error and the next dispatch raises
    it."""

    def fresh(v, budget):  # a fresh closure: its own cache entries
        return quad(v, budget)

    plans = hyperband_schedule(9, 1, 9, 3)
    bucket_set = tb.build_bucket_set(plans)
    runners = [tb.make_bucketed_bracket_fn(fresh, b, device="cpu") for b in bucket_set.buckets]
    builds = []
    for r in runners:
        make = r.program._make_buffers
        r.program._make_buffers = lambda d, make=make: builds.append(d) or make(d)
    handle = tb.precompile_buckets(fresh, bucket_set, d=2, device="cpu", background=True)
    assert handle.wait(timeout=60) and handle.errors == []
    rng = np.random.default_rng(1)
    for plan in plans:
        placed = bucket_set.lookup(plan.num_configs, plan.budgets)
        if placed is None:
            continue
        bi, entry = placed
        runner = tb.make_bucketed_bracket_fn(fresh, bucket_set.buckets[bi], device="cpu")
        assert runner is runners[bi]
        runner.run_member(rng.uniform(size=(plan.num_configs[0], 2)), plan, entry)
    assert builds == [2] * len(bucket_set.buckets)
    with pytest.raises(ValueError, match="built for d=2"):
        runners[0].ensure_compiled(3)

    def broken(d):
        raise RuntimeError("no buffers today")

    bad = tb._BucketRunner(fresh, bucket_set.buckets[0], device="cpu")
    bad.program._make_buffers = broken
    handle = tb.start_precompile([bad], 2, True, "test-precompile")
    assert handle.wait(timeout=60) and len(handle.errors) == 1
    with pytest.raises(RuntimeError, match="failed to build"):
        bad.dispatch(np.zeros((9, 2), np.float32), [9, 3, 1])


def test_dispatch_returns_fresh_outputs():
    """Two dispatches in flight never share an output tensor."""
    plan = BracketPlan((9, 3, 1), (1.0, 3.0, 9.0))
    bucket = tb.build_bucket_set([plan]).buckets[0]
    runner = tb.make_bucketed_bracket_fn(quad, bucket, device="cpu")
    rng = np.random.default_rng(5)
    xa, xb = rng.uniform(size=(9, 2)), rng.uniform(size=(9, 2))
    counts = tb.member_counts_for(bucket, plan, 0)
    pa, pb = runner.dispatch(xa, counts), runner.dispatch(xb, counts)
    assert pa.data_ptr() != pb.data_ptr()
    _assert_stages_equal(tb.slice_member_stages(runner.unpack(pa), plan, 0),
                         runner.run_member(xa, plan, 0), exact=True)


def test_launch_counts_exact_across_threads(monkeypatch):
    """``cuda_kde``'s counts lose no launch when several host threads count
    at once, and a capture's record holds its own thread's captured
    launches only, whatever other threads capture or launch meanwhile."""
    capturing = threading.local()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: getattr(capturing, "on", False))
    monkeypatch.setattr(cuda_kde, "LAUNCHES", {"kde_score": 0, "kde_moments": 0})
    monkeypatch.setattr(cuda_kde, "CAPTURED", {"kde_score": 0, "kde_moments": 0})
    n_threads, n = 8, 4000
    records = {}
    barrier = threading.Barrier(n_threads)

    def work(i):
        capture = i % 2 == 0
        barrier.wait(timeout=30)
        if capture:
            capturing.on = True
            with cuda_kde.counting_capture() as rec:
                for _ in range(n + i):
                    cuda_kde._count_launch("kde_score", ())
            capturing.on = False
            records[i] = dict(rec)
            cuda_kde.add_launches(rec)
        else:
            for _ in range(n + i):
                cuda_kde._count_launch("kde_moments", ())

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for i, rec in records.items():
        assert rec == {"kde_score": n + i, "kde_moments": 0}
    captured = sum(n + i for i in range(0, n_threads, 2))
    launched = sum(n + i for i in range(1, n_threads, 2))
    assert cuda_kde.CAPTURED == {"kde_score": captured, "kde_moments": 0}
    assert cuda_kde.LAUNCHES == {"kde_score": captured, "kde_moments": launched}


# ------------------------------------------------------ the executor path
def _runs(res):
    return {(r.config_id, r.budget): r.loss for r in res.get_all_runs()}


def _port_opt(cls, seed, max_budget, bucket_brackets, objective=branin, **kw):
    cs = branin_space(seed=seed)
    ex = BatchedExecutor(VmapBackend(objective, device="cpu"), cs,
                         bucket_brackets=bucket_brackets)
    if cls is BOHB:
        kw["device"] = "cpu"
    return cls(configspace=cs, run_id=f"bkt{bucket_brackets}", executor=ex, min_budget=1,
               max_budget=max_budget, eta=3, seed=seed, **kw), ex


@pytest.mark.parametrize("cls", [BOHB, HyperBand])
def test_bucketed_executor_equals_unbucketed(cls):
    """``bucket_brackets=True`` (the default) equals ``False`` run for run,
    bit for bit, and every fused bracket rode a bucket program."""
    kw = {"min_points_in_model": 4} if cls is BOHB else {}
    out = {}
    for bucketed in (True, False):
        opt, ex = _port_opt(cls, 3, 27, bucketed, **kw)
        res = opt.run(n_iterations=6)
        opt.shutdown()
        out[bucketed] = _runs(res)
        if bucketed:
            assert ex._bucket_set is not None and len(ex._bucket_set.buckets) == 2
            assert ex.bucketed_brackets_run == ex.fused_brackets_run > 0
            assert ex._bucket_precompile.wait(timeout=60)
        else:
            assert ex.bucketed_brackets_run == 0 and ex._bucket_set is None
    assert out[True] == out[False]
    assert BatchedExecutor(VmapBackend(branin, device="cpu"), branin_space()).bucket_brackets


@pytest.mark.parametrize("cls_name", ["BOHB", "HyperBand"])
def test_bucketed_executor_equals_reference(ref, ref_opt, cls_name, monkeypatch):  # noqa: F811
    """Against the reference's bucketed executor (its default), with the
    reference's candidates fed to the port's ``BOHB``: the same runs,
    losses within 1e-4."""
    monkeypatch.setenv("HPB_XLA_CACHE", "0")  # no persistent compile cache
    seed, kw = 0, ({"min_points_in_model": 4} if cls_name == "BOHB" else {})
    cs = ref.toys.branin_space(seed=seed)
    ex_ref = ref_opt.parallel.BatchedExecutor(
        ref_opt.parallel.VmapBackend(ref.toys.branin_from_vector), cs)
    assert ex_ref.bucket_brackets
    opt_ref = getattr(ref_opt.optimizers, cls_name)(
        configspace=cs, run_id="ref", executor=ex_ref, min_budget=1, max_budget=27,
        eta=3, seed=seed, **kw)
    res_ref = opt_ref.run(n_iterations=4)
    opt_ref.shutdown()
    opt, ex = _port_opt(BOHB if cls_name == "BOHB" else HyperBand, seed, 27, True, **kw)
    if cls_name == "BOHB":
        opt.config_generator.draws = ReferenceKDEDraws(ref, trickle_seed=seed)
    res = opt.run(n_iterations=4)
    opt.shutdown()
    assert ex.bucketed_brackets_run == ex_ref.bucketed_brackets_run > 0
    want, got = _runs(res_ref), _runs(res)
    assert sorted(got) == sorted(want)
    id2c, id2c_ref = res.get_id2config_mapping(), res_ref.get_id2config_mapping()
    for cid in id2c_ref:
        assert id2c[cid]["config"] == id2c_ref[cid]["config"], cid
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys], [want[k] for k in keys],
                               atol=LOSS_ATOL, rtol=LOSS_RTOL)


def test_bucketed_failures_raise_on_a_card_and_fall_back_on_the_cpu(monkeypatch):
    """A bucketed dispatch that fails falls back to the per-shape program
    on the CPU (the reference's behaviour) and raises where the executor
    runs on a card; a failed schedule preparation is logged on the CPU and
    raises on a card."""

    class Refusing:
        bucket = None

        def dispatch(self, vectors, counts):
            raise RuntimeError("bucket program refused")

    def refusing_runner(self, info):
        plan = BracketPlan(tuple(info["num_configs"]), tuple(info["budgets"]))
        runner = Refusing()
        runner.bucket = tb.build_bucket_set([plan]).buckets[0]
        return runner, plan, 0

    monkeypatch.setattr(BatchedExecutor, "_bucket_runner_for", refusing_runner)
    opt, ex = _port_opt(HyperBand, 1, 9, True)
    res = opt.run(n_iterations=2)
    opt.shutdown()
    assert len(res.get_all_runs()) == 13 + 6
    assert all(r.loss is not None for r in res.get_all_runs())
    assert ex.fused_brackets_run == 2 and ex.bucketed_brackets_run == 0

    opt, ex = _port_opt(HyperBand, 1, 9, True)
    monkeypatch.setattr(ex, "_strict", lambda: True)
    with pytest.raises(RuntimeError, match="refused"):
        opt.run(n_iterations=1)

    def refuse_schedule(plans):
        raise RuntimeError("no schedule today")

    opt, ex = _port_opt(HyperBand, 1, 9, True)
    monkeypatch.setattr(ex, "prepare_schedule", refuse_schedule)
    assert len(opt.run(n_iterations=1).get_all_runs()) == 13
    opt, ex = _port_opt(HyperBand, 1, 9, True)
    monkeypatch.setattr(ex, "prepare_schedule", refuse_schedule)
    ex.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="no schedule"):
        opt.run(n_iterations=1)
