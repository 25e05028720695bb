"""The port's config-axis sharding against the reference's
(``tests/test_sharded.py``'s cases), on the CPU: the reference on its eight
virtual devices (``tests/conftest.py``), the port on meshes of a repeated
``cpu`` device (``parallel/mesh.py``), which run the same per-shard
sampling, row split, padding and promotion code that a mesh of cards runs.

Bars, as the reference's: on a one-shard mesh every sharded kernel and the
sweep are the unsharded ones bit for bit; on 3- and 8-shard meshes the
bucketed members (uneven padding, crashed rows and a member entering at
stage 1 included) and the fused bracket keep the unsharded results bit for
bit inside the port, and the reference's stage indices exactly. Through the
draw seam (``ReferenceDraws.stage0_shard``, the reference's per-shard
``fold_in`` draws) the port's sharded sweep on 2, 3 and 8 shards, and
``run_sharded_fused_sweep`` at 256 configurations on 8 shards, pick the
reference's configurations (``atol 1e-6``), promote its rows exactly and
reach its losses within ``atol 1e-4, rtol 1e-4`` (XLA contracts Branin's
polynomial differently from eager PyTorch, ROADMAP C.15); the 2-dim
quadratic within ``KERNEL_RTOL`` (one fused multiply-add).
"""

import inspect

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch import FusedBOHB
from hpbandster_tpu_torch.obs.metrics import get_metrics
from hpbandster_tpu_torch.ops import buckets as tb
from hpbandster_tpu_torch.ops import sweep as tsweep
from hpbandster_tpu_torch.ops.bracket import BracketPlan, hyperband_schedule, mesh_aligned_plan
from hpbandster_tpu_torch.ops.fused import StatefulEval, fused_sh_bracket, make_fused_bracket_fn
from hpbandster_tpu_torch.ops.sweep import (
    build_space_codec,
    make_fused_sweep_fn,
    plan_additions,
    pow2_capacities,
    unstack_resident_outputs,
)
from hpbandster_tpu_torch.optimizers import BOHB
from hpbandster_tpu_torch.optimizers import fused_bohb as tfb
from hpbandster_tpu_torch.parallel import (
    BatchedExecutor,
    TPUBatchedWorker,
    VmapBackend,
    multihost,
)
from hpbandster_tpu_torch.parallel.mesh import config_mesh, config_model_mesh
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_harness import ReferenceDraws, ref, ref_mesh  # noqa: F401

LOSS_ATOL = LOSS_RTOL = 1e-4
KERNEL_RTOL, KERNEL_ATOL = 1e-6, 1e-7
NAN = float("nan")


def cpu_mesh(n):
    return config_mesh([torch.device("cpu")] * n)


def quad(v, budget):
    return torch.square(v - 0.3).sum(1) * budget


def crashy(v, budget):
    return torch.where(v[:, 0] > 0.6, torch.full_like(v[:, 0], NAN), quad(v, budget))


def ref_quad(vec, budget):
    import jax.numpy as jnp

    return jnp.sum(jnp.square(vec - 0.3)) * budget


def ref_crashy(vec, budget):
    import jax.numpy as jnp

    return jnp.where(vec[0] > 0.6, jnp.nan, ref_quad(vec, budget))


OBJECTIVES = {"quad": (quad, ref_quad), "crashy": (crashy, ref_crashy)}


def _same_stages(a, b):
    assert len(a) == len(b)
    for (ia, la), (ib, lb) in zip(a, b):
        np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


@pytest.fixture(autouse=True)
def _fresh_caches():
    """Runs compared here must build their own programs."""
    multihost._SHARDED_FN_CACHE.clear()
    tfb._SWEEP_CACHE.clear()
    yield
    multihost._SHARDED_FN_CACHE.clear()
    tfb._SWEEP_CACHE.clear()


# -------------------------------------------- kernel parity (the buckets)
@pytest.mark.parametrize("n_shards,objective,plans", [
    (1, "quad", hyperband_schedule(27, 1, 9, 3)),
    (1, "crashy", [BracketPlan((9, 3, 1), (1.0, 3.0, 9.0))]),
    # pow2 widths are not multiples of 3: every stage pads unevenly
    (3, "crashy", hyperband_schedule(27, 1, 9, 3)),
    (8, "quad", hyperband_schedule(9, 1, 9, 3)),
])
def test_bucketed_members_on_a_mesh_equal_the_unsharded_kernel(
        ref_mesh, n_shards, objective, plans):  # noqa: F811
    """Each member bracket (an entry-1 member and crashed rows included)
    run on its mesh-padded bucket equals the unsharded bucket bit for bit,
    and the reference's mesh kernel on as many devices (indices exact,
    losses within ``KERNEL_RTOL``)."""
    port_eval, ref_eval = OBJECTIVES[objective]
    mesh = cpu_mesh(n_shards)
    rmesh = ref_mesh.mesh.config_mesh(ref_mesh.devices[:n_shards])
    plain_set = tb.build_bucket_set(plans)
    mesh_set = tb.build_bucket_set(plans, mesh_size=n_shards)
    rplans = [ref_mesh.buckets.BracketPlan(p.num_configs, p.budgets) for p in plans]
    ref_set = ref_mesh.buckets.build_bucket_set(rplans, mesh_size=n_shards)
    rng = np.random.default_rng(11 + n_shards)
    n_entry = 0
    for plan, rplan in zip(plans, rplans):
        if len(plan.num_configs) < 2:
            continue  # a one-stage plan has no bucket
        bi, entry = plain_set.lookup(plan.num_configs, plan.budgets)
        bj, entry_m = mesh_set.lookup(plan.num_configs, plan.budgets)
        n_entry += entry_m > 0
        x = rng.uniform(size=(plan.num_configs[0], 2)).astype(np.float32)
        want = tb.make_bucketed_bracket_fn(port_eval, plain_set.buckets[bi],
                                           device="cpu").run_member(x, plan, entry)
        got = tb.make_bucketed_bracket_fn(port_eval, mesh_set.buckets[bj],
                                          mesh=mesh).run_member(x, plan, entry_m)
        _same_stages(got, want)
        rj, rentry = ref_set.lookup(rplan.num_configs, rplan.budgets)
        theirs = ref_mesh.buckets.make_bucketed_bracket_fn(
            ref_eval, ref_set.buckets[rj], mesh=rmesh).run_member(x, rplan, rentry)
        for (ig, lg), (ir, lr) in zip(got, theirs):
            np.testing.assert_array_equal(ig, np.asarray(ir))
            np.testing.assert_allclose(lg, np.asarray(lr), rtol=KERNEL_RTOL,
                                       atol=KERNEL_ATOL)
    if len(plans) > 1:
        assert n_entry > 0, "no member entered its bucket after stage 0"


def test_fused_bracket_on_a_mesh_is_the_unsharded_bracket():
    """``fused_sh_bracket(mesh=)`` gives the unsharded stages bit for bit
    (crashes included), and ``make_fused_bracket_fn(mesh=)`` pads stage 0
    to the shard count with rows that are never promoted or reported."""
    x = torch.from_numpy(np.random.default_rng(3).uniform(size=(16, 2)).astype(np.float32))
    plain = fused_sh_bracket(crashy, x, (16, 8, 1), (1.0, 3.0, 9.0))
    sharded = fused_sh_bracket(crashy, x, (16, 8, 1), (1.0, 3.0, 9.0), mesh=cpu_mesh(8))
    _same_stages([(i.numpy(), l.numpy()) for i, l in sharded],
                 [(i.numpy(), l.numpy()) for i, l in plain])
    xs = x.numpy()[:9]
    want = make_fused_bracket_fn(crashy, (9, 3, 1), (1.0, 3.0, 9.0), device="cpu")(xs)
    got = make_fused_bracket_fn(crashy, (9, 3, 1), (1.0, 3.0, 9.0), mesh=cpu_mesh(4))(xs)
    _same_stages(got, want)
    assert all(int(i.max()) < 9 for i, _ in got)


def test_stateful_bracket_on_a_mesh_continues_each_lane():
    """A ``StatefulEval`` bracket on a 4-shard mesh: each shard trains its
    lanes, the survivors' lanes are gathered between rungs, and the stages
    and the final state equal the unsharded bracket's bit for bit."""
    def init(v):
        return {"w": torch.zeros_like(v), "steps": torch.zeros(v.shape[0])}

    def step(state, v, budget, prev):
        w = state["w"]
        for _ in range(int(budget - prev)):
            w = w + 0.25 * (v - w)
        loss = torch.square(w - 0.3).sum(1)
        return {"w": w, "steps": state["steps"] + (budget - prev)}, loss

    se = StatefulEval(init, step)
    x = torch.from_numpy(np.random.default_rng(5).uniform(size=(16, 2)).astype(np.float32))
    plain, s0 = fused_sh_bracket(None, x, (16, 4, 1), (1.0, 3.0, 9.0), stateful=se,
                                 return_final_state=True)
    got, s1 = fused_sh_bracket(None, x, (16, 4, 1), (1.0, 3.0, 9.0), stateful=se,
                               mesh=cpu_mesh(4), return_final_state=True)
    _same_stages([(i.numpy(), l.numpy()) for i, l in got],
                 [(i.numpy(), l.numpy()) for i, l in plain])
    assert torch.equal(s0["w"], s1["w"]) and torch.equal(s0["steps"], s1["steps"])


# -------------------------------------------------------- sharded sweep
def _flat(out):
    return [t for o in out for t in o]


def test_one_shard_mesh_sweep_bitwise_equals_unsharded():
    """Sampled configurations, promotions and losses of the sharded sweep
    on a one-shard mesh equal the plain sweep's bit for bit, on the static
    tier and on the resident tier with the metrics plane."""
    codec = build_space_codec(branin_space(seed=0))
    plan = mesh_aligned_plan(16, 1, 9, 3, 1)
    kw = dict(device="cpu", min_points_in_model=2**30)
    plain = make_fused_sweep_fn(branin, [plan], codec, **kw)(42)
    sharded = make_fused_sweep_fn(branin, [plan], codec, mesh=cpu_mesh(1),
                                  shard_sampling=True, **kw)(42)
    assert all(torch.equal(a, b) for a, b in zip(_flat(plain), _flat(sharded)))
    plans = [mesh_aligned_plan(32, 1, 9, 3, 1)] * 3
    caps = pow2_capacities(plan_additions(plans))
    res = dict(dynamic_counts=True, capacities=caps, resident=True, device_metrics=True, **kw)
    a, ma = make_fused_sweep_fn(branin, plans, codec, **res)(9)
    b, mb = make_fused_sweep_fn(branin, plans, codec, mesh=cpu_mesh(1),
                                shard_sampling=True, **res)(9)
    assert all(torch.equal(x, y) for x, y in zip(
        _flat(unstack_resident_outputs(a, 3)), _flat(unstack_resident_outputs(b, 3))))
    assert all(torch.equal(x, y) for x, y in zip(ma, mb))


def test_two_axis_mesh_non_divisible_bracket_bitwise():
    """A ``("config", "model")`` mesh with a bracket that does not divide
    the config axis (9 rows over 4 shards) equals the unsharded sweep bit
    for bit, every stage index inside the bracket."""
    codec = build_space_codec(branin_space(seed=0))
    plan = BracketPlan((9, 3, 1), (1.0, 3.0, 9.0))
    kw = dict(device="cpu", min_points_in_model=2**30)
    plain = make_fused_sweep_fn(branin, [plan], codec, **kw)(3)[0]
    got = make_fused_sweep_fn(branin, [plan], codec, mesh=config_model_mesh(4, ["cpu"] * 8),
                              **kw)(3)[0]
    assert 0 <= int(got.idx_packed.min()) and int(got.idx_packed.max()) < 9
    assert all(torch.equal(a, b) for a, b in zip(plain, got))


def _ref_sweep(ref, ref_mesh, plans, n_shards, seed, **kw):  # noqa: F811
    rc = ref.sweep.build_space_codec(ref.toys.branin_space(seed=0))
    mesh = ref_mesh.mesh.config_mesh(ref_mesh.devices[:n_shards])
    fn = ref.sweep.make_fused_sweep_fn(
        ref.toys.branin_from_vector, plans, rc, min_points_in_model=2**30, mesh=mesh,
        shard_sampling=True, **kw)
    return rc, fn(np.uint32(seed))


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_sharded_sweep_matches_reference_with_its_draws(ref, ref_mesh, n_shards):  # noqa: F811
    """With the reference's per-shard ``fold_in`` draws injected, the
    port's sharded sweep (HyperBand mode, two brackets) samples the
    reference's stage-0 blocks, promotes its rows exactly and reaches its
    losses."""
    plans = [mesh_aligned_plan(12 * n_shards, 1, 9, 3, n_shards)] * 2
    rc, want = _ref_sweep(ref, ref_mesh, plans, n_shards, 77)
    codec = build_space_codec(branin_space(seed=0))
    got = make_fused_sweep_fn(branin, plans, codec, device="cpu", min_points_in_model=2**30,
                              mesh=cpu_mesh(n_shards), shard_sampling=True)(
        77, draws=ReferenceDraws(ref, rc, 77))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.vectors.numpy(), np.asarray(w.vectors), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(g.idx_packed.numpy(), np.asarray(w.idx_packed))
        np.testing.assert_allclose(g.loss_packed.numpy(), np.asarray(w.loss_packed),
                                   atol=LOSS_ATOL, rtol=LOSS_RTOL)


def test_run_sharded_fused_sweep_matches_reference(ref, ref_mesh, monkeypatch):  # noqa: F811
    """The driver at 256 configurations on 8 shards, the reference's draws
    injected through the sweep's seam: the reference's plan, balance and
    incumbent (vector, bracket, loss)."""
    rc = ref.sweep.build_space_codec(ref.toys.branin_space(seed=0))
    want = ref_mesh.multihost.run_sharded_fused_sweep(
        ref.toys.branin_from_vector, ref.toys.branin_space(seed=0), n_configs=256,
        mesh=ref_mesh.mesh.config_mesh(ref_mesh.devices), seed=4, publish_gauges=False)
    build = tsweep.make_fused_sweep_fn

    def with_reference_draws(*args, **kwargs):
        fn = build(*args, **kwargs)
        return lambda seed, *warm: fn(seed, *warm, draws=ReferenceDraws(ref, rc, seed))

    monkeypatch.setattr(tsweep, "make_fused_sweep_fn", with_reference_draws)
    got = multihost.run_sharded_fused_sweep(
        branin, branin_space(seed=0), n_configs=256, mesh=cpu_mesh(8), seed=4,
        publish_gauges=False)
    for key in ("evaluations", "aligned_stage_counts", "budgets", "n_shards",
                "per_device_configs", "alignment_surplus_rows", "n_brackets"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["incumbent"]["vector"], want["incumbent"]["vector"],
                               atol=1e-6, rtol=0)
    assert got["incumbent"]["bracket"] == want["incumbent"]["bracket"]
    np.testing.assert_allclose(got["incumbent"]["loss"], want["incumbent"]["loss"],
                               atol=LOSS_ATOL, rtol=LOSS_RTOL)


def test_incumbent_matches_full_outputs():
    codec = build_space_codec(branin_space(seed=0))
    plan = mesh_aligned_plan(512, 1, 9, 3, 8)
    kw = dict(device="cpu", min_points_in_model=2**30, mesh=cpu_mesh(8), shard_sampling=True)
    inc = make_fused_sweep_fn(branin, [plan], codec, incumbent_only=True, **kw)(9)
    out = make_fused_sweep_fn(branin, [plan], codec, **kw)(9)[0]
    final = out.loss_packed[-plan.num_configs[-1]:]
    assert float(inc.loss) == float(torch.min(final))
    assert int(inc.bracket) == 0 and tuple(inc.per_bracket_loss.shape) == (1,)


def test_all_crashed_sweep_returns_nan_incumbent():
    codec = build_space_codec(branin_space(seed=0))
    plan = mesh_aligned_plan(64, 1, 9, 3, 8)

    def all_nan(v, budget):
        return v.sum(1) * NAN

    inc = make_fused_sweep_fn(all_nan, [plan], codec, device="cpu", min_points_in_model=2**30,
                              mesh=cpu_mesh(8), shard_sampling=True, incumbent_only=True)(1)
    assert torch.isnan(inc.loss) and int(inc.bracket) == 0


def test_sharded_sampling_validates_its_plans():
    codec = build_space_codec(branin_space(seed=0))
    with pytest.raises(ValueError, match="mesh_aligned_plan"):
        make_fused_sweep_fn(branin, [BracketPlan((9, 3, 1), (1.0, 3.0, 9.0))], codec,
                            device="cpu", mesh=cpu_mesh(4), shard_sampling=True)
    with pytest.raises(ValueError, match="home device"):
        make_fused_sweep_fn(branin, [mesh_aligned_plan(16, 1, 9, 3, 4)], codec,
                            device="meta", mesh=cpu_mesh(4))


# ---------------------------------------------------------------- driver
def test_driver_end_to_end_with_gauges():
    r = multihost.run_sharded_fused_sweep(branin, branin_space(seed=0), n_configs=1024,
                                          mesh=cpu_mesh(8), seed=3)
    assert r["n_shards"] == 8 and np.isfinite(r["incumbent"]["loss"])
    assert r["per_device_configs"] == [sum(r["aligned_stage_counts"]) // 8] * 8
    assert r["balance_skew"] == 0.0
    g = get_metrics().snapshot()["gauges"]
    for s in range(8):
        # keyed by shard: a repeated device still gives every shard a gauge
        assert g[f"sweep.device.{s}.configs"] == float(r["per_device_configs"][s])
        assert g[f"sweep.device.{s}.pad_rows"] == 0.0
    assert g["sweep.balance_skew"] == 0.0
    assert r["h2d_bytes"] == 0 and r["d2h_bytes"] == g["sweep.transfer_bytes.d2h"]


def test_chunked_state_thread_with_model():
    """A chunked run with the KDE on: two chunks of one sweep, the
    observation state carried from chunk to chunk on the device (nothing
    uploaded), a finite incumbent."""
    builds = []
    build = tsweep.make_fused_sweep_fn

    def counted(*args, **kwargs):
        builds.append(kwargs)
        return build(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsweep, "make_fused_sweep_fn", counted)
        r = multihost.run_sharded_fused_sweep(
            branin, branin_space(seed=0), n_configs=64, n_brackets=4, chunk_brackets=2,
            model=True, mesh=cpu_mesh(8), seed=5)
    assert len(r["chunks"]) == 2 and len(builds) == 1
    assert builds[0]["return_state"] and builds[0]["min_points_in_model"] is None
    assert [c["warm_upload_bytes"] for c in r["chunks"]] == [0, 0]
    assert np.isfinite(r["incumbent"]["loss"]) and len(r["per_bracket_loss"]) == 4


def test_resident_host_link_is_flat_in_config_count():
    """``resident=True, device_metrics=True``: the same h2d and d2h bytes
    and host syncs at every size, the decoded telemetry's runs as planned,
    and the incumbent of the unrolled dynamic sweep of the same seed."""
    seen = []
    for n in (2**8, 2**10, 2**12):
        r = multihost.run_sharded_fused_sweep(
            branin, branin_space(seed=0), n_configs=n, n_brackets=3, mesh=cpu_mesh(1),
            resident=True, device_metrics=True, seed=2)
        seen.append((r["h2d_bytes"], r["d2h_bytes"], r["host_syncs"]))
        tel = r["device_telemetry"]
        assert tel["evaluations"] == r["evaluations"] == 3 * sum(r["aligned_stage_counts"])
        unrolled = multihost.run_sharded_fused_sweep(
            branin, branin_space(seed=0), n_configs=n, n_brackets=3, mesh=cpu_mesh(1),
            chunk_brackets=3, device_metrics=True, seed=2)
        assert unrolled["incumbent"] == r["incumbent"]
        assert unrolled["per_bracket_loss"] == r["per_bracket_loss"]
    assert len(set(seen)) == 1 and seen[0][0] == 0 and seen[0][2] > 0


def test_one_build_per_chunk_shape():
    """Repeats of one objective, schedule and mesh build one sweep (the
    process-wide cache), as the reference compiles one program."""
    def fresh(v, budget):
        return torch.square(v - 0.25).sum(1) * budget

    builds = []
    build = tsweep.make_fused_sweep_fn

    def counted(*args, **kwargs):
        builds.append(1)
        return build(*args, **kwargs)

    mesh = cpu_mesh(8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsweep, "make_fused_sweep_fn", counted)
        for s in (0, 1, 2):
            multihost.run_sharded_fused_sweep(fresh, branin_space(seed=0), n_configs=256,
                                              mesh=mesh, seed=s)
    assert len(builds) == 1


def test_publish_device_balance_validates_and_reports_skew():
    mesh = cpu_mesh(4)
    skew = multihost.publish_device_balance(mesh, "config", [10, 10, 10, 5], [0, 0, 0, 5])
    assert skew == pytest.approx(0.5)
    g = get_metrics().snapshot()["gauges"]
    assert g["sweep.balance_skew"] == pytest.approx(0.5)
    assert g["sweep.device.3.configs"] == 5.0 and g["sweep.device.3.pad_rows"] == 5.0
    with pytest.raises(ValueError, match="shard"):
        multihost.publish_device_balance(mesh, "config", [1, 2], [0, 0])


def test_multiprocess_executor_seam():
    """``MultiHostBatchedExecutor.run_sharded_sweep`` drives the driver over
    the backend's (one-process) mesh, and this process is primary."""
    mesh = cpu_mesh(8)
    ex = multihost.MultiHostBatchedExecutor(VmapBackend(branin, mesh=mesh),
                                            branin_space(seed=0))
    r = ex.run_sharded_sweep(n_configs=256, seed=2)
    assert ex.primary and multihost.is_primary_host()
    assert r["n_shards"] == 8 and np.isfinite(r["incumbent"]["loss"])
    assert multihost.initialize_multihost() == 0


# --------------------------------------- FusedBOHB(mesh=): streamed warm
def _runs(res):
    return sorted((r.config_id, r.budget, r.loss) for r in res.get_all_runs())


def _fused(mesh, seed=1, **kw):
    return FusedBOHB(configspace=branin_space(seed=0), eval_fn=branin, run_id="mesh",
                     min_budget=1, max_budget=9, eta=3, seed=seed, mesh=mesh,
                     device=None if mesh is not None else "cpu", **kw)


def test_fused_bohb_takes_the_reference_keywords(ref):  # noqa: F811
    """``mesh`` and ``axis`` follow ``seed`` as in the reference's
    signature."""
    from hpbandster_tpu.optimizers.fused_bohb import FusedBOHB as RefFusedBOHB

    want = list(inspect.signature(RefFusedBOHB).parameters)
    got = list(inspect.signature(FusedBOHB).parameters)
    assert want[want.index("seed"):want.index("seed") + 3] == ["seed", "mesh", "axis"]
    assert got[got.index("seed"):got.index("seed") + 3] == ["seed", "mesh", "axis"]


@pytest.mark.parametrize("chunk_brackets", [None, 2])
def test_fused_bohb_mesh_equals_unmeshed_and_streams_slices(chunk_brackets):
    """A mesh alone places rows: static and chunked runs equal the unmeshed
    run bit for bit. The chunked run streams its warm buffers one shard
    slice at a time (the largest slice ``cap / 8`` rows), then hands the
    device state straight back (nothing uploaded)."""
    opt_m = _fused(cpu_mesh(8))
    res_m = opt_m.run(n_iterations=4, chunk_brackets=chunk_brackets)
    res_p = _fused(None).run(n_iterations=4, chunk_brackets=chunk_brackets)
    assert _runs(res_m) == _runs(res_p)
    if chunk_brackets is None:
        assert "warm_stream_slice_bytes" not in opt_m.run_stats[0]
        return
    uploads = [s["warm_upload_bytes"] for s in opt_m.run_stats]
    assert len(uploads) == 2 and uploads[1] == 0 and uploads[0] > 0
    # 256-slot buffers of 2 dims and a loss: 32 rows per slice
    assert opt_m.run_stats[0]["warm_stream_slice_bytes"] == 32 * (2 + 1) * 4


def test_stream_slices_never_materialize_full_buffers(monkeypatch):
    """Every host allocation of the streamed upload is one shard slice,
    never a full-capacity buffer, and the slices assemble the warm data bit
    for bit."""
    opt = _fused(cpu_mesh(8), seed=2)
    opt._warm_v[9.0] = np.arange(20, dtype=np.float32).reshape(10, 2)
    opt._warm_l[9.0] = np.linspace(0, 1, 10).astype(np.float32)
    slices = []
    real = tfb._warm_slice

    def spy(src, lo, hi, tail, fill):
        slices.append(hi - lo)
        return real(src, lo, hi, tail, fill)

    monkeypatch.setattr(tfb, "_warm_slice", spy)
    caps = {1.0: 256, 9.0: 256}
    assert opt._can_stream_warm(caps) and not opt._can_stream_warm({1.0: 252})
    (warm_v, warm_l, warm_n), nbytes, largest = opt._stream_warm_args(caps, 2)
    assert nbytes == sum(c * 2 * 4 + c * 4 + 4 for c in caps.values())
    assert slices == [32] * 32 and largest == 32 * 12
    v9, l9 = warm_v[9.0].numpy(), warm_l[9.0].numpy()
    assert np.array_equal(v9[:10], opt._warm_v[9.0]) and np.all(v9[10:] == 0)
    assert np.array_equal(l9[:10], opt._warm_l[9.0]) and np.all(np.isinf(l9[10:]))
    assert int(warm_n[9.0]) == 10 and int(warm_n[1.0]) == 0
    assert np.all(warm_v[1.0].numpy() == 0) and np.all(np.isinf(warm_l[1.0].numpy()))


def test_fused_bohb_resident_on_a_mesh_equals_unmeshed():
    """The resident tier and ``run_incumbent`` on a 2-shard mesh equal their
    unmeshed runs."""
    a = _fused(cpu_mesh(2), seed=3)
    b = _fused(None, seed=3)
    assert _runs(a.run(n_iterations=5, resident=True)) == _runs(b.run(n_iterations=5,
                                                                      resident=True))
    assert a.run_incumbent(3)["incumbent"] == b.run_incumbent(3)["incumbent"]


# ------------------------------------------- the Master-driven tier on a mesh
@pytest.mark.parametrize("n_shards", [2, 3])
def test_meshed_batched_bohb_equals_unmeshed(n_shards):
    """``BOHB`` over ``BatchedExecutor(VmapBackend(mesh=))``, bucketed by
    default: the bucket widths pad to the shard count and every run equals
    the unmeshed run bit for bit."""
    def run(mesh):
        cs = branin_space(seed=0)
        ex = BatchedExecutor(VmapBackend(branin, mesh=mesh, device=None if mesh else "cpu"),
                             cs)
        opt = BOHB(configspace=cs, run_id="m", executor=ex, min_budget=1, max_budget=9,
                   eta=3, seed=0, device="cpu")
        res = opt.run(n_iterations=3)
        opt.shutdown()
        return ex, res

    ex_m, res_m = run(cpu_mesh(n_shards))
    ex_p, res_p = run(None)
    assert _runs(res_m) == _runs(res_p)
    assert ex_m.bucketed_brackets_run == ex_p.bucketed_brackets_run > 0
    assert all(w % n_shards == 0 for b in ex_m._bucket_set.buckets for w in b.widths)
    assert ex_m.number_of_workers() == n_shards


def test_vmap_backend_mesh_padding_matches_reference(ref_mesh):  # noqa: F811
    """``VmapBackend(mesh=)`` pads waves as the reference's does (to a power
    of two, then to the mesh's device count; a 2-D mesh's model axis
    replicates), and its losses equal the unmeshed backend's."""
    x = np.random.default_rng(2).uniform(size=(9, 2)).astype(np.float32)
    plain = VmapBackend(branin, device="cpu").evaluate(x, 3.0)
    for mesh, rmesh in ((cpu_mesh(3), ref_mesh.mesh.config_mesh(ref_mesh.devices[:3])),
                        (config_model_mesh(2, ["cpu"] * 4),
                         ref_mesh.mesh.config_model_mesh(2, ref_mesh.devices[:4]))):
        be = VmapBackend(branin, mesh=mesh)
        ref_be = ref_mesh.parallel.VmapBackend(lambda v, b: v[0], mesh=rmesh)
        assert be.parallelism == ref_be.parallelism
        for n in (1, 9, 17):
            assert be._padded_size(n) == ref_be._padded_size(n)
        np.testing.assert_array_equal(be.evaluate(x, 3.0), plain)


def test_batched_worker_auto_mesh_is_one_device_here():
    """``TPUBatchedWorker(mesh="auto")`` on a named device evaluates there
    and reports one device; an explicit mesh reports its size."""
    w = TPUBatchedWorker("auto", branin, configspace=branin_space(seed=0), device="cpu")
    assert w.backend.mesh is None and w._rpc_capabilities() == {"batch": True, "devices": 1}
    w2 = TPUBatchedWorker("mesh", branin, configspace=branin_space(seed=0), mesh=cpu_mesh(2))
    assert w2._rpc_capabilities()["devices"] == 2
