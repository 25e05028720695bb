"""The device metrics plane against the reference: the port's copy of the
bin schema and its helpers, ``stage_telemetry``, the decoder, and the
``DeviceMetrics`` and incumbent-only outputs of whole sweeps.

Tolerances: the schema, the helpers, ``stage_telemetry`` and the decoded
JSON are exact (byte-identical); a sweep's integer metric leaves are exact
on the reference's draws, its float leaves (best final losses, the
incumbent's loss and per-bracket bests) within the sweep parity's
``LOSS_TOL`` and the incumbent's vector within ``1e-6``
(``tests/test_torch_sweep.py``).
"""

import json
import math

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch import FusedBOHB
from hpbandster_tpu_torch.obs import device_metrics as tdm
from hpbandster_tpu_torch.ops.fused import stage_telemetry
from hpbandster_tpu_torch.ops.sweep import (
    DeviceMetrics,
    make_fused_sweep_fn,
    plan_additions,
    pow2_capacities,
)
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_harness import ReferenceDraws, codecs, plans_for, ref  # noqa: F401
from tests.test_torch_sweep import LOSS_TOL, NUM_SAMPLES


def _losses(seed, n=300):
    """Seeded losses across the bins, with NaN, +/-inf, zeros, negatives and
    values equal to bin edges."""
    rng = np.random.default_rng(seed)
    edges = tdm.bin_edges().astype(np.float32)
    x = (10.0 ** rng.uniform(-8, 8, size=n)).astype(np.float32)
    x[rng.uniform(size=n) < 0.2] *= -1
    special = [np.nan, np.inf, -np.inf, 0.0, np.nan, *edges[rng.integers(0, len(edges), 6)]]
    x[rng.choice(n, len(special), replace=False)] = special
    return x


def test_schema_and_helpers_match_reference(ref, monkeypatch):
    r = ref.device_metrics
    assert (tdm.N_BINS, tdm.LOG10_LO, tdm.LOG10_HI, tdm.SCHEMA_VERSION) == (
        r.N_BINS, r.LOG10_LO, r.LOG10_HI, r.SCHEMA_VERSION)
    np.testing.assert_array_equal(tdm.bin_edges(), r.bin_edges())
    x = _losses(0)
    np.testing.assert_array_equal(tdm.bin_index_np(x), r.bin_index_np(x))
    rng = np.random.default_rng(1)
    for hist in ([0] * tdm.N_BINS, rng.integers(0, 5, tdm.N_BINS).tolist(),
                 [0] * (tdm.N_BINS - 1) + [4]):
        for q in (0.0, 0.5, 0.95, 1.0):
            assert tdm.hist_quantile(hist, q) == r.hist_quantile(hist, q)
    for v in (1, 2.5, True, None, "x", math.nan, math.inf, -math.inf, -3):
        assert tdm.finite_or_none(v) == r.finite_or_none(v)
    rungs = [[{"budget": 1.0, "evals": 9, "crashes": 1, "promotions": 3,
               "hist": rng.integers(0, 3, tdm.N_BINS).tolist()}],
             [{"budget": 1.0, "evals": 4, "crashes": 0, "promotions": 1,
               "hist": rng.integers(0, 3, tdm.N_BINS).tolist()},
              {"budget": 3.0, "evals": 3, "crashes": 2, "promotions": 0,
               "hist": [1] * tdm.N_BINS}]]
    assert json.dumps(tdm.merge_rungs(rungs)) == json.dumps(r.merge_rungs(rungs))
    for env in ("1", "0", ""):
        monkeypatch.setenv("HPB_DEVICE_METRICS", env)
        assert tdm.device_metrics_default() == r.device_metrics_default()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stage_telemetry_matches_reference(ref, seed):
    """Histogram and crash count exactly the reference's: NaN counted as a
    crash, +/-inf in the end bins, a loss equal to an edge in that edge's
    bin."""
    import jax.numpy as jnp

    x = _losses(seed, n=50 + 100 * seed)
    edges = tdm.bin_edges().astype(np.float32)
    hist, crashes = stage_telemetry(torch.from_numpy(x), torch.from_numpy(edges))
    want_h, want_c = ref.fused.stage_telemetry(jnp.asarray(x), edges)
    assert hist.dtype == torch.int32 and crashes.dtype == torch.int32
    np.testing.assert_array_equal(hist.numpy(), np.asarray(want_h))
    assert int(crashes) == int(want_c) == int(np.isnan(x).sum())
    np.testing.assert_array_equal(
        hist.numpy(), np.bincount(tdm.bin_index_np(x[~np.isnan(x)]), minlength=tdm.N_BINS))


def _crashy_port(v, budget):
    return torch.where(v[:, 0] < 0.2, torch.full_like(v[:, 0], math.nan), branin(v, budget))


def _crashy_ref(ref):
    import jax.numpy as jnp

    def fn(v, budget):
        return jnp.where(v[0] < 0.2, jnp.nan, ref.toys.branin_from_vector(v, budget))

    return fn


def _tier_kw(tier, plans):
    if tier == "static":
        return {}
    kw = dict(dynamic_counts=True, capacities=pow2_capacities(plan_additions(plans)))
    return dict(kw, resident=True) if tier == "resident" else kw


@pytest.mark.parametrize("tier", ["static", "dynamic", "resident"])
def test_metrics_and_incumbent_match_reference(ref, monkeypatch, tier):
    """On the reference's draws, with crashes: the ``DeviceMetrics`` leaves
    (integer ones exact) and the incumbent-only payload of a sweep equal
    the reference's, on the static, dynamic and resident tiers."""
    monkeypatch.delenv("HPB_PALLAS_KDE_FIT", raising=False)
    rc, codec = codecs(ref, "branin")
    plans = plans_for(7, max_budget=9.0)
    seed = 1234
    kw = dict(num_samples=NUM_SAMPLES, incumbent_only=True, device_metrics=True,
              **_tier_kw(tier, plans))
    want_inc, want_dm = ref.sweep.make_fused_sweep_fn(
        _crashy_ref(ref), plans, rc, use_pallas=True, pallas_interpret=True, **kw
    )(np.uint32(seed))
    inc, dm = make_fused_sweep_fn(_crashy_port, plans, codec, device="cpu", **kw)(
        seed, draws=ReferenceDraws(ref, rc, seed))
    assert isinstance(dm, DeviceMetrics) and dm._fields == want_dm._fields
    for name in ("loss_hist", "evals", "crashes", "promotions", "model_fits", "rung_seq"):
        got, want = getattr(dm, name), np.asarray(getattr(want_dm, name))
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert int(dm.crashes.sum()) > 0 and int(dm.model_fits.sum()) > 0
    np.testing.assert_allclose(dm.best_final.numpy(), np.asarray(want_dm.best_final),
                               rtol=LOSS_TOL["branin"], atol=LOSS_TOL["branin"])
    np.testing.assert_allclose(inc.vector.numpy(), np.asarray(want_inc.vector), rtol=0, atol=1e-6)
    assert int(inc.bracket) == int(want_inc.bracket)
    for got, want in ((inc.loss, want_inc.loss), (inc.per_bracket_loss, want_inc.per_bracket_loss)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LOSS_TOL["branin"], atol=LOSS_TOL["branin"])


def test_decode_is_byte_identical_to_reference(ref):
    """The port's and the reference's decodes of the same fetched metrics
    give byte-identical JSON: one part with its plans, with and without
    ``execute_s``, and two chunks' parts together."""
    rc, codec = codecs(ref, "branin")
    plans = plans_for(6, max_budget=9.0)
    _, dm = make_fused_sweep_fn(_crashy_port, plans, codec, device="cpu", num_samples=8,
                                device_metrics=True)(3)
    dm = DeviceMetrics(*(t.numpy() for t in dm))
    half = [DeviceMetrics(*(leaf[:3] for leaf in dm)), DeviceMetrics(*(leaf[3:] for leaf in dm))]
    cases = [((dm,), dict(plans=plans)), ((dm,), dict(plans=plans, execute_s=1.25)),
             (([(half[0], plans[:3]), (half[1], plans[3:])],), dict(execute_s=0.5))]
    for args, kw in cases:
        mine = json.dumps(tdm.decode_device_metrics(*args, **kw))
        theirs = json.dumps(ref.device_metrics.decode_device_metrics(*args, **kw))
        assert mine == theirs
    rec = tdm.decode_device_metrics(dm, plans=plans)
    assert rec["crashes"] > 0 and rec["evaluations"] == sum(sum(p.num_configs) for p in plans)
    with pytest.raises(ValueError, match="brackets"):
        tdm.decode_device_metrics(dm, plans=plans[:2])


@pytest.mark.parametrize("chunk_brackets", [None, 2])
def test_optimizer_decodes_every_chunk(monkeypatch, chunk_brackets):
    """``FusedBOHB.run(device_metrics=...)`` decodes all chunks into one
    record that agrees with the ``Result`` (evaluations and crashes per
    budget); ``HPB_DEVICE_METRICS=1`` is the default's switch."""
    def make():
        return FusedBOHB(configspace=branin_space(seed=0), eval_fn=_crashy_port, min_budget=1,
                         max_budget=9, eta=3, seed=2, num_samples=8, device="cpu")

    monkeypatch.setenv("HPB_DEVICE_METRICS", "1")
    opt = make()
    res = opt.run(n_iterations=5, chunk_brackets=chunk_brackets)
    rec = opt.last_device_telemetry
    runs = res.get_all_runs()
    assert rec["brackets"] == 5 and rec["evaluations"] == len(runs)
    assert rec["crashes"] == sum(r.loss is None for r in runs) > 0
    for rung in rec["rungs"]:
        mine = [r for r in runs if r.budget == rung["budget"]]
        assert rung["evals"] == len(mine)
        assert rung["crashes"] == sum(r.loss is None for r in mine)
    assert rec["execute_s"] == round(sum(s["execute_fetch_s"] for s in opt.run_stats), 6)
    monkeypatch.setenv("HPB_DEVICE_METRICS", "0")
    off = make()
    off.run(n_iterations=2, chunk_brackets=chunk_brackets)
    assert off.last_device_telemetry is None
