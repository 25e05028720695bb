"""Counting Ones on the port, a space of 16 binary and 16 continuous dims,
held against the benchmark's plain reference (``portbench/reference/``:
``counting_ones.py``, ``mixed_kde.py``) on the CPU at small sizes: the
objective draw for draw, the categorical decode, the mixed model's
bandwidths and scores, and small ``FusedBOHB`` sweeps through the mixed
check (``portbench/harness/fused_mixed.py``), with exact ties in the
losses and with faults planted underneath that the check must catch."""

from __future__ import annotations

import json
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch.obs import get_metrics
from hpbandster_tpu_torch.workloads import toys
from portbench.harness import check, fused_mixed
from portbench.reference import counting_ones as ref_co
from portbench.reference import mixed_kde

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "configs"
                     / "counting_ones_16_16_eta3_b9_729.json").read_text())
DIMS, LIMITS = CONFIG["space"], CONFIG["limits"]
CARDS = fused_mixed.cards_of(DIMS)
#: the cell's BOHB settings at budgets 1..81 (the cell's brackets, each
#: budget a ninth) and 16 candidates a proposal: the model opens on the
#: first bracket's 81 points at budget 1 (d = 32 needs 35), whose losses
#: are whole numbers and tie throughout
SETTINGS = dict(CONFIG["optimizer"], min_budget=1, max_budget=81, num_samples=16)
BRACKETS = 6


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs a process per core, and these
    sweeps' many small ops slow by two orders of magnitude when every
    process spins a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vectors(n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, 2, (n, 16)).astype(np.float32)
    cont = rng.random((n, 16), dtype=np.float32)
    return torch.as_tensor(np.concatenate([cat, cont], axis=1))


def _counters(prefix: str):
    snap = get_metrics().snapshot()["counters"]
    return {k: v for k, v in snap.items() if k.startswith(prefix)}


# ----------------------------------------------------------- the objective
@pytest.mark.parametrize("budget", [9, 729])
def test_the_objective_draws_as_the_reference(budget):
    v = _vectors(300, budget)
    x = v[:, 16:]
    u = toys.counting_ones_uniforms(x, budget)
    assert torch.equal(u.double(), ref_co.uniforms(x, budget))
    ones = (u < x[..., None]).sum(-1).double()
    assert torch.equal(ones, torch.round(ref_co.means(v.double(), budget) * budget))
    ref = ref_co.counting_ones(v.double(), torch.full((300,), float(budget), dtype=torch.float64))
    assert float((toys.counting_ones(v, float(budget)).double() - ref).abs().max()) <= 1e-5
    # a Bernoulli(x) mean: centred on x, with its 1/sqrt(budget) noise
    dev = ones / budget - x.double()
    assert abs(float(dev.mean())) < 3.0 / math.sqrt(300 * 16 * budget)
    assert float(dev.std()) < 1.0 / math.sqrt(budget)


def test_from_vectors_decodes_categoricals_as_from_vector_and_counts():
    cs = toys.counting_ones_space(seed=3)
    m = np.stack([cs.to_vector(c) for c in cs.sample_configuration(50)])
    before = _counters("space.decode_")
    bulk = cs.from_vectors(m)
    after = _counters("space.decode_")
    rows = [cs.from_vector(v) for v in m]
    assert bulk == rows
    for a, b in zip(bulk, rows):
        assert list(a) == list(b) == cs.get_hyperparameter_names()
        assert [type(x) for x in a.values()] == [type(x) for x in b.values()]
    assert {type(bulk[0][f"c{i}"]) for i in range(16)} == {int}
    delta = {k: v - before.get(k, 0) for k, v in after.items()}
    assert delta["space.decode_rows"] == 50
    assert delta["space.decode_values.mapped"] == delta["space.decode_values.numpy"] == 800
    assert delta["space.decode_s"] > 0
    assert _counters("space.decode_") == after  # from_vector counts nothing


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("n_good,n_bad", [(4, 9), (40, 130)])
def test_the_mixed_model_is_the_ports(n_good, n_bad):
    from hpbandster_tpu_torch.ops.cuda_kde import score_candidates_reference
    from hpbandster_tpu_torch.ops.kde import KDE, normal_reference_bandwidths

    good, bad, cands = _vectors(n_good, 1), _vectors(n_bad, 2), _vectors(700, 3)
    cards = torch.tensor(CARDS, dtype=torch.float32)
    vt = (cards > 0).to(torch.float32)  # categorical dims: Aitchison-Aitken
    bws = []
    for data in (good, bad):
        port = normal_reference_bandwidths(data, torch.ones(len(data)), cards, 1e-3)
        ref = mixed_kde.bandwidths(data.double(), CARDS, 1e-3)
        assert torch.allclose(port.double(), ref, rtol=1e-6, atol=0)
        bws.append((port, ref))
    if n_good == 4:
        # four binary rows: a column of two ones reads 0.51 by the
        # Gaussian rule, above its cap of 1/2
        assert float(bws[0][1][:16].max()) == 0.5
    port = score_candidates_reference(cands, KDE(good, torch.ones(n_good), bws[0][0]),
                                      KDE(bad, torch.ones(n_bad), bws[1][0]), vt, cards)
    ref = mixed_kde.scores(cands.double(), good.double(), bad.double(), bws[0][1], bws[1][1],
                           CARDS, block=256)
    assert torch.allclose(port.double(), ref, atol=1e-4, rtol=1e-5)


# ------------------------------------------------------ sweeps and the check
def _tied(v, budget):
    """Losses with exact ties: minus the sum of the binary dims."""
    return -v[:, :16].to(torch.float32).sum(-1)


def _tied_reference(v, budgets):
    return -v[:, :16].sum(-1)


class _TiesReversed:
    """``torch`` for one module, with its stable sorts breaking ties by
    the higher index: the planted fault of a swapped tie."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def sort(x, *args, stable=False, **kw):
        if not (stable and x.dim() == 1 and x.is_floating_point()):
            return torch.sort(x, *args, stable=stable, **kw)
        r = torch.sort(torch.flip(x, [0]), stable=True)
        return types.SimpleNamespace(values=r.values, indices=x.shape[0] - 1 - r.indices)

    @staticmethod
    def argsort(x, *args, stable=False, **kw):
        if not (stable and x.dim() == 1 and x.is_floating_point()):
            return torch.argsort(x, *args, stable=stable, **kw)
        return x.shape[0] - 1 - torch.argsort(torch.flip(x, [0]), stable=True)


def _plant(monkeypatch, fault):
    """Plant ``fault`` underneath a sweep: ``cap`` caps a categorical
    bandwidth at 0.9 of (k - 1) / k, ``tie`` breaks every tie of the
    promotion and the split the other way, ``hash`` changes one bit of a
    multiplier of the objective's draws."""
    from hpbandster_tpu_torch.ops import fused, kde

    if fault == "cap":
        real = kde._discrete_bw_cap
        monkeypatch.setattr(kde, "_discrete_bw_cap", lambda cards: 0.9 * real(cards))
    elif fault == "tie":
        monkeypatch.setattr(fused, "torch", _TiesReversed())
        monkeypatch.setattr(kde, "torch", _TiesReversed())
    elif fault == "hash":
        def mix(h):
            h = h ^ (h >> 16)
            h = (h * 0x7FEB352C) & 0xFFFFFFFF
            h = h ^ (h >> 15)
            h = (h * 0x68E31DA5) & 0xFFFFFFFF
            return h ^ (h >> 16)

        monkeypatch.setattr(toys, "_mix32", mix)


def _sweep_numbers(monkeypatch, eval_fn, ref_fn, seed=11):
    """One small ``FusedBOHB`` sweep (chunks of 2 brackets) and every
    number the cell's check compares, with the scorer's inputs recorded
    as the card's launches record them."""
    from hpbandster_tpu_torch.ops import cuda_kde
    from hpbandster_tpu_torch.ops import sweep as sweep_mod
    from hpbandster_tpu_torch.optimizers import FusedBOHB, fused_bohb

    records = []
    inner = sweep_mod.propose_from_candidates

    def recording(cands, good, bad, vartypes, cards, n):
        records.append((cands, good, bad, vartypes, cards))
        return inner(cands, good, bad, vartypes, cards, n)

    monkeypatch.setattr(sweep_mod, "propose_from_candidates", recording)
    monkeypatch.setattr(cuda_kde, "RECORD", None)
    monkeypatch.setattr(fused_bohb, "_SWEEP_CACHE", type(fused_bohb._SWEEP_CACHE)(maxsize=16))
    opt = FusedBOHB(configspace=toys.counting_ones_space(seed=0), eval_fn=eval_fn,
                    run_id="co", seed=seed, device="cpu", **SETTINGS)
    ex = check.extract(opt.run(n_iterations=BRACKETS, chunk_brackets=2), DIMS)
    assert len(records) == BRACKETS
    numbers = {"loss_gap": check.loss_gap(ex["run_loss"], check.losses(ex, ref_fn))}
    numbers.update(check.schedule_and_promotions(ex, BRACKETS, SETTINGS))
    numbers.update(fused_mixed.fused_model(ex, records, SETTINGS, DIMS))
    picks = sum(bool(i.get("model_based_pick")) for i in ex["info"])
    return numbers, picks


@pytest.mark.parametrize("case,fault", [
    ("program", None), ("ties", None), ("program", "cap"), ("ties", "tie"),
    ("program", "hash")])
def test_a_small_sweep_through_the_mixed_check(case, fault, monkeypatch):
    _plant(monkeypatch, fault)
    if case == "ties":
        numbers, picks = _sweep_numbers(monkeypatch, _tied, _tied_reference)
    else:
        numbers, picks = _sweep_numbers(monkeypatch, toys.counting_ones,
                                        ref_co.counting_ones)
    assert picks > 0  # the model opened and picked
    broken = {k for k, v in numbers.items() if v > LIMITS[k]}
    if fault is None:
        assert not broken, numbers
        assert numbers["kde_bandwidth_gap"] > 0  # float32 against float64: read
    else:
        expected = {"cap": {"kde_bandwidth_gap"},
                    "tie": {"promotion_mismatch", "kde_split_mismatch"},
                    "hash": {"loss_gap"}}[fault]
        assert expected <= broken, numbers


def test_the_twin_differs_where_the_sweep_does():
    ex = {"cids": [(0, 0, 0), (0, 0, 1)], "vec": np.array([[0.0, 0.5], [1.0, np.nan]]),
          "info": [{"model_based_pick": True}, {}], "run_row": np.array([0, 1, 0]),
          "run_budget": np.array([9.0, 9.0, 27.0]), "run_loss": np.array([-3.0, np.nan, -2.5])}
    assert fused_mixed.twin_mismatch(ex, ex) == 0
    for key, change in (("vec", lambda v: v + np.array([[0.0, 1e-7], [0.0, 0.0]])),
                        ("run_loss", lambda l: l + np.array([0.0, 0.0, 1e-7])),
                        ("info", lambda i: [{}, {}])):
        assert fused_mixed.twin_mismatch(ex, dict(ex, **{key: change(ex[key])})) == 1


def test_a_traced_run_of_the_cell_on_the_cpu(monkeypatch):
    """The cell's driver, traced, at the small sweeps' settings:
    correct, the twin equal, the window's decode read by its reader."""
    from hpbandster_tpu_torch.ops import cuda_kde
    from hpbandster_tpu_torch.ops import sweep as sweep_mod
    from hpbandster_tpu_torch.optimizers import fused_bohb
    from portbench.harness import manifest

    inner = sweep_mod.propose_from_candidates

    def recording(cands, good, bad, vartypes, cards, n):
        if isinstance(cuda_kde.RECORD, list):
            cuda_kde.RECORD.append(("kde_score", (cands, good, bad, vartypes, cards)))
        return inner(cands, good, bad, vartypes, cards, n)

    monkeypatch.setattr(sweep_mod, "propose_from_candidates", recording)
    monkeypatch.setattr(cuda_kde, "RECORD", None)
    monkeypatch.setattr(fused_bohb, "_SWEEP_CACHE", type(fused_bohb._SWEEP_CACHE)(maxsize=16))
    spec = manifest.resolve("counting_ones_16_16")
    spec["config_data"]["optimizer"] = dict(SETTINGS)
    spec["traffic"].update(n_iterations=BRACKETS, chunk_brackets=2)
    out = fused_mixed.run(spec, 2**40 + 1, 0.2, True, "cpu")
    judged = check.judge(out["numbers"], LIMITS)
    assert check.passed(judged) and out["failed"] == 0, out["numbers"]
    assert set(judged) == set(LIMITS) and out["numbers"]["twin_mismatch"] == 0
    assert out["attempted"] >= 2 and len(out["ctx"]["kde_launches"]) == BRACKETS
    readers = {m["name"]: manifest.load_reader(m["reader"]) for m in spec["per_layer"]}
    assert set(readers) == {"kde_score_roofline.co16", "decode_us_per_config.co16"}
    # the decode is read from the port's counters; the CPU launches no kernel
    assert readers["decode_us_per_config.co16"](out["ctx"]) > 0
    assert readers["kde_score_roofline.co16"](out["ctx"]) is None


# ------------------------------------------------------- the metric readers
def _load_reader(name):
    from portbench.harness import manifest

    return manifest.load_reader(manifest.BENCH / "metrics" / f"{name}.py")


def test_the_decode_reader_reads_the_windows_counters():
    read = _load_reader("decode_us_per_config.co16")
    ctx = {"tier": "fused", "counters": {"space.decode_rows": 4000, "space.decode_s": 0.06}}
    assert read(ctx) == pytest.approx(15.0)
    # a program without the counters, or a window that decoded nothing
    assert read({"tier": "fused", "counters": {}}) is None
    assert read({"tier": "fused"}) is None
    assert read({"tier": "fused", "counters": {"space.decode_rows": 0, "space.decode_s": 0.0}}) is None
    assert read({"tier": "serve", "counters": ctx["counters"]}) is None


def test_the_roofline_reader_reads_the_32_wide_launches():
    from portbench.harness.roofline import kde_score_least_seconds

    read = _load_reader("kde_score_roofline.co16")
    launches = [{"s": 5184, "d": 32, "n_good": 256, "n_bad": 256, "live_good": 33,
                 "live_bad": 70}] * 2
    kernels = {"void (anonymous namespace)::kde_score_kernel<32>(float const*)":
               {"count": 2, "seconds": 1e-4}}
    ctx = {"kde_launches": launches, "trace": {"kernels": kernels}}
    assert read(ctx) == pytest.approx(100.0 * kde_score_least_seconds(launches) / 1e-4)
    # another width, a launch short, or no trace: nothing
    other = {"void (anonymous namespace)::kde_score_kernel<8>(float const*)":
             {"count": 2, "seconds": 1e-4}}
    assert read(dict(ctx, trace={"kernels": other})) is None
    assert read(dict(ctx, kde_launches=launches * 2)) is None
    assert read({"kde_launches": launches}) is None


# ------------------------------------------------------------ the counters
@pytest.mark.parametrize("d,width", [(6, 8), (16, 16), (32, 32), (40, 0)])
def test_score_launches_count_by_width_at_each_replay(d, width, monkeypatch):
    """A launch counts in ``kde.score_launches.<width>`` when it runs; a
    captured one counts at each replay of its graph and not at the
    capture."""
    from hpbandster_tpu_torch.ops import cuda_kde

    assert cuda_kde.kde_score_geometry(5184, d, 256, 256).dmax == width
    name = f"kde.score_launches.{width}"
    capturing = {"on": False}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing["on"])
    monkeypatch.setattr(cuda_kde, "LAUNCHES", {"kde_score": 0, "kde_moments": 0})
    monkeypatch.setattr(cuda_kde, "CAPTURED", {"kde_score": 0, "kde_moments": 0})
    counter = get_metrics().counter(name)
    n0 = counter.value
    cuda_kde._count_launch("kde_score", (), counter=name)
    assert counter.value == n0 + 1
    capturing["on"] = True
    counters = {}
    with cuda_kde.counting_capture(counters) as rec:
        cuda_kde._count_launch("kde_score", (), counter=name)
        cuda_kde._count_launch("kde_score", (), counter=name)
    capturing["on"] = False
    assert counter.value == n0 + 1
    assert rec == {"kde_score": 2, "kde_moments": 0} and counters == {name: 2}
    for _ in range(3):  # three replays
        cuda_kde.add_launches(rec, counters)
    assert counter.value == n0 + 7
    assert cuda_kde.LAUNCHES == {"kde_score": 7, "kde_moments": 0}
    assert cuda_kde.CAPTURED == {"kde_score": 2, "kde_moments": 0}


def test_the_labelled_counters_export_as_families():
    from hpbandster_tpu_torch.obs.export import metric_family

    assert metric_family("kde.score_launches.32") == (
        "hpbandster_kde_score_launches", {"width": "32"})
    assert metric_family("space.decode_values.mapped") == (
        "hpbandster_space_decode_values", {"branch": "mapped"})
