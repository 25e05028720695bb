"""The plain reference against the port on the CPU at small sizes, the
check end to end on the CPU (correct), the control (not correct), and the
faults a cell can have, planted underneath a run (not correct)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import control, run
from portbench.harness import check, manifest, serve
from portbench.reference import hyperband, kde
from portbench.reference.hartmann6 import hartmann6


def test_hartmann6_is_the_ports_objective():
    from hpbandster_tpu_torch.workloads.toys import hartmann6 as port

    x = torch.rand((500, 6), generator=torch.Generator().manual_seed(0))
    for budget in (1.0, 27.0, 729.0):
        ref = hartmann6(x.double(), torch.full((500,), budget, dtype=torch.float64))
        assert torch.allclose(port(x, budget).double(), ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("lo,hi", [(1, 729), (1, 9), (1, 27), (0.1, 8.1)])
def test_schedule_is_the_ports(lo, hi):
    from hpbandster_tpu_torch.ops.bracket import hyperband_bracket

    for i in range(20):
        plan = hyperband_bracket(i, lo, hi, 3)
        assert hyperband.bracket(i, lo, hi, 3) == (tuple(plan.num_configs), tuple(plan.budgets))
    if (lo, hi) == (1, 729):
        assert hyperband.total_evaluations(range(36), lo, hi, 3) == 10123


def test_bandwidths_and_scores_are_the_ports():
    from hpbandster_tpu_torch.ops.cuda_kde import score_candidates_reference
    from hpbandster_tpu_torch.ops.kde import KDE, normal_reference_bandwidths

    g = torch.Generator().manual_seed(1)
    good, bad = torch.rand((20, 6), generator=g), torch.rand((90, 6), generator=g)
    cands = torch.rand((300, 6), generator=g)
    cards, vt = torch.zeros(6), torch.zeros(6)
    bw_g = normal_reference_bandwidths(good, torch.ones(20), cards, 1e-3)
    bw_b = normal_reference_bandwidths(bad, torch.ones(90), cards, 1e-3)
    ref_g = kde.bandwidths(good.double(), 1e-3)
    assert torch.allclose(bw_g.double(), ref_g, rtol=1e-6)
    port = score_candidates_reference(cands, KDE(good, torch.ones(20), bw_g),
                                      KDE(bad, torch.ones(90), bw_b), vt, cards)
    ref = kde.scores(cands.double(), good.double(), bad.double(), ref_g,
                     kde.bandwidths(bad.double(), 1e-3), block=64)
    assert torch.allclose(port.double(), ref, atol=1e-4, rtol=1e-5)


def test_split_is_the_ports_masked_fit():
    from hpbandster_tpu_torch.ops.kde import fit_kde_pair_masked

    rng = np.random.default_rng(3)
    n, cap = 57, 128
    v, l = rng.random((n, 6)).astype(np.float32), rng.random(n).astype(np.float32)
    n_good, n_bad = kde.split_sizes(n, 6, 7, 15)
    buf_v, buf_l = np.zeros((cap, 6), np.float32), np.full(cap, np.inf, np.float32)
    buf_v[:n], buf_l[:n] = v, l
    good, bad = fit_kde_pair_masked(torch.tensor(buf_v), torch.tensor(buf_l), torch.tensor(n),
                                    torch.tensor(n_good), torch.tensor(n_bad), torch.zeros(6), 1e-3)
    rg, rb = kde.split(v, l, 6, 7, 15)
    assert sorted(map(bytes, good.data[good.mask > 0].numpy())) == sorted(map(bytes, rg))
    assert sorted(map(bytes, bad.data[bad.mask > 0].numpy())) == sorted(map(bytes, rb))
    assert kde.split_sizes(8, 6, 7, 15) is None and kde.model_budget({1.0: 9, 3.0: 8}, 6, 7, 15) == 1.0


def test_promotion_is_top_k_with_crashes_last():
    assert hyperband.promoted({0: 3.0, 1: float("nan"), 2: 1.0, 3: 2.0}, 2) == {2, 3}
    assert hyperband.promoted({0: float("nan"), 1: 5.0}, 2) == {0, 1}


# ------------------------------------------------------------ end to end
def _run(name, seconds=1.5, device="cpu", trace=False):
    spec = manifest.resolve(name)
    out = manifest.load_driver(spec)(spec, 2**33 + 17, seconds, trace, device)
    judged = check.judge(out["numbers"], spec["config_data"]["limits"])
    return spec, out, check.passed(judged) and out["failed"] == 0


CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_is_correct_on_the_cpu(cell, small, recorded_scorer):
    spec, out, ok = _run(cell)
    assert ok, out["numbers"]
    assert out["attempted"] >= 1 and out["evals"] > 0


def test_the_open_loop_is_correct_on_the_cpu(small):
    """The open-loop mix that no committed cell runs yet (PERF.md, Open
    questions) still drives the serving driver to a correct end."""
    spec = manifest.resolve("serve1_h6_b9_closed")
    spec["traffic"] = dict(manifest.load_traffic("tenants_open_poisson"), rate_per_s=10.0)
    out = manifest.load_driver(spec)(spec, 2**33 + 17, 1.5, False, "cpu")
    judged = check.judge(out["numbers"], spec["config_data"]["limits"])
    assert check.passed(judged) and out["failed"] == 0, out["numbers"]
    assert out["attempted"] == 15 and out["evals"] > 0


def test_the_knee_sweep_prints_a_line_per_rate(capsys):
    from portbench import knee

    rc = knee.main(["--workload", "serve1_h6_b9_closed", "--traffic", "tenants_open_poisson",
                    "--rates", "4", "--seconds", "1"], device="cpu")
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["rate_per_s"] == 4.0 and line["requests"] == 4 and line["failed"] == 0


def test_a_traced_serving_run_reads_its_queue_wait(small, capsys):
    rc = run.main(["--workload", "serve1_h6_b9_closed", "--seed", str(2**34 + 5),
                   "--seconds", "1", "--trace", "1"], device="cpu")
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert {"queue_wait_p95_ms.serve", "device_idle_share.serve"} <= set(line["metrics"])
    # read from 0.1 ms buckets: no bucket edge decides it
    assert line["metrics"]["queue_wait_p95_ms.serve"]["value"] not in (10.0, 48.0, 50.0)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, small, recorded_scorer):
    spec, out, _ = _run(cell, seconds=1.0)
    numbers = control.control_numbers(spec, out["control_inputs"])
    limits = spec["config_data"]["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers


def _faults(monkeypatch, kind, fault):
    """Plant ``fault`` underneath the run: ``answer`` alters one loss where
    the objective produces it, ``half`` evaluates half of each batch and
    gives the rest their mean, ``state`` leaves a step's state unchanged."""
    from hpbandster_tpu_torch.workloads import toys

    inner = toys.hartmann6
    if fault == "answer":
        def broken(v, budget):
            out = inner(v, budget)
            return torch.cat([out[:1] + 0.01, out[1:]])
    elif fault == "half":
        def broken(v, budget):
            out = inner(v, budget)
            h = max(out.shape[0] // 2, 1)
            return torch.cat([out[:h], out[:h].mean().expand(out.shape[0] - h)])
    if fault in ("answer", "half"):
        monkeypatch.setattr(toys, "hartmann6", broken)
        return
    if kind == "fused":
        from hpbandster_tpu_torch.optimizers import fused_bohb

        # the observations of a finished chunk never reach the next one
        monkeypatch.setattr(fused_bohb.FusedBOHB, "_accumulate_obs", lambda *a, **k: None)
    else:
        from hpbandster_tpu_torch.serve import pool

        last = {}

        def stale(self, job, loss):
            # the facade hands each job the loss it last delivered
            prev = last.get(id(self), loss)
            last[id(self)] = loss
            return stale.inner(self, job, prev)

        stale.inner = pool._TenantExecutor._finish
        monkeypatch.setattr(pool._TenantExecutor, "_finish", stale)


@pytest.mark.parametrize("cell", ["h6_b729_bohb", "serve1_h6_b9_closed"])
@pytest.mark.parametrize("fault", ["answer", "half", "state"])
def test_a_run_with_a_fault_underneath_is_not_correct(cell, fault, small, recorded_scorer,
                                                      monkeypatch):
    from hpbandster_tpu_torch.optimizers import fused_bohb
    from hpbandster_tpu_torch.ops import buckets

    # no built program of an earlier test may serve the broken objective
    monkeypatch.setattr(fused_bohb, "_SWEEP_CACHE", type(fused_bohb._SWEEP_CACHE)(maxsize=16))
    monkeypatch.setattr(buckets, "_BUCKET_FN_CACHE", {})
    # a one-second window on the CPU serves a handful of requests: read all
    monkeypatch.setattr(serve, "KEEP_P", 1.0)
    _faults(monkeypatch, "fused" if cell.startswith("h6") else "serve", fault)
    spec, out, ok = _run(cell, seconds=1.0)
    assert not ok, out["numbers"]


def test_main_prints_the_contracts_line(small, recorded_scorer, capsys):
    rc = run.main(["--workload", "h6_b729_hyperband", "--seed", str(2**35), "--seconds", "1",
                   "--trace", "1"], device="cpu")
    assert rc == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert {"replay_share.sweep", "host_syncs_per_bracket.sweep"} <= set(line["metrics"])
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert err.strip().splitlines()[-1].startswith("check ")
