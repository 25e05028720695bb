"""The one traffic generator and the mixes' drivers: seeded, the same set of gaps and sizes on
every seed, tenants and sizes round robin."""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench.harness import manifest, traffic
from portbench.harness.manifest import BENCH

OPEN = {"driver": "portbench.harness.serve:run", "arrivals": "open", "tenants": 16, "rate_per_s": 25.0, "brackets": [1, 2, 3]}
SEEDS = [0, 7, 2**31 + 12345, 2**40 + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_open_arrivals_are_seeded_and_poisson_gaps(seed):
    a = traffic.open_requests(OPEN, seed, 10.0)
    assert a == traffic.open_requests(OPEN, seed, 10.0)
    assert len(a) == 250
    due = np.array([r.due_s for r in a])
    assert due[0] == 0.0 and np.all(np.diff(due) > 0)
    gaps = np.diff(due)
    # exponential gaps of mean 1/rate: the window is about rate x seconds long
    assert abs(gaps.mean() - 1 / 25.0) < 0.01 and 9.0 < due[-1] < 11.0


def test_every_seed_sends_the_same_gaps_and_sizes_in_another_order():
    runs = [traffic.open_requests(OPEN, s, 10.0) for s in SEEDS]
    gap_sets = [np.sort(np.diff([r.due_s for r in a])) for a in runs]
    orders = [np.diff([r.due_s for r in a]) for a in runs]
    for g in gap_sets[1:]:
        # one gap (the first request's, at 0) differs at most
        assert np.isin(np.round(g, 12), np.round(gap_sets[0], 12)).sum() >= len(g) - 1
    assert not np.allclose(orders[0], orders[1])
    sizes = [sorted(r.brackets for r in a) for a in runs]
    assert all(s == sizes[0] for s in sizes)


def test_tenants_and_sizes_round_robin():
    a = traffic.open_requests(OPEN, 3, 4.0)
    assert [r.tenant for r in a[:18]] == [f"t{i % 16}" for i in range(18)]
    assert [r.brackets for r in a[:6]] == [1, 2, 3, 1, 2, 3]
    assert len({r.seed for r in a}) == len(a) and all(0 <= r.seed < 2**31 for r in a)


def test_closed_requests_are_one_tenants_in_turn():
    c = json.loads((BENCH / "traffic" / "tenant_closed.json").read_text())
    reqs = traffic.closed_requests(c, 2**33, 7)
    assert [r.tenant for r in reqs] == ["t0"] * 7
    assert [r.brackets for r in reqs] == [1, 2, 3, 1, 2, 3, 1]
    assert reqs == traffic.closed_requests(c, 2**33, 7)
    assert reqs != traffic.closed_requests(c, 2**33 + 1, 7)


def test_sweep_seeds_apart_by_stream_and_seed():
    a, b = traffic.sweep_seeds(5, 50), traffic.sweep_seeds(5, 50, stream=0)
    assert a == traffic.sweep_seeds(5, 50) and not set(a) & set(b)
    assert traffic.sweep_seeds(2**40 + 5, 3) != traffic.sweep_seeds(5, 3)


@pytest.mark.parametrize("name", ["fused_sweep_closed_bohb", "fused_sweep_closed_hyperband",
                                  "tenants_open_poisson", "tenant_closed"])
def test_committed_mixes_name_a_driver_that_loads(name):
    mix = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    assert callable(manifest.load_driver({"traffic": mix}))


def test_unknown_arrivals_are_refused():
    from portbench.harness import serve

    with pytest.raises(ValueError):
        serve.run({"config_data": {}, "traffic": dict(OPEN, arrivals="replay_trace")},
                  1, 1.0, False, "cpu")
