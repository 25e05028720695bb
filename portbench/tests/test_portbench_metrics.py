"""Each per-layer reader on synthetic run statistics, gauges, histograms
and profiler rows; the trace reduction on synthetic intervals; the
roofline's yardstick."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.harness import manifest, roofline, trace

#: every reader under metrics/, whether or not a committed cell lists it
READERS = {path.name[:-3]: manifest.load_reader(path)
           for path in sorted((manifest.BENCH / "metrics").glob("*.py"))}


def _trace(busy_s=0.25, window_s=1.0, kernels=None):
    return {"busy_s": busy_s, "window_s": window_s, "kernels": kernels or {},
            "device_ops": [], "idle_gaps": []}


def test_replay_share():
    read = READERS["replay_share.sweep"]
    assert read({"tier": "fused", "window_s": 4.0, "replay_s": 1.0}) == pytest.approx(25.0)
    assert read({"tier": "serve", "window_s": 4.0}) is None


def test_host_syncs_per_bracket():
    read = READERS["host_syncs_per_bracket.sweep"]
    ctx = {"tier": "fused", "sweeps": [{"host_syncs": 9.0, "brackets": 36},
                                       {"host_syncs": 18.0, "brackets": 36}]}
    assert read(ctx) == pytest.approx(0.375)
    assert read({"tier": "fused", "sweeps": [{"host_syncs": None, "brackets": 36}]}) is None


LAUNCH = {"s": 46656, "d": 6, "n_good": 4096, "n_bad": 4096, "live_good": 300, "live_bad": 1700}


def test_kde_score_roofline_reads_the_live_rows_and_the_kernel_time():
    least = roofline.kde_score_least_seconds([LAUNCH, LAUNCH])
    flops = 46656 * 2000 * 27
    assert least == pytest.approx(2 * flops / roofline.F32_FLOPS)
    ctx = {"kde_launches": [LAUNCH, LAUNCH],
           "trace": _trace(kernels={"void kde_score_kernel<8>(float const*)": {
               "count": 2, "seconds": 10 * least}, "elementwise": {"count": 9, "seconds": 1.0}})}
    assert READERS["kde_score_roofline"](ctx) == pytest.approx(10.0)


def test_kde_score_roofline_says_nothing_on_a_trace_without_those_launches():
    read = READERS["kde_score_roofline"]
    ctx = {"kde_launches": [LAUNCH], "trace": _trace(kernels={"kde_score_kernel": {
        "count": 2, "seconds": 1.0}})}
    assert read(ctx) is None
    assert read({"kde_launches": [LAUNCH], "trace": _trace()}) is None
    assert read({"trace": _trace()}) is None


def test_roofline_cost_is_the_ports_formula():
    from hpbandster_tpu_torch.ops.cuda_kde import kde_score_cost

    for shape in [(5184, 6, 1024, 1024, 13, 76), (46656, 6, 4096, 4096, 500, 3000),
                  (8192, 6, 64, 64, 7, 29)]:
        port = kde_score_cost(*shape)
        mine = roofline.kde_score_cost(*shape)
        assert (mine.flops, mine.bytes_accessed) == (port.flops, port.bytes_accessed)


@pytest.mark.parametrize("name,tier", [("device_idle_share.sweep", "fused"),
                                       ("device_idle_share.serve", "serve")])
def test_idle_shares(name, tier):
    assert READERS[name]({"tier": tier, "trace": _trace(0.25, 1.0)}) == pytest.approx(75.0)
    other = "serve" if tier == "fused" else "fused"
    assert READERS[name]({"tier": other, "trace": _trace()}) is None


def test_queue_wait_p95_interpolates_inside_its_bucket():
    read = READERS["queue_wait_p95_ms.serve"]
    buckets = {"0.001": 0, "0.005": 50, "0.01": 30, "0.05": 20, "0.1": 0, "+inf": 0}
    # 95 of 100 lies 15/20 of the way through (0.01, 0.05]
    assert read({"tier": "serve", "queue_wait_buckets": buckets}) == pytest.approx(40.0)
    assert read({"tier": "serve", "queue_wait_buckets": {"0.001": 0, "+inf": 3}}) is None
    assert read({"tier": "serve", "queue_wait_buckets": {"0.001": 0, "+inf": 0}}) is None
    assert read({"tier": "serve", "queue_wait_buckets": None}) is None


@pytest.mark.parametrize("waits_ms", [(12.0, 14.0), (21.0, 24.0), (38.0, 41.5)])
def test_queue_wait_p95_reads_the_waits_not_the_bucket_layout(waits_ms):
    """With the serving driver's buckets, waits anywhere in 10-50 ms read
    as themselves (the registry's default buckets read 48.0 for all)."""
    from hpbandster_tpu_torch.obs.metrics import MetricsRegistry
    from portbench.harness import serve

    reg = MetricsRegistry()
    h = reg.histogram("serve.queue_wait_s", serve.WAIT_BUCKETS)
    waits = np.linspace(waits_ms[0], waits_ms[1], 400) / 1000
    for w in waits:
        h.observe(w)
    buckets = reg.snapshot()["histograms"]["serve.queue_wait_s"]["buckets"]
    got = READERS["queue_wait_p95_ms.serve"]({"tier": "serve", "queue_wait_buckets": buckets})
    assert got == pytest.approx(1000 * np.percentile(waits, 95), abs=0.1)


def test_packed_bracket_share():
    read = READERS["packed_bracket_share.serve"]
    assert read({"tier": "serve", "dispatches": {"packed_brackets": 30,
                                                 "solo_brackets": 10}}) == pytest.approx(75.0)
    assert read({"tier": "serve", "dispatches": {"packed_brackets": 0,
                                                 "solo_brackets": 0}}) is None


def test_trace_reduction_unions_busy_time_and_names_gaps_by_span():
    device = [(0.0, 100.0, "a"), (50.0, 150.0, "b"), (400.0, 500.0, "a"), (900.0, 1000.0, "a")]
    spans = [(0.0, 1000.0, "sweep"), (600.0, 950.0, "replay")]
    r = trace.reduce_intervals(device, spans, window_s=0.001)
    assert r["busy_s"] == pytest.approx(350e-6)
    assert r["kernels"]["a"] == {"count": 3, "seconds": pytest.approx(300e-6)}
    assert r["device_ops"][0][0] == "a"
    assert r["idle_gaps"] == [["replay", pytest.approx(400e-6)], ["sweep", pytest.approx(250e-6)]]
    assert trace.kernel_seconds(r, "b") == (1, pytest.approx(100e-6))


def test_request_p95_is_end_to_end_over_every_request():
    from portbench import run

    lat = list(np.linspace(0.01, 0.2, 100))
    spec = manifest.resolve("serve1_h6_b9_closed")
    out = {"t0": 0.0, "t1": 10.0, "setup_s": 5.0, "evals": 1000, "latency_s": lat}
    line = run.metrics_line(spec, out, False, {})
    assert line["request_p95_ms"]["value"] == pytest.approx(1000 * np.percentile(lat, 95))
    assert line["evals_per_s"]["value"] == pytest.approx(100.0)
    # a cell that lists neither reports set-up alone
    fused_spec = manifest.resolve("h6_b729_hyperband")
    assert set(run.metrics_line(fused_spec, out, False, {})) == {"setup_s", "evals_per_s"}


def test_every_listed_metric_has_its_reader():
    for m in manifest.load_manifest()["per_layer"]:
        assert m["name"] in READERS
