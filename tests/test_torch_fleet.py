"""The exporter, the health endpoint and the fleet collector
(``hpbandster_tpu_torch.obs.export``, ``obs.health``, ``obs.collector``),
held against the reference's.

Registries and health snapshots filled from a seed with numpy go through
both packages' ``render_registry`` / ``parse_prometheus_text`` and the
collector's ``_endpoint_row`` / ``derive_fleet`` / ``tenant_counters`` /
``lane_gauges`` / ``slo_gauges`` / ``format_fleet_table``, which must be
equal (text byte for byte). An ``ExporterServer`` on 127.0.0.1 serves the
registry over HTTP, and a ``FleetCollector`` polls health snapshots
through an injected fetcher. Over the RPC transport a registered
``HealthEndpoint`` answers ``obs_snapshot`` / ``metrics_text``, the
exporter's ``snapshot_fetcher`` bridges it, and a collector without
``fetch=`` polls it (servers on port 0, every call with a timeout).
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.obs import collector, export, health
from hpbandster_tpu_torch.obs.__main__ import run_export
from hpbandster_tpu_torch.obs.events import EventBus
from hpbandster_tpu_torch.obs.journal import RingBuffer
from hpbandster_tpu_torch.obs.metrics import MetricsRegistry
from tests.test_torch_harness import ref, ref_obs_all  # noqa: F401

SEEDS = [0, 1, 2]


def fill_registry(reg, seed, tenants=("t0", "t1")):
    """Counters, gauges and histograms the way the port's layers name
    them, with values from ``seed``."""
    rng = np.random.default_rng(seed)
    for name in ("master.jobs_finished", "runtime.compiles", "dispatcher.workers_dropped",
                 "serve.continuous.joins", "anomaly.alerts"):
        reg.counter(name).inc(int(rng.integers(0, 50)))
    for t in tenants:
        reg.counter(f"serve.tenant.{t}.configs_done").inc(int(rng.integers(1, 100)))
    gauges = {
        "sweep.transfer_bytes.h2d": float(rng.integers(1000, 10 ** 6)),
        "sweep.transfer_bytes.d2h": float(rng.integers(1000, 10 ** 5)),
        "sweep.host_syncs": float(rng.integers(1, 40)),
        "serve.lanes.total": 8.0, "serve.lanes.occupied": float(rng.integers(0, 9)),
        "serve.lanes.starved": 0.0, "serve.lane_occupancy": round(float(rng.random()), 4),
        "serve.family.0.warm_age_s": round(float(rng.uniform(0, 60)), 3),
        "serve.family.1.warm_age_s": round(float(rng.uniform(0, 60)), 3),
        "slo.serve_admission.burn_rate": round(float(rng.uniform(0, 20)), 4),
        "slo.serve_admission.state": float(rng.integers(0, 4)),
        "slo.lane_starvation.burn_rate": 0.0, "slo.lane_starvation.state": 0.0,
        "dispatcher.workers_alive": float(rng.integers(1, 5)),
        "dispatcher.queue_depth": float(rng.integers(0, 20)),
        "sweep.device.0.configs": float(rng.integers(10, 100)),
        "sweep.device.1.configs": float(rng.integers(10, 100)),
        "sweep.device_metrics.evaluations": float(rng.integers(10, 400)),
        "sweep.device_metrics.crashes": float(rng.integers(0, 5)),
        "weird name/with:chars": -1.5,
    }
    for name, value in gauges.items():
        reg.gauge(name).set(value)
    for name in ("master.job_run_s.b1", "serve.queue_wait_s"):
        h = reg.histogram(name)
        for v in rng.exponential(0.05, size=int(rng.integers(5, 40))):
            h.observe(float(v))
    return reg


@pytest.mark.parametrize("seed", SEEDS)
def test_exposition_equals_the_reference(ref_obs_all, seed):
    mine = fill_registry(MetricsRegistry(), seed)
    theirs = fill_registry(ref_obs_all.metrics.MetricsRegistry(), seed)
    text = export.render_registry(mine)
    assert text == ref_obs_all.export.render_registry(theirs)
    assert export.render_snapshot(mine.snapshot()) == text
    parsed = export.parse_prometheus_text(text)
    assert parsed == ref_obs_all.export.parse_prometheus_text(text)
    assert {d for d, _ in [(s[0].get("direction"), s[1]) for s in parsed["hpbandster_sweep_transfer_bytes"]["samples"]]} == {"h2d", "d2h"}


def test_malformed_exposition_is_refused(ref_obs_all):
    for bad in ("metric{a=\"1\" 2\n", "# TYPE x unknown_type\nx 1\n", "x one\n"):
        with pytest.raises(ValueError):
            export.parse_prometheus_text(bad)
        with pytest.raises(ValueError):
            ref_obs_all.export.parse_prometheus_text(bad)


def test_exporter_serves_the_registry_on_localhost(capsys):
    reg = fill_registry(MetricsRegistry(), 4)
    server = export.ExporterServer(0, fetch=lambda: export.render_registry(reg)).start()
    try:
        url = f"http://127.0.0.1:{server.port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            body = resp.read().decode()
            assert resp.status == 200
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{server.port}/nothing", timeout=10)
    finally:
        server.close()
    parsed = export.parse_prometheus_text(body)
    assert parsed == export.parse_prometheus_text(export.render_registry(reg))
    obs.get_metrics().gauge("fleet.test_gauge").set(1.0)
    assert run_export(0, once=True) == 0
    assert "hpbandster_fleet_test_gauge" in capsys.readouterr().out


def test_health_snapshot_profile_and_crash_dump(tmp_path, monkeypatch):
    reg = fill_registry(MetricsRegistry(), 5)
    ring = RingBuffer(16)
    bus = EventBus()
    bus.subscribe(ring)
    bus.emit("job_finished", loss=0.5, budget=1.0)
    ep = health.HealthEndpoint("worker", identity={"host": "h", "pid": 1}, ring=ring,
                               in_flight=lambda: {"config_id": [0, 0, 1]}, registry=reg)
    snap = ep.snapshot(tail=4)
    assert snap["component"] == "worker" and snap["in_flight"] == {"config_id": [0, 0, 1]}
    assert snap["ring_tail"][0]["event"] == "job_finished"
    assert set(snap["latency"]) == set(reg.snapshot()["histograms"])
    assert snap["runtime"]["compile"] is not None
    assert export.parse_prometheus_text(ep.metrics_text())
    json.dumps(snap)
    # registered on an RPC server, the same snapshot and text over the wire
    from hpbandster_tpu_torch.parallel.rpc import RPCProxy, RPCServer

    srv = RPCServer("127.0.0.1", 0)
    ep.register(srv)
    assert {"obs_snapshot", "metrics_text", "start_profile", "stop_profile",
            "profile_status"} <= set(srv.methods)
    srv.start()
    try:
        remote = RPCProxy(srv.uri, timeout=5).call("obs_snapshot", tail=4)
        assert remote["component"] == "worker" and remote["ring_tail"] == snap["ring_tail"]
        assert remote["metrics"] == snap["metrics"]
        assert RPCProxy(srv.uri, timeout=5).call("metrics_text") == ep.metrics_text()
    finally:
        srv.shutdown()
    started = ep.start_profile(log_dir=str(tmp_path / "prof"))
    assert started["ok"], started
    assert ep.profile_status()["active"]
    stopped = ep.stop_profile()
    assert stopped["ok"] and stopped["files"] >= 1
    path = str(tmp_path / "crash" / "dump.json")
    # the dump chains to the hook before it: here a silent one
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    uninstall = health.install_crash_dump(path, component="worker", ring=ring, registry=reg)
    try:
        t = threading.Thread(target=lambda: 1 / 0, name="doomed")
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    finally:
        uninstall()
    dump = json.loads(open(path).read())
    assert dump["thread"] == "doomed" and dump["exception"]["type"] == "ZeroDivisionError"
    assert dump["ring_tail"] and dump["metrics"]["counters"]


def snapshots(seed, n=3):
    """Health snapshots of ``n`` endpoints with registries from ``seed``."""
    out = {}
    for i in range(n):
        reg = fill_registry(MetricsRegistry(), seed * 10 + i, tenants=(f"t{i}", "shared"))
        ep = health.HealthEndpoint(["master", "dispatcher", "worker"][i % 3],
                                   identity={"host": f"h{i}", "pid": i}, registry=reg)
        out[f"ep{i}"] = ep.snapshot()
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_fleet_derivation_equals_the_reference(ref_obs_all, seed):
    rc = ref_obs_all.collector
    snaps = snapshots(seed)
    rows = {name: collector._endpoint_row(s) for name, s in snaps.items()}
    assert rows == {name: rc._endpoint_row(s) for name, s in snaps.items()}
    for kw in (dict(ok=3, stale=0, lost=0, churn_events=0),
               dict(ok=2, stale=1, lost=1, churn_events=3)):
        assert collector.derive_fleet(rows, **kw) == rc.derive_fleet(rows, **kw)
    gauges = next(iter(snaps.values()))["metrics"]["gauges"]
    counters = next(iter(snaps.values()))["metrics"]["counters"]
    assert collector.lane_gauges(gauges) == rc.lane_gauges(gauges)
    assert collector.slo_gauges(gauges) == rc.slo_gauges(gauges)
    assert collector.tenant_counters(counters) == rc.tenant_counters(counters)
    sample = {"event": "fleet_sample", "t_wall": 1.7e9, "t_mono": 5.0, "seq": seed,
              "fleet": collector.derive_fleet(rows, ok=3, stale=0, lost=0, churn_events=0),
              "endpoints": rows}
    assert collector.format_fleet_table(sample) == rc.format_fleet_table(sample)
    assert collector.format_fleet_table(sample, tenant="shared") == \
        rc.format_fleet_table(sample, tenant="shared")


def test_collector_polls_health_snapshots_through_an_injected_fetcher(tmp_path):
    regs = {f"ep{i}": fill_registry(MetricsRegistry(), 20 + i) for i in range(2)}
    eps = {name: health.HealthEndpoint("worker", identity={"host": name, "pid": 0},
                                       registry=reg) for name, reg in regs.items()}
    down = {"ep1": False}

    def fetch(uri, timeout):
        if down.get(uri):
            raise ConnectionError("endpoint down")
        return eps[uri].snapshot()

    series = str(tmp_path / "fleet.jsonl")
    bus, published = EventBus(), MetricsRegistry()
    ring = RingBuffer(64)
    bus.subscribe(ring)
    col = collector.FleetCollector({n: n for n in eps}, interval_s=0.05, series_path=series,
                                   registry=published, bus=bus, fetch=fetch)
    first = col.poll_once()
    assert first["fleet"]["ok"] == 2 and set(first["endpoints"]) == set(eps)
    down["ep1"] = True
    for _ in range(2):
        last = col.poll_once()
    assert last["fleet"]["ok"] == 1 and last["fleet"]["lost"] == 1
    assert [e.name for e in ring.snapshot()].count("fleet_sample") == 3
    col.stop()
    rows = collector.read_series(series)
    assert [r["seq"] for r in rows] == [0, 1, 2]
    assert any(k.startswith("fleet.") for k in published.snapshot()["gauges"])
    assert collector.format_fleet_table(rows[-1])


def test_what_needs_the_rpc_transport_raises():
    """What needed the RPC transport now runs over it: a collector without
    ``fetch=`` polls ``obs_snapshot`` (an unreachable peer counts lost, it
    does not raise), ``snapshot_fetcher`` renders a peer's metrics, and a
    master with ``collector=True`` serves its own endpoint and polls it."""
    from hpbandster_tpu_torch.parallel.rpc import CommunicationError, RPCServer

    reg = fill_registry(MetricsRegistry(), 6)
    srv = RPCServer("127.0.0.1", 0)
    health.HealthEndpoint("worker", identity={"host": "h", "pid": 2},
                          registry=reg).register(srv)
    srv.start()
    dead = RPCServer("127.0.0.1", 0)
    dead_uri = dead.uri
    dead.shutdown()
    try:
        col = collector.FleetCollector([srv.uri, dead_uri], interval_s=0.05,
                                       timeout_s=2.0, registry=MetricsRegistry(),
                                       bus=EventBus())
        sample = col.poll_once()
        col.stop()
        assert sample["fleet"]["ok"] == 1 and sample["endpoints"][srv.uri]["ok"]
        text = export.snapshot_fetcher(srv.uri, timeout=5)()
        assert export.parse_prometheus_text(text) == export.parse_prometheus_text(
            export.render_registry(reg))
        with pytest.raises(CommunicationError):
            export.snapshot_fetcher(dead_uri, timeout=2)()
    finally:
        srv.shutdown()
    from hpbandster_tpu_torch import BOHB, BatchedExecutor, VmapBackend
    from hpbandster_tpu_torch.workloads.toys import branin, branin_space

    cs = branin_space(seed=0)
    opt = BOHB(configspace=cs, run_id="c", executor=BatchedExecutor(
        VmapBackend(branin, device="cpu"), cs), min_budget=1, max_budget=9,
        device="cpu", collector={"interval_s": 0.05, "timeout_s": 2.0})
    try:
        opt.run(n_iterations=1)
        assert set(opt._fleet_endpoints()) == {"master"}
        sample = opt.fleet_collector.poll_once()
        assert sample["fleet"]["ok"] == 1
        assert sample["endpoints"]["master"]["component"] == "master"
    finally:
        opt.shutdown()
    assert opt.fleet_collector is None and opt.health_server is None
