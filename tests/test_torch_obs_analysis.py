"""The journal analyses (``summarize``, ``report``, the anomaly rules) and
the ``python -m hpbandster_tpu_torch.obs`` CLI, held against the
reference's.

The same records, made from a seed with numpy
(``test_torch_harness.synth_journal``), and a journal of real port runs
(the Master-driven ``BOHB``, a chunked ``FusedBOHB`` with device metrics
and a continuous serving pool on the CPU, with the anomaly detector and
the SLO alert manager attached live) go through each reference function
and its port: the dicts must be equal and the text byte for byte, and the
CLI's stdout equal for every command. The live detectors' alerts equal
the offline replay of the journal.
"""

import io
import json
import sys
import threading

import pytest

from hpbandster_tpu_torch import FusedBOHB, obs
from hpbandster_tpu_torch.obs import anomaly, report, summarize
from hpbandster_tpu_torch.obs.__main__ import main as obs_main
from hpbandster_tpu_torch.obs.alerts import scan_slo_records
from hpbandster_tpu_torch.optimizers import BOHB, fused_bohb
from hpbandster_tpu_torch.parallel import BatchedExecutor, VmapBackend
from hpbandster_tpu_torch.promote.replay import worker_utilization
from hpbandster_tpu_torch.serve import ServePool
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_harness import ref, ref_obs_all, synth_journal  # noqa: F401

SEEDS = [0, 1, 2, 3]
JOIN_S = 120
#: rules that fire on short journals (the defaults are sized for
#: minutes-long fleets)
SENSITIVE = dict(straggler_min_samples=5, straggler_factor=2.0, straggler_floor_s=0.0,
                 nan_burst_threshold=2, nan_burst_window=8, kde_stall_results=8,
                 recompile_threshold=2, imbalance_consecutive=1, imbalance_skew=0.3,
                 churn_per_min=0.5, flap_threshold=1, cooldown_s=0.0)


def _write(tmp_path, records, name="journal.jsonl"):
    path = tmp_path / name
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    return str(path)


def _tenant(pool, tenant, seed, barrier):
    opt = BOHB(configspace=branin_space(seed=seed), run_id=f"an-{tenant}", tenant_id=tenant,
               executor=pool.executor_for(tenant), min_budget=1, max_budget=9, eta=3,
               seed=seed, device="cpu")
    barrier.wait(timeout=JOIN_S)
    opt.run(n_iterations=2)
    opt.shutdown()


@pytest.fixture(scope="module")
def port_journal(tmp_path_factory):
    """A journal of port runs with the detectors live: ``(path, records,
    live alerts, live SLO transitions)``."""
    path = str(tmp_path_factory.mktemp("an") / "port.jsonl")
    fused_bohb._SWEEP_CACHE.clear()
    obs.get_metrics().reset()
    rules = anomaly.AnomalyRules(**SENSITIVE)
    with obs.configure(journal_path=path, anomaly=rules, slo=True, identity=True) as h:
        cs = branin_space(seed=0)
        BOHB(configspace=cs, run_id="an-bohb",
             executor=BatchedExecutor(VmapBackend(branin, device="cpu"), cs),
             min_budget=1, max_budget=9, eta=3, seed=0, device="cpu").run(n_iterations=4)
        FusedBOHB(configspace=branin_space(seed=3), eval_fn=branin, run_id="an-fused", seed=7,
                  min_budget=1, max_budget=9, eta=3, device="cpu").run(
            n_iterations=4, chunk_brackets=2, device_metrics=True)
        pool = ServePool(VmapBackend(branin, device="cpu"), branin_space(seed=0),
                         continuous=True, lane_count=2, pack_window_s=0.1)
        barrier = threading.Barrier(3)
        threads = [threading.Thread(target=_tenant, args=(pool, f"t{i}", 20 + i, barrier),
                                    daemon=True) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
            assert not t.is_alive(), "a tenant thread did not finish"
        alerts, transitions = list(h.anomaly.alerts), list(h.slo.transitions)
    return path, obs.read_journal(path), alerts, transitions


@pytest.mark.parametrize("seed", SEEDS)
def test_summarize_equals_the_reference(ref_obs_all, seed):
    records = synth_journal(seed)
    theirs = ref_obs_all.summarize
    mine = summarize.summarize_records(records)
    assert mine == theirs.summarize_records(records)
    assert summarize.format_summary(mine) == theirs.format_summary(mine)
    assert summarize.trace_timelines(records) == theirs.trace_timelines(records)
    assert worker_utilization(records) == ref_obs_all.replay.worker_utilization(records)
    assert mine["worker_utilization"]


@pytest.mark.parametrize("seed", SEEDS)
def test_report_equals_the_reference(ref_obs_all, seed):
    records = synth_journal(seed)
    theirs = ref_obs_all.report
    mine = report.build_report(records)
    assert json.dumps(mine, sort_keys=True) == json.dumps(theirs.build_report(records),
                                                          sort_keys=True)
    assert report.format_report(mine) == theirs.format_report(mine)
    for tenant in ("default", "t1"):
        sliced = report.filter_tenant(records, tenant)
        assert sliced == theirs.filter_tenant(records, tenant)
        assert 0 < len(sliced) < len(records)
        assert report.format_report(report.build_report(sliced)) == \
            theirs.format_report(theirs.build_report(sliced))


@pytest.mark.parametrize("seed", SEEDS)
def test_anomaly_scan_equals_the_reference(ref_obs_all, seed):
    records = synth_journal(seed)
    ra = ref_obs_all.anomaly
    assert anomaly.scan_records(records) == ra.scan_records(records)
    mine = anomaly.scan_records(records, anomaly.AnomalyRules(**SENSITIVE))
    assert mine == ra.scan_records(records, ra.AnomalyRules(**SENSITIVE))
    assert mine, "the sensitive rules fired nothing"


def test_live_detectors_equal_the_offline_replay(port_journal, ref_obs_all):
    """The reference's promise: a live-run detector's alerts and SLO
    transitions equal the offline replay of its journal."""
    path, records, live_alerts, live_transitions = port_journal
    rules = anomaly.AnomalyRules(**SENSITIVE)
    offline = anomaly.scan_records(records, rules)
    assert offline == live_alerts
    assert offline, "the sensitive rules fired nothing on the port's journal"
    ra = ref_obs_all.anomaly
    assert offline == ra.scan_records(records, ra.AnomalyRules(**SENSITIVE))
    # the journaled alert events carry the live detector's payloads
    journaled = [r for r in records if r["event"] == "alert"]
    assert [(r["rule"], r["subject"]) for r in journaled] == \
        [(a["rule"], a["subject"]) for a in live_alerts]
    mgr = scan_slo_records(records)
    keys = ("slo", "severity", "state", "burn_short", "burn_long", "budget_remaining")
    assert [{k: t.get(k) for k in keys} for t in mgr.transitions] == \
        [{k: t.get(k) for k in keys} for t in live_transitions]
    assert mgr.snapshot() == ref_obs_all.alerts.scan_slo_records(records).snapshot()
    # the lane lifecycle and the device telemetry reached the journal
    events = {r["event"] for r in records}
    assert {"lane_assigned", "lane_released", "serve_chunk", "device_telemetry",
            "sweep_chunk"} <= events


COMMANDS = [
    ["summarize"], ["summarize", "--json"], ["report"], ["report", "--json"],
    ["report", "--tenant", "t1"], ["timeline"], ["critical-path"],
    ["critical-path", "--json"], ["slo"], ["slo", "--json"], ["alerts"],
    ["alerts", "--json"], ["replay", "--rule", "asha"],
]


@pytest.mark.parametrize("command", COMMANDS, ids=lambda c: "-".join(c))
def test_cli_stdout_equals_the_reference(ref_obs_all, port_journal, tmp_path, capsys, command):
    paths = [_write(tmp_path, synth_journal(4)), port_journal[0]]
    for path in paths:
        assert obs_main(command[:1] + [path] + command[1:]) == 0
        mine = capsys.readouterr().out
        assert ref_obs_all.main.main(command[:1] + [path] + command[1:]) == 0
        theirs = capsys.readouterr().out
        assert mine == theirs
        assert mine.strip()


def test_cli_reads_merged_journals_and_refuses_missing_ones(ref_obs_all, tmp_path, capsys):
    a = _write(tmp_path, synth_journal(6, hosts=1), "a.jsonl")
    b = _write(tmp_path, synth_journal(7, hosts=1), "b.jsonl")
    mine = summarize.read_merged_ex([a, b])
    assert mine == ref_obs_all.summarize.read_merged_ex([a, b])
    assert obs_main(["summarize", a, b]) == 0
    assert "event" in capsys.readouterr().out
    assert obs_main(["report", str(tmp_path / "missing.jsonl")]) == 2


def test_rpc_watchers_raise_naming_the_host_tier(tmp_path, capsys):
    """Watching a live process runs over the RPC transport: ``watch`` and
    ``top`` poll a health endpoint's ``obs_snapshot``, ``export
    --snapshot`` bridges its metrics, and a malformed URI is a usage
    error (exit 2), as in the reference."""
    from hpbandster_tpu_torch.obs.health import HealthEndpoint
    from hpbandster_tpu_torch.parallel.rpc import RPCServer

    srv = RPCServer("127.0.0.1", 0)
    HealthEndpoint("dispatcher", identity={"host": "h", "pid": 3}).register(srv)
    srv.start()
    try:
        assert obs_main(["watch", "--snapshot", srv.uri, "--ticks", "1",
                         "--interval", "0.01"]) == 0
        assert obs_main(["top", "--snapshot", srv.uri, "--ticks", "1",
                         "--interval", "0.01"]) == 0
        assert "dispatcher" in capsys.readouterr().out
        assert obs_main(["export", "--snapshot", srv.uri, "--once"]) == 0
        assert "# TYPE" in capsys.readouterr().out
    finally:
        srv.shutdown()
    for cmd in ("watch", "top"):
        assert obs_main([cmd, "--snapshot", "not a uri", "--ticks", "1"]) == 2
        assert "invalid --snapshot URI" in capsys.readouterr().err
    stream = io.StringIO()
    path = _write(tmp_path, synth_journal(8))
    assert summarize.watch_journal(path, interval=0.01, ticks=1, stream=stream) == 0
    assert stream.getvalue()


def test_every_sink_sees_one_order_across_threads():
    """Emits from many threads reach every sink of a bus in the same order,
    the order of their stamps: what lets a live detector equal the replay
    of the journal beside it."""
    from hpbandster_tpu_torch.obs.events import EventBus
    from hpbandster_tpu_torch.obs.journal import RingBuffer

    bus = EventBus()
    first, second = RingBuffer(100_000), RingBuffer(100_000)
    bus.subscribe(first)
    bus.subscribe(second)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        barrier = threading.Barrier(16)

        def emitter(t):
            barrier.wait(timeout=JOIN_S)
            for i in range(300):
                bus.emit("job_finished", worker=f"w{t}", seq=i)

        threads = [threading.Thread(target=emitter, args=(t,)) for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    a, b = first.snapshot(), second.snapshot()
    assert len(a) == 16 * 300 and [id(e) for e in a] == [id(e) for e in b]
    assert all(x.t_mono <= y.t_mono for x, y in zip(a, a[1:]))
