"""The runtime ledger (``obs/runtime.py``), the roofline
(``obs/profile.py``) and the profiling hooks (``utils/profiling.py``) of
the port, on the CPU: the reference's ``tests/test_runtime_obs.py`` and
``tests/test_profile.py`` cases that apply to it, a ledger record read by
the reference's own aggregation, and ``profile_dir=`` on ``FusedBOHB``.
"""

import json
import os
import time

import pytest
import torch

from hpbandster_tpu_torch import FusedBOHB, obs
from hpbandster_tpu_torch.obs.profile import (
    ProfileSession,
    device_peaks,
    format_roofline,
    roofline_report,
)
from hpbandster_tpu_torch.obs.runtime import (
    CompileTracker,
    DeviceSampler,
    compile_stats_from_records,
    note_transfer,
    publish_sweep_transfers,
    runtime_snapshot,
    transfer_counters,
)
from hpbandster_tpu_torch.optimizers import fused_bohb
from hpbandster_tpu_torch.utils.profiling import annotate, attach_profiler, trace
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_harness import ref  # noqa: F401


@pytest.fixture
def fresh():
    """Private bus + registry + tracker: no cross-test leakage."""
    return obs.EventBus(), obs.MetricsRegistry(), CompileTracker()


@pytest.fixture(autouse=True)
def fresh_cache():
    """No sweep cached by another test: the profiled runs here build and
    run their own."""
    fused_bohb._SWEEP_CACHE.clear()
    yield
    fused_bohb._SWEEP_CACHE.clear()


# ------------------------------------------------------------ capture ledger
def test_capture_ledger_records_per_label(fresh):
    """One record per capture: per-label counts and recompiles, the shared
    counters, one ``xla_compile`` event with the reference's fields (the
    cost analysis null), and a program row per (label, signature)."""
    bus, reg, trk = fresh
    events = []
    detach = bus.subscribe(events.append)
    trk.record("sweep_chunk", "caps=1:256", 0.25, registry=reg, bus=bus)
    trk.record("sweep_chunk", "caps=1:512", 0.5, registry=reg, bus=bus)
    trk.record("resident_round", "caps=1:256", 0.125, registry=reg, bus=bus)
    detach()
    snap = trk.snapshot()
    assert snap["total_compiles"] == 3 and snap["total_compile_s"] == 0.875
    assert snap["functions"]["sweep_chunk"] == {
        "compiles": 2, "compile_s": 0.75, "recompiles": 1, "last_signature": "caps=1:512"}
    counters = reg.snapshot()["counters"]
    assert counters["runtime.compiles"] == 3
    assert counters["runtime.compiles.sweep_chunk"] == 2
    assert reg.snapshot()["gauges"]["runtime.compile_seconds"] == 0.875
    assert [e.name for e in events] == [obs.XLA_COMPILE] * 3
    assert events[1].fields == {"fn": "sweep_chunk", "signature": "caps=1:512",
                                "compile_s": 0.5, "compiles": 2, "recompiles": 1,
                                "flops": None, "bytes_accessed": None}
    assert [(p["fn"], p["signature"]) for p in trk.programs()] == [
        ("sweep_chunk", "caps=1:256"), ("sweep_chunk", "caps=1:512"),
        ("resident_round", "caps=1:256")]
    trk.reset()
    assert trk.snapshot()["total_compiles"] == 0 and trk.programs() == []


def test_program_table_is_bounded(fresh):
    bus, reg, trk = fresh
    for i in range(trk.MAX_PROGRAMS + 10):
        trk.record("f", f"sig{i}", 0.0, registry=reg, bus=bus)
    assert len(trk.programs()) == trk.MAX_PROGRAMS


def test_ledger_records_read_by_the_reference(ref, fresh):  # noqa: F811
    """The port's ``xla_compile`` records aggregate identically under the
    reference's ``compile_stats_from_records`` (the journal contract)."""
    from hpbandster_tpu.obs.runtime import compile_stats_from_records as ref_stats

    bus, reg, trk = fresh
    events = []
    detach = bus.subscribe(events.append)
    for label, s in (("a", 4.0), ("b", 1.0), ("b", 1.0)):
        trk.record(label, "", s, registry=reg, bus=bus)
    detach()
    records = [dict(e.fields, event=e.name) for e in events]
    records.append({"event": "job_finished", "t_wall": 10.0})
    got = compile_stats_from_records(records, window_s=10.0)
    assert got == ref_stats(records, window_s=10.0)
    assert got["compiles"] == 3 and got["compile_share_of_wall"] == 0.6
    assert got["top_recompilers"][0]["fn"] == "b"


# ---------------------------------------------------------- transfer counters
def test_note_transfer_counts_buffers_and_bytes():
    reg = obs.MetricsRegistry()
    note_transfer("d2h", 1024, buffers=2, registry=reg)
    note_transfer("d2h", 512, registry=reg)
    c = reg.snapshot()["counters"]
    assert c["runtime.transfers_d2h"] == 3
    assert c["runtime.transfer_bytes_d2h"] == 1536
    with pytest.raises(ValueError):
        note_transfer("sideways", 1)
    before = transfer_counters(reg)
    note_transfer("h2d", 100, registry=reg)
    note_transfer("d2h", 8, buffers=4, registry=reg)
    delta = publish_sweep_transfers(before, registry=reg)
    assert delta == {"transfers_h2d": 1, "transfers_d2h": 4,
                     "transfer_bytes_h2d": 100, "transfer_bytes_d2h": 8}
    gauges = reg.snapshot()["gauges"]
    assert (gauges["sweep.transfer_bytes.h2d"], gauges["sweep.transfer_bytes.d2h"],
            gauges["sweep.host_syncs"]) == (100.0, 8.0, 5.0)


def test_batched_paths_count_transfers():
    """The batched backend's upload and fetch, and a fused bracket's, count
    in the reference's units."""
    from hpbandster_tpu_torch import VmapBackend
    from hpbandster_tpu_torch.ops.fused import make_fused_bracket_fn

    before = transfer_counters()
    VmapBackend(branin, device="cpu").evaluate(torch.rand(3, 2).numpy(), 1.0)
    runner = make_fused_bracket_fn(branin, (3, 1), (1.0, 3.0), device="cpu")
    runner(torch.rand(3, 2).numpy())
    after = transfer_counters()
    # evaluate: 3 rows padded to the backend's min_pad; the bracket: 3
    # vectors up, 4 (index, loss) pairs down as two buffers
    pad = VmapBackend(branin, device="cpu")._padded_size(3)
    assert {k: after[k] - before[k] for k in after} == {
        "transfers_h2d": 2, "transfers_d2h": 3,
        "transfer_bytes_h2d": pad * 2 * 4 + 3 * 2 * 4,
        "transfer_bytes_d2h": pad * 4 + 4 * 8}


# ------------------------------------------------------------ device sampler
def test_sampler_on_the_cpu_reports_the_count_and_no_memory():
    reg = obs.MetricsRegistry()
    sampler = DeviceSampler(registry=reg)
    census = sampler.sample()
    assert census["device_count"] == 1
    assert census["devices"] == {"0": {"kind": "cpu", "platform": "cpu"}}
    assert sampler.last_sample() == census
    gauges = reg.snapshot()["gauges"]
    assert gauges["runtime.device_count"] == 1
    assert not any(k.startswith("runtime.device.") for k in gauges)
    json.dumps(census)


def test_sampler_thread_and_configure_lifecycle():
    reg = obs.MetricsRegistry()
    sampler = DeviceSampler(interval_s=0.05, registry=reg)
    sampler.start()
    try:
        deadline = time.monotonic() + 5.0
        while sampler.last_sample() is None and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        sampler.stop()
    assert sampler.last_sample() is not None
    sampler.stop()  # idempotent
    handle = obs.configure(device_sampler=0.05)
    try:
        deadline = time.monotonic() + 5.0
        while handle.sampler.last_sample() is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert runtime_snapshot()["devices"]["device_count"] == 1
    finally:
        handle.close()
    assert runtime_snapshot()["devices"] is None
    assert "compile" in runtime_snapshot()


# ------------------------------------------------------------------ roofline
def test_roofline_rows_for_every_program(fresh):
    """A row per ledger program with its captures and seconds; measured
    seconds by label or label@signature; no cost columns, since a graph
    reports none."""
    bus, reg, trk = fresh
    trk.record("sweep_chunk", "a", 0.2, registry=reg, bus=bus)
    trk.record("sweep_chunk", "a", 0.1, registry=reg, bus=bus)
    trk.record("resident_round", "b", 0.1, registry=reg, bus=bus)
    trk.record("resident_round", "c", 0.0, registry=reg, bus=bus)
    peaks = {"kind": "test-card", "flops_per_s": 100e12, "bytes_per_s": 1e12,
             "ridge_flops_per_byte": 100.0}
    rep = roofline_report(tracker=trk, peaks=peaks, transfers={},
                          seconds_by_program={"sweep_chunk": 0.003, "resident_round@c": 0.01})
    assert rep["program_count"] == 3 and rep["peak"] == peaks
    assert rep["programs"] == [
        {"fn": "resident_round", "signature": "b", "compiles": 1, "compile_s": 0.1},
        {"fn": "resident_round", "signature": "c", "compiles": 1, "compile_s": 0.0,
         "measured_s": 0.01},
        {"fn": "sweep_chunk", "signature": "a", "compiles": 2,
         "compile_s": pytest.approx(0.3), "measured_s": 0.003},
    ]
    assert any("no per-program bound" in c for c in rep["caveats"])
    text = format_roofline(rep)
    assert "sweep_chunk[a]" in text and "test-card" in text
    empty = roofline_report(tracker=CompileTracker())
    assert empty["program_count"] == 0 and empty["caveats"] == [
        "no peak FLOP/s table entry for this device kind"]
    assert "no programs in the capture ledger" in format_roofline(empty)


def test_device_peaks_by_card_name():
    h100 = device_peaks("NVIDIA H100 80GB HBM3")
    assert h100["flops_per_s"] == 989.4e12 and h100["bytes_per_s"] == 3.35e12
    assert h100["ridge_flops_per_byte"] == pytest.approx(989.4e12 / 3.35e12)
    cpu = device_peaks(torch.device("cpu"))
    assert cpu == {"kind": "cpu", "flops_per_s": None, "bytes_per_s": None,
                   "ridge_flops_per_byte": None}


# ------------------------------------------------------------------ profiling
def _trace_files(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".json"))


def test_trace_none_is_a_noop_and_a_dir_gets_a_chrome_trace(tmp_path):
    with trace(None):
        torch.ones(2).sum()
    out = tmp_path / "t"
    with trace(str(out)):
        with annotate("hpb_region"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    (name,) = _trace_files(out)
    with open(out / name) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "hpb_region" for e in events)


def test_attach_profiler_is_idempotent_and_detaches(tmp_path):
    class Executor:
        def __init__(self):
            self.calls = 0

        def flush(self):
            self.calls += 1
            return True

    ex = Executor()
    original = ex.flush
    detach_a = attach_profiler(ex, str(tmp_path / "a"))
    detach_b = attach_profiler(ex, str(tmp_path / "b"))
    assert ex.flush() is True and ex.calls == 1
    assert not (tmp_path / "a").exists() and len(_trace_files(tmp_path / "b")) == 1
    detach_a()  # stale handle: not ours to remove any more
    assert ex.flush is not original
    detach_b()
    assert ex.flush == original
    detach_b()


def test_profile_session_round_trip(tmp_path):
    session = ProfileSession()
    assert session.stop() == {"ok": False, "error": "no profile active"}
    started = session.start(str(tmp_path / "p"))
    assert started == {"ok": True, "log_dir": str(tmp_path / "p")}
    again = session.start()
    assert again["ok"] is False and again["log_dir"] == str(tmp_path / "p")
    assert session.status()["active"]
    torch.ones(8).sum()
    stopped = session.stop()
    assert stopped["ok"] and stopped["files"] == 1
    assert session.status() == {"active": False, "log_dir": None, "elapsed_s": None,
                                "captures_completed": 1}


def test_fused_profile_dir_traces_run_and_incumbent(tmp_path):
    """``run(profile_dir=)`` writes one trace per chunk,
    ``run_incumbent(profile_dir=)`` one; the results equal unprofiled
    runs'."""
    def make():
        return FusedBOHB(configspace=branin_space(seed=1), eval_fn=branin, min_budget=1,
                         max_budget=9, eta=3, seed=1, device="cpu")

    rows = [sorted((r.config_id, r.budget, r.loss) for r in
                   make().run(n_iterations=2, chunk_brackets=1, profile_dir=d).get_all_runs())
            for d in (str(tmp_path / "run"), None)]
    assert rows[0] == rows[1]
    assert len(_trace_files(tmp_path / "run")) == 2
    got = make().run_incumbent(n_iterations=2, profile_dir=str(tmp_path / "inc"))
    assert len(_trace_files(tmp_path / "inc")) == 1
    assert got["incumbent"] == make().run_incumbent(n_iterations=2)["incumbent"]
