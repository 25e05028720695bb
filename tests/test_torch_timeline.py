"""The flight recorder (``hpbandster_tpu_torch.obs.timeline``) and the span
sites of ``FusedBOHB.run()``, held against the reference's
``hpbandster_tpu.obs.timeline`` and its ``FusedBOHB.run()``.

The same journals, made from a seed with numpy
(``test_torch_harness.synth_journal``), go through both packages'
``to_chrome_trace``, ``build_timeline``, ``align_clocks``,
``critical_path`` and ``format_critical_path``, which must be equal; the
port's Perfetto export of the reference's two-hop journal equals the
reference's golden file byte for byte; and a chunked sweep run by each
package journals the same (name, phase) sequence of spans, which either
package's timeline reads to the same result.
"""

import json
from pathlib import Path

import pytest

from hpbandster_tpu_torch import FusedBOHB, obs
from hpbandster_tpu_torch.obs import timeline as T
from hpbandster_tpu_torch.obs.__main__ import main as obs_main
from hpbandster_tpu_torch.optimizers import fused_bohb
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_harness import ref, ref_obs_all, synth_journal  # noqa: F401

GOLDEN = Path(__file__).parent / "timeline_golden" / "two_hop_trace.json"
T0 = 1_700_000_000.0
SEEDS = [0, 1, 2, 3]


def two_hop_records():
    """The reference's golden journal (``tests/test_timeline.py``): a
    master plans and dispatches one job to a worker host, the result comes
    back, then a fused chunk runs with a compile split and a decoded
    device-metrics section. Fixed twin stamps, no skew."""
    recs = []

    def rec(host, pid, mono, event, **fields):
        r = {"event": event, "t_wall": T0 + mono, "t_mono": 1000.0 + mono,
             "host": host, "pid": pid}
        r.update(fields)
        recs.append(r)

    rec("master", 11, 0.000, "job_submitted", trace_id="tr-1", config_id="c0", budget=1.0)
    rec("master", 11, 0.010, "sweep_planning", duration_s=0.01, phase=T.ADMISSION,
        trace_id="tr-1")
    rec("master", 11, 0.030, "rpc_client_call", duration_s=0.02, method="evaluate",
        trace_id="tr-1")
    rec("worker0", 22, 0.120, "job_finished", trace_id="tr-1", worker="w0", budget=1.0,
        queue_wait_s=0.01, dispatch_s=0.02, compute_s=0.05, delivery_s=0.01)
    rec("master", 11, 0.400, "sweep_chunk", duration_s=0.2, compile_s=0.05,
        compile_cache_hit=False, evaluations=13, seq=0, trace_id="tr-1")
    rec("master", 11, 0.401, "device_telemetry", execute_s=0.12, evaluations=13,
        trace_id="tr-1", rung_order=[
            {"seq": 0, "bracket": 0, "stage": 0, "budget": 1.0, "est_s": 0.06, "evals": 9},
            {"seq": 1, "bracket": 0, "stage": 1, "budget": 3.0, "est_s": 0.04, "evals": 3},
            {"seq": 2, "bracket": 0, "stage": 2, "budget": 9.0, "est_s": 0.02, "evals": 1},
        ])
    rec("master", 11, 0.410, "kde_refit", duration_s=0.005, budget=3.0, trace_id="tr-1")
    rec("master", 11, 0.420, "sweep_incumbent", trace_id="tr-1", budget=9.0)
    return recs


def test_two_hop_export_equals_the_reference_golden():
    payload = json.dumps(T.to_chrome_trace(two_hop_records()), indent=1, sort_keys=True)
    assert payload + "\n" == GOLDEN.read_text()


@pytest.mark.parametrize("seed", SEEDS)
def test_timeline_functions_equal_the_reference(ref_obs_all, seed):
    records = synth_journal(seed)
    theirs = ref_obs_all.timeline
    assert T.to_chrome_trace(records) == theirs.to_chrome_trace(records)
    assert T.build_timeline(records) == theirs.build_timeline(records)
    assert T.align_clocks(records) == theirs.align_clocks(records)
    for threshold in (0.5, 0.95):
        mine = T.critical_path(records, threshold=threshold)
        assert mine == theirs.critical_path(records, threshold=threshold)
        assert T.format_critical_path(mine) == theirs.format_critical_path(mine)
        # the phases partition the window: never more than it
        assert mine["attributed_s"] <= mine["end_to_end_s"] + 1e-9


def test_device_row_and_lane_rows_in_the_export():
    doc = T.to_chrome_trace(synth_journal(5))
    threads = {e["args"]["name"] for e in doc["traceEvents"]
               if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "device" in threads and any(t.startswith("lane ") for t in threads)
    rungs = [e for e in doc["traceEvents"] if e["ph"] == "X" and e["name"].startswith("rung b")]
    assert rungs and all(e["cat"] == T.RUNG_COMPUTE for e in rungs)


def test_phase_span_and_mark_reject_unknown_phases_and_cost_nothing_inactive(monkeypatch):
    with pytest.raises(ValueError, match="unknown phase"):
        T.phase_span("x", "warp")
    with pytest.raises(ValueError, match="unknown phase"):
        T.mark("x", "warp")
    assert not obs.get_bus().active

    def no_clock():
        raise AssertionError("an inactive span read the clock")

    monkeypatch.setattr(obs.events.time, "monotonic", no_clock)
    with T.phase_span("quiet", T.PROMOTION):
        pass
    assert T.mark("quiet", T.PROMOTION) is None


def test_recorder_records_are_journal_shaped(ref_obs_all):
    with T.TimelineRecorder(static_fields={"host": "h", "pid": 1}) as rec:
        with T.phase_span("sweep_setup", T.ADMISSION, chunk=3):
            pass
        T.mark("checkpoint", T.PROMOTION)
    assert [(r["event"], r["phase"]) for r in rec.records] == [
        ("sweep_setup", T.ADMISSION), ("checkpoint", T.PROMOTION)]
    assert all(r["host"] == "h" and r["pid"] == 1 and "t_mono" in r for r in rec.records)
    assert rec.records[0]["chunk"] == 3 and rec.records[0]["duration_s"] >= 0.0
    assert not obs.get_bus().active
    # the reference's recorder flattens an event the same way
    theirs = ref_obs_all.timeline.TimelineRecorder(static_fields={"host": "h", "pid": 1})
    ev = ref_obs_all.events.make_event("sweep_setup", {"phase": T.ADMISSION,
                                                       "duration_s": 0.5})
    theirs(ev)
    assert theirs.records[0]["event"] == "sweep_setup"
    assert set(theirs.records[0]) == set(rec.records[0]) - {"chunk"}


# ------------------------------------------------ the sweep's span sequence
SPAN_PHASES = dict(sweep_planning=T.ADMISSION, sweep_setup=T.ADMISSION,
                   chunk_staging=T.TRANSFER, compile_lookup=T.COMPILE,
                   telemetry_fetch=T.TRANSFER, chunk_accounting=T.PROMOTION,
                   obs_fold=T.PROMOTION, bracket_replay=T.PROMOTION)
SCHEDULE = dict(n_iterations=4, chunk_brackets=2, device_metrics=True)


def spans(records):
    return [(r["event"], r["phase"]) for r in records if r.get("phase")]


@pytest.fixture(scope="module")
def ref_sweeps(ref, tmp_path_factory):  # noqa: F811
    """The reference's chunked run of :data:`SCHEDULE` recorded, without
    and with a checkpoint: ``{label: records}``."""
    from hpbandster_tpu.obs.timeline import TimelineRecorder as RefRecorder
    from hpbandster_tpu.optimizers.fused_bohb import FusedBOHB as RefFusedBOHB

    out = {}
    for label in ("pipelined", "checkpointed"):
        opt = RefFusedBOHB(configspace=ref.toys.branin_space(seed=3),
                           eval_fn=ref.toys.branin_from_vector, run_id="tl",
                           seed=7, min_budget=1, max_budget=9, eta=3)
        kw = ({} if label == "pipelined" else
              {"checkpoint_path": str(tmp_path_factory.mktemp("ck") / "ref.pkl")})
        with RefRecorder(static_fields={"host": "ref", "pid": 1}) as rec:
            opt.run(**SCHEDULE, **kw)
        out[label] = rec.records
    return out


def port_sweep(tmp_path, label):
    fused_bohb._SWEEP_CACHE.clear()
    opt = FusedBOHB(configspace=branin_space(seed=3), eval_fn=branin, run_id="tl",
                    seed=7, min_budget=1, max_budget=9, eta=3, device="cpu")
    kw = {} if label == "pipelined" else {"checkpoint_path": str(tmp_path / "port.pkl")}
    with T.TimelineRecorder(static_fields={"host": "port", "pid": 2}) as rec:
        opt.run(**SCHEDULE, **kw)
    return opt, rec.records


@pytest.mark.parametrize("label", ["pipelined", "checkpointed"])
def test_chunked_run_spans_equal_the_reference(ref_sweeps, ref_obs_all, tmp_path, label):
    opt, records = port_sweep(tmp_path, label)
    mine, theirs = spans(records), spans(ref_sweeps[label])
    assert mine == theirs
    chunks = 2
    counts = {name: sum(1 for n, _ in mine if n == name) for name in SPAN_PHASES}
    assert counts == dict(sweep_planning=1, sweep_setup=1, chunk_staging=chunks,
                          compile_lookup=chunks, telemetry_fetch=chunks,
                          chunk_accounting=chunks, obs_fold=chunks,
                          bracket_replay=1 if label == "pipelined" else chunks)
    assert all(SPAN_PHASES[n] == p for n, p in mine)
    assert len(opt.run_stats) == chunks
    # either package's timeline reads the other's journal to its own result
    rt = ref_obs_all.timeline
    for recs in (records, ref_sweeps[label]):
        assert T.critical_path(recs) == rt.critical_path(recs)
        assert T.to_chrome_trace(recs) == rt.to_chrome_trace(recs)
    cp = T.critical_path(records)
    assert set(cp["phases"]) <= set(T.PHASES)
    assert cp["attributed_share"] >= 0.9
    doc = T.to_chrome_trace(records)
    assert any(e["ph"] == "X" and e["name"].startswith("rung b") for e in doc["traceEvents"])


def test_cli_reads_a_port_journal(tmp_path, capsys):
    """The CLI's timeline and critical-path commands over a journaled
    chunked run of the port."""
    fused_bohb._SWEEP_CACHE.clear()
    path = str(tmp_path / "j.jsonl")
    with obs.configure(journal_path=path):
        FusedBOHB(configspace=branin_space(seed=3), eval_fn=branin, run_id="tl", seed=7,
                  min_budget=1, max_budget=9, eta=3, device="cpu").run(**SCHEDULE)
    out = str(tmp_path / "trace.json")
    assert obs_main(["timeline", path, "--out", out]) == 0
    doc = json.loads(Path(out).read_text())
    assert doc["otherData"]["slices"] > 0
    capsys.readouterr()
    assert obs_main(["critical-path", path, "--json"]) == 0
    cp = json.loads(capsys.readouterr().out)
    assert cp["end_to_end_s"] > 0 and cp["phases"]
    assert obs_main(["critical-path", path]) == 0
    assert "verdict" in capsys.readouterr().out


def test_span_sites_stay_on_the_host_between_launches():
    """No span is open while a sweep is built or called: the spans close
    before ``sweep(...)`` runs (a span inside a captured graph would be
    recorded once and never replayed)."""
    fused_bohb._SWEEP_CACHE.clear()
    opt = FusedBOHB(configspace=branin_space(seed=3), eval_fn=branin, run_id="tl", seed=7,
                    min_budget=1, max_budget=9, eta=3, device="cpu")
    open_spans = []
    real_span = obs.events.span

    def tracking(name, bus=None, **fields):
        cm = real_span(name, bus=bus, **fields)

        class Track:
            def __enter__(self):
                open_spans.append(name)
                return cm.__enter__()

            def __exit__(self, *exc):
                open_spans.remove(name)
                return cm.__exit__(*exc)

        return Track()

    seen = []
    real_fn = opt._sweep_fn

    def wrapped_fn(plans, **modes):
        sweep = real_fn(plans, **modes)

        def call(*a, **k):
            seen.append(list(open_spans))
            return sweep(*a, **k)

        return call

    opt._sweep_fn = wrapped_fn
    import hpbandster_tpu_torch.obs.timeline as timeline_mod

    old = timeline_mod.E.span
    timeline_mod.E.span = tracking
    try:
        with T.TimelineRecorder():
            opt.run(**SCHEDULE)
    finally:
        timeline_mod.E.span = old
    assert len(seen) == 2 and all(s == [] for s in seen)
