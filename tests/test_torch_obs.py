"""The port's observability layer (``hpbandster_tpu_torch.obs``) against the
reference's ``hpbandster_tpu.obs``.

* The same emit sequence through either package's bus gives equal journal
  records, excluding the clocks and the process identity (``t_wall``,
  ``t_mono``, ``host``, ``pid``); the span clock is pinned, so span
  durations agree too.
* Journals interchange: each package reads the other's, rotated files
  included, and rotation keeps the reference's files byte for byte.
* The registry, the device-telemetry gauges and sections, the cost feed and
  the lineage join equal the reference's on the same inputs.
* The emit sites: a Master run journals its jobs under their own traces, a
  two-tenant ``ServePool`` stamps each record with its own tenant, and a
  fused run journals its chunks, telemetry and incumbent without changing
  its result.
"""

import importlib
import json
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.obs import device_metrics as port_dm
from hpbandster_tpu_torch.optimizers import BOHB, FusedBOHB
from hpbandster_tpu_torch.parallel import BatchedExecutor, VmapBackend
from hpbandster_tpu_torch.serve import ServePool
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_harness import REPO, ref  # noqa: F401

STAMPS = ("t_wall", "t_mono", "host", "pid")


@pytest.fixture(scope="module")
def ref_obs(ref):  # noqa: F811
    """The reference's obs package, imported inside the ``ref`` window."""
    return importlib.import_module("hpbandster_tpu.obs")


def _strip(records):
    return [{k: v for k, v in r.items() if k not in STAMPS} for r in records]


def _emit_sequence(o, path, monkeypatch):
    """One fixed sequence of generic emits, spans and audit emitters, under
    a run, a tenant and a trace, journaled with an identity stamp."""
    monkeypatch.setattr(time, "monotonic", lambda: 100.0)  # spans last 0 s
    handle = o.configure(journal_path=path, identity={"component": "parity"},
                         ring_capacity=8)
    try:
        with o.use_run("run-a"), o.use_tenant("tenant-a"), \
                o.use_trace(o.TraceContext("run-a", "trace-0001", 0)):
            o.emit("job_submitted", config_id=[0, 0, 1], budget=1.0)
            with o.span("stage_batch", n=3, budget=1.0):
                pass
            o.emit_bracket_created(0, [9, 3, 1], [1.0, 3.0, 9.0], eta=3.0,
                                   random_fraction=1 / 3)
            o.emit_config_sampled((0, 0, 1), 1.0, {"model_based_pick": True,
                                                   "lg_score": 1.5, "extra": 3})
            o.note_straggler((0, 0, 1), budget=1.0)
            o.emit_bracket_promotion(0, 0, "pareto", promoted=1, candidates=2,
                                     budget=1.0, next_budget=3.0)
            o.emit_promotion_decision(
                0, 0, 1.0, 3.0, config_ids=[(0, 0, 0), (0, 0, 1)],
                losses=[0.5, None], promoted=[True, False], rule="pareto",
                scores=[0.0, None], pareto_rank=[0, None], costs=[float("nan"), 0.2])
        o.emit("sweep_chunk", duration_s=0.25, brackets=[0, 1], value=np.float32(1.5))
        o.emit_sweep_incumbent(vector=[0.1, float("inf")], loss=0.5, bracket=1,
                               per_bracket_loss=[0.5, None, float("nan")], evaluations=10,
                               d2h_bytes=4, h2d_bytes=8, host_syncs=2)
        ring = [e.name for e in handle.ring.snapshot()]
    finally:
        handle.close()
        monkeypatch.undo()
    return ring


def test_emit_sequence_matches_reference(ref_obs, tmp_path, monkeypatch):
    ours = str(tmp_path / "port.jsonl")
    theirs = str(tmp_path / "ref.jsonl")
    ring = _emit_sequence(obs, ours, monkeypatch)
    ring_ref = _emit_sequence(ref_obs, theirs, monkeypatch)
    got, want = obs.read_journal(ours), ref_obs.read_journal(theirs)
    assert len(got) == 8 and ring == ring_ref == [r["event"] for r in got]
    assert _strip(got) == _strip(want)
    decision = next(r for r in got if r["event"] == "promotion_decision")
    assert decision["tenant_id"] == "tenant-a" and decision["trace_id"] == "trace-0001"
    assert decision["costs"] == [None, 0.2]  # strict JSON: NaN journals as null
    assert decision["straggler_observed"] == [[0, 0, 1]]
    assert all(r["component"] == "parity" and r["pid"] == os.getpid() for r in got)
    # byte-level: the same lines apart from the stamps
    for line_a, line_b in zip(open(ours), open(theirs)):
        a, b = json.loads(line_a), json.loads(line_b)
        assert list(a) == list(b)


def test_journals_interchange(ref_obs, tmp_path):
    """Each package reads the other's journal, torn final line included."""
    for writer, reader in ((obs, ref_obs), (ref_obs, obs)):
        path = str(tmp_path / f"{writer.__name__}.jsonl")
        with writer.JsonlJournal(path, buffer_bytes=0) as j:
            for i in range(5):
                j.write_record({"event": "job_finished", "config_id": [0, 0, i],
                                "loss": float(i) if i != 3 else float("inf")})
        with open(path, "a") as fh:
            fh.write('{"event": "torn')
        records, skipped = importlib.import_module(
            reader.__name__ + ".journal").read_journal_ex(path)
        assert skipped == 1 and [r["config_id"][2] for r in records] == list(range(5))
        assert records[3]["loss"] is None
        assert records == writer.read_journal(path)


def test_rotation_matches_reference(ref_obs, tmp_path):
    """A small ``max_bytes`` rotates: every rotated file stays within it, no
    line is split or lost until ``max_files`` drops the oldest, and the
    files equal the reference's byte for byte."""
    files = {}
    for name, o in (("port", obs), ("ref", ref_obs)):
        path = str(tmp_path / name / "j.jsonl")
        with o.JsonlJournal(path, max_bytes=200, max_files=3, buffer_bytes=64) as j:
            for i in range(40):
                j.write_record({"event": "tick", "i": i, "pad": "x" * (i % 7)})
            rotations = j.rotations
        paths = obs.journal_paths(path)
        files[name] = [open(p).read() for p in paths]
        assert rotations > 3 and len(paths) == 4
        for p in paths[:-1]:
            assert os.path.getsize(p) <= 200
        ticks = [r["i"] for r in obs.read_journal(path)]
        assert ticks == list(range(ticks[0], 40))
    assert files["port"] == files["ref"]


def test_metrics_registry_is_atomic_and_decodes_as_reference(ref_obs):
    reg, reg_ref = obs.MetricsRegistry(), ref_obs.MetricsRegistry()
    values = np.random.default_rng(0).lognormal(-3, 2, size=400)

    def work(k):
        for v in values[k::8]:
            reg.counter("c").inc()
            reg.histogram("h").observe(float(v))
            reg.gauge("g").inc(1.0)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: a lost update shows
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    for v in values:
        reg_ref.counter("c").inc()
        reg_ref.histogram("h").observe(float(v))
        reg_ref.gauge("g").inc(1.0)
    snap, want = reg.snapshot(), reg_ref.snapshot()
    assert snap["counters"] == want["counters"] == {"c": 400}
    assert snap["gauges"] == want["gauges"]
    h, h_ref = snap["histograms"]["h"], want["histograms"]["h"]
    assert h["buckets"] == h_ref["buckets"] and h["count"] == 400
    assert (h["p50"], h["p95"], h["min"], h["max"]) == (
        h_ref["p50"], h_ref["p95"], h_ref["min"], h_ref["max"])
    assert h["sum"] == pytest.approx(h_ref["sum"], rel=1e-12)
    with pytest.raises(TypeError):
        reg.gauge("c")
    obs.set_enabled(False)
    try:
        reg.counter("c").inc()
        assert obs.emit("x") is None and not obs.enabled()
    finally:
        obs.set_enabled(True)
    assert reg.counter("c").value == 400


def test_device_telemetry_and_cost_feed_match_reference(ref, ref_obs):  # noqa: F811
    """``publish_device_metrics`` mints the reference's gauges,
    ``device_section_from_records`` / ``format_device_section`` render
    the reference's section, ``device_metric_fields`` parses the gauges,
    and ``budget_cost_from_obs`` resolves histogram > gauge as the
    reference does."""
    rdm = ref.device_metrics
    rng = np.random.default_rng(1)
    plans = [((9, 3, 1), (1.0, 3.0, 9.0)), ((3, 1), (3.0, 9.0))]
    dm = SimpleNamespace(
        loss_hist=rng.integers(0, 3, size=(2, 3, port_dm.N_BINS)),
        evals=np.array([[9, 3, 1], [3, 1, 0]]), crashes=np.array([[1, 0, 0], [0, 0, 0]]),
        promotions=np.array([[3, 1, 0], [1, 0, 0]]), model_fits=np.array([0, 1]),
        best_final=np.array([0.5, np.nan], np.float32), rung_seq=np.array([[0, 1, 2], [3, 4, -1]]))
    decoded = port_dm.decode_device_metrics(dm, plans=plans, execute_s=0.125)
    assert decoded == rdm.decode_device_metrics(dm, plans=plans, execute_s=0.125)
    reg, reg_ref = obs.MetricsRegistry(), ref_obs.MetricsRegistry()
    port_dm.publish_device_metrics(decoded, registry=reg)
    rdm.publish_device_metrics(decoded, registry=reg_ref)
    assert reg.snapshot() == reg_ref.snapshot()
    gauges = reg.snapshot()["gauges"]
    assert port_dm.device_metric_fields(gauges) == rdm.device_metric_fields(gauges)
    records = [dict(decoded, event="device_telemetry"), {"event": "job_finished"},
               dict(decoded, event="device_telemetry")]
    section = port_dm.device_section_from_records(records)
    assert section == rdm.device_section_from_records(records)
    assert port_dm.format_device_section(section) == rdm.format_device_section(section)
    for b in (1.0, 3.0, 9.0, 27.0):
        assert port_dm.budget_cost_from_obs(b, registry=reg) == rdm.budget_cost_from_obs(
            b, registry=reg_ref)
    for r in (reg, reg_ref):
        for v in (0.003, 0.004, 0.02, 0.03, 0.6, 0.7, 0.8, 0.9):
            r.histogram("master.job_run_s.b3").observe(v)
    feed = port_dm.budget_cost_from_obs(3.0, registry=reg)
    assert feed == rdm.budget_cost_from_obs(3.0, registry=reg_ref) == 0.05
    assert port_dm.budget_cost_from_obs(3.0, registry=reg, min_count=9) == gauges[
        "sweep.budget_cost_s.3"]


def test_spans_open_profiler_ranges_when_asked(tmp_path):
    """``use_profiler_annotations()`` makes every span a
    ``torch.profiler.record_function`` range named ``hpb.<name>``, even
    with no sink; off again, spans with no sink do nothing."""
    from torch.profiler import ProfilerActivity, profile

    from hpbandster_tpu_torch.obs.events import RANGE_PREFIX

    obs.use_profiler_annotations()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.span("smoke_region", n=1):
                sum(range(100))
    finally:
        obs.use_profiler_annotations(False)
    assert "hpb.smoke_region" in {e.key for e in prof.key_averages()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("quiet_region"):
            pass
    keys = {e.key for e in prof.key_averages()}
    assert "hpb.quiet_region" not in keys
    assert not any(k.startswith(RANGE_PREFIX) for k in keys)


def test_lineage_and_unported_configure(ref_obs, tmp_path):
    records = [
        {"event": "config_sampled", "config_id": [0, 0, 0], "model_based_pick": False},
        {"event": "job_finished", "config_id": [0, 0, 0], "budget": 1.0, "loss": 0.5},
        {"event": "job_finished", "config_id": [0, 0, 0], "budget": 1.0, "compute_s": 2},
        {"event": "job_failed", "config_id": [0, 0, 1], "budget": 1.0, "loss": None},
        {"event": "promotion_decision", "iteration": 0, "rung": 0, "budget": 1.0,
         "config_ids": [[0, 0, 0], [0, 0, 1]], "promoted": [True, False]},
        {"event": "job_finished", "config_id": "junk", "budget": 1.0, "loss": 1.0},
    ]
    assert obs.config_lineage(records) == ref_obs.config_lineage(records)
    # the anomaly detector and the SLO alert manager are ported: they
    # attach, ride the handle and detach with it
    with obs.configure(journal_path=str(tmp_path / "x.jsonl"), anomaly=True,
                       slo=True) as h:
        assert isinstance(h.anomaly, obs.AnomalyDetector)
        assert isinstance(h.slo, obs.AlertManager)
        assert obs.get_bus().active
    assert not obs.get_bus().active
    # the device sampler is ported: it attaches and the handle stops it
    with obs.configure(journal_path=str(tmp_path / "y.jsonl"), device_sampler=60.0) as h:
        assert h.sampler is not None
    assert h.sampler is None and obs.runtime_snapshot()["devices"] is None
    assert not obs.get_bus().active


def test_obs_and_promote_import_without_jax():
    code = (
        "import sys\n"
        "import hpbandster_tpu_torch.obs, hpbandster_tpu_torch.promote\n"
        "import hpbandster_tpu_torch.promote.replay\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'hpbandster_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# -------------------------------------------------------------- emit sites
def test_master_run_journals_its_jobs(tmp_path):
    """A Master run: every job submitted and finished under its own trace,
    its config sampled, every bracket created, and the budget-keyed run-time
    histograms fed; the run's results equal the run with no sink."""
    def run(journal):
        cs = branin_space(seed=2)
        opt = BOHB(configspace=cs, run_id="journal",
                   executor=BatchedExecutor(VmapBackend(branin, device="cpu"), cs),
                   min_budget=1, max_budget=9, eta=3, seed=2, min_points_in_model=4,
                   device="cpu")
        obs.get_metrics().reset()
        if journal is None:
            res = opt.run(n_iterations=3)
        else:
            with obs.configure(journal_path=journal):
                res = opt.run(n_iterations=3)
        opt.shutdown()
        return opt, {(r.config_id, r.budget): r.loss for r in res.get_all_runs()}

    _, plain = run(None)
    path = str(tmp_path / "master.jsonl")
    opt, runs = run(path)
    assert runs == plain
    records = obs.read_journal(path)
    submitted = {(tuple(r["config_id"]), r["budget"]): r["trace_id"]
                 for r in records if r["event"] == "job_submitted"}
    finished = {(tuple(r["config_id"]), r["budget"]): r["trace_id"]
                for r in records if r["event"] == "job_finished"}
    assert submitted == finished and len(submitted) == len(runs) == 22
    assert len(set(submitted.values())) == 22
    assert {j.trace.trace_id for j in opt.jobs} == set(submitted.values())
    names = [r["event"] for r in records]
    assert names.count("bracket_created") == 3
    assert names.count("config_sampled") == sum(len(it.data) for it in opt.iterations)
    assert names.count("promotion_decision") == names.count("bracket_promotion") == 3
    assert "kde_refit" in names and "fused_dispatch" in names
    hists = obs.get_metrics().snapshot()["histograms"]
    assert hists["master.job_run_s.b1"]["count"] == 9
    assert hists["master.job_run_s"]["count"] == 22


def test_serve_pool_stamps_each_tenant(tmp_path):
    """Two tenants in threads through one ``ServePool``: every record their
    masters emit carries the emitting tenant's ``tenant_id`` (each job's
    under its own trace), and the pool's spans ride the leader's."""
    pool = ServePool(VmapBackend(branin, device="cpu"), branin_space(seed=0),
                     pack_window_s=0.05)
    results = {}

    def tenant(name, seed):
        opt = BOHB(configspace=branin_space(seed=seed), run_id=f"serve-{name}",
                   tenant_id=name, executor=pool.executor_for(name), min_budget=1,
                   max_budget=9, eta=3, seed=seed, device="cpu")
        results[name] = (opt, opt.run(n_iterations=2))
        opt.shutdown()

    path = str(tmp_path / "serve.jsonl")
    with obs.configure(journal_path=path):
        threads = [threading.Thread(target=tenant, args=a) for a in (("a", 1), ("b", 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    records = obs.read_journal(path)
    traces = {name: {j.trace.trace_id for j in opt.jobs}
              for name, (opt, _) in results.items()}
    for r in records:
        if r["event"] in ("job_submitted", "job_finished", "job_failed"):
            assert r["trace_id"] in traces[r["tenant_id"]], r
        if r["event"] in ("config_sampled", "promotion_decision", "bracket_created",
                          "bracket_promotion", "job_submitted", "job_finished"):
            assert r["tenant_id"] in ("a", "b"), r
    for name, (opt, res) in results.items():
        mine = [r for r in records if r.get("tenant_id") == name]
        assert sum(r["event"] == "job_finished" for r in mine) == len(res.get_all_runs())
        assert sum(r["event"] == "config_sampled" for r in mine) == sum(
            len(it.data) for it in opt.iterations)
    assert any(r["event"] == "serve_admission" for r in records)
    snap = obs.get_metrics().snapshot()
    assert snap["counters"]["serve.tenant.a.configs_done"] >= 14
    assert snap["counters"]["serve.rounds"] >= 1
    assert snap["histograms"]["serve.tenant.b.queue_wait_s"]["count"] >= 1


def _timing_free(rec):
    """A decoded telemetry record without its measured-time keys."""
    out = {k: v for k, v in rec.items() if k != "execute_s"}
    out["rungs"] = [{k: v for k, v in r.items() if k != "est_cost_s"} for r in rec["rungs"]]
    out["rung_order"] = [{k: v for k, v in r.items() if k != "est_s"}
                         for r in rec["rung_order"]]
    return out


@pytest.mark.parametrize("tier", ["static", "resident"])
def test_fused_run_journal(tmp_path, tier):
    """``FusedBOHB.run()`` with a journal: one ``sweep_chunk`` per chunk, the
    replayed brackets' records, one ``device_telemetry`` record equal to
    ``last_device_telemetry``; ``run_incumbent`` journals its incumbent; the
    result equals the same run with no sink."""
    kw = ({"chunk_brackets": 2} if tier == "static" else {"resident": True})

    def make():
        return FusedBOHB(configspace=branin_space(seed=4), eval_fn=branin, run_id="fused",
                         min_budget=1, max_budget=9, eta=3, seed=4, device="cpu")

    def runs(res):
        return {(r.config_id, r.budget): r.loss for r in res.get_all_runs()}

    plain_opt = make()
    plain = runs(plain_opt.run(n_iterations=4, device_metrics=True, **kw))
    path = str(tmp_path / f"{tier}.jsonl")
    opt = make()
    with obs.configure(journal_path=path):
        res = opt.run(n_iterations=4, device_metrics=True, **kw)
        inc = opt.run_incumbent(n_iterations=3, resident=tier == "resident")
    assert runs(res) == plain
    records = obs.read_journal(path)
    chunks = [r for r in records if r["event"] == "sweep_chunk"]
    assert len(chunks) == len(opt.run_stats) + 1  # + run_incumbent's
    assert [c["seq"] for c in chunks[:-1]] == [s["chunk_index"] for s in opt.run_stats]
    (raw,) = [r for r in records if r["event"] == "device_telemetry"]
    assert raw["trace_id"] == chunks[0]["trace_id"]
    tele = {k: v for k, v in raw.items() if k not in ("event", "trace_id") + STAMPS}
    assert tele == json.loads(json.dumps(opt.last_device_telemetry))
    # against the run with no sink: equal apart from the time estimates,
    # which derive from each run's measured seconds (ROADMAP C.2)
    assert _timing_free(tele) == _timing_free(json.loads(json.dumps(
        plain_opt.last_device_telemetry)))
    (incumbent,) = [r for r in records if r["event"] == "sweep_incumbent"]
    assert incumbent["loss"] == pytest.approx(inc["incumbent"]["loss"])
    assert incumbent["bracket"] == inc["incumbent"]["bracket"]
    names = [r["event"] for r in records]
    assert names.count("bracket_created") == 4
    assert names.count("job_finished") + names.count("job_failed") == len(plain)
    lineage = obs.config_lineage(records)
    inc_id = res.get_incumbent_id()
    assert lineage[tuple(inc_id)]["results"]
