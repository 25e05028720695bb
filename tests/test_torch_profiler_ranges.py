"""The port's profiler ranges (``obs.use_profiler_annotations``,
``obs.annotate``): where a chunked fused run, the Master loop, the KDE model
and the serving pool open ``hpb.<name>`` ranges, that a garbage collection
becomes one ``hpb.gc`` range and one ``runtime.gc_pause_s`` observation,
and that with the annotations off nothing is opened, no hook is installed
and the bus records are those of a run with them on.

Counts are read from ``torch.profiler`` on the CPU, host activity only.
"""

import gc
import threading

import pytest
from torch.profiler import ProfilerActivity, profile

from hpbandster_tpu_torch import FusedBOHB, obs
from hpbandster_tpu_torch.obs import events
from hpbandster_tpu_torch.obs import timeline as T
from hpbandster_tpu_torch.optimizers import BOHB, fused_bohb
from hpbandster_tpu_torch.parallel import VmapBackend
from hpbandster_tpu_torch.serve import ServePool
from hpbandster_tpu_torch.workloads.toys import branin, branin_space

#: two chunks of two brackets each
SCHEDULE = dict(n_iterations=4, chunk_brackets=2)
CHUNKS, BRACKETS = 2, 4


@pytest.fixture
def annotations():
    """Annotations on for the test, off (and the hook gone) afterwards."""
    obs.use_profiler_annotations()
    try:
        yield
    finally:
        obs.use_profiler_annotations(False)


def ranges(prof, name):
    """The host ranges called ``name`` in a finished profile, as (start,
    end, thread), in microseconds."""
    return [(e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events() if e.name == name]


def port_hooks():
    return [cb for cb in gc.callbacks if isinstance(cb, events._GCRanges)]


def profiled_sweep(tmp_path, checkpointed=False):
    """A chunked CPU sweep under the profiler: (profile, bus records)."""
    fused_bohb._SWEEP_CACHE.clear()
    opt = FusedBOHB(configspace=branin_space(seed=3), eval_fn=branin, run_id="pr",
                    seed=7, min_budget=1, max_budget=9, eta=3, device="cpu")
    kw = {"checkpoint_path": str(tmp_path / "ck.pkl")} if checkpointed else {}
    with T.TimelineRecorder(static_fields={"host": "port", "pid": 1}) as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            opt.run(**SCHEDULE, **kw)
    return prof, rec.records


def untimed(records):
    """What a journal says apart from its clocks, ids and compile-cache
    state: each record's event, phase, config and loss."""
    return [(r["event"], r.get("phase"), r.get("config_id"), r.get("budget"), r.get("loss"))
            for r in records]


@pytest.mark.parametrize("checkpointed", [False, True], ids=["pipelined", "checkpointed"])
def test_chunked_run_ranges_per_chunk_and_bracket(annotations, tmp_path, checkpointed):
    prof, _ = profiled_sweep(tmp_path, checkpointed)
    counts = {name: len(ranges(prof, "hpb." + name)) for name in (
        "bracket_replay", "replay_decode", "replay_stages", "chunk_launch", "chunk_fetch")}
    # every chunk's replay is one range, the pipelined ones (profiler-only)
    # and the last or checkpointed ones (bus spans) alike
    assert counts == dict(bracket_replay=CHUNKS, replay_decode=BRACKETS,
                          replay_stages=BRACKETS, chunk_launch=CHUNKS, chunk_fetch=CHUNKS)
    # the bus spans carry the prefix too
    assert len(ranges(prof, "hpb.chunk_staging")) == CHUNKS
    # a bracket's decode and stages lie inside its chunk's replay
    replays = ranges(prof, "hpb.bracket_replay")
    for s, e, th in ranges(prof, "hpb.replay_decode") + ranges(prof, "hpb.replay_stages"):
        assert any(rs <= s and e <= re and th == rt for rs, re, rt in replays)


def test_annotations_off_open_nothing_and_journal_the_same(tmp_path):
    assert obs.annotate("anything") is obs.annotate("other")
    assert not port_hooks()
    prof_off, records_off = profiled_sweep(tmp_path)
    assert not [e.name for e in prof_off.events() if e.name.startswith(events.RANGE_PREFIX)]
    assert not port_hooks()
    obs.use_profiler_annotations()
    try:
        assert len(port_hooks()) == 1
        prof_on, records_on = profiled_sweep(tmp_path)
    finally:
        obs.use_profiler_annotations(False)
    assert not port_hooks()
    assert ranges(prof_on, "hpb.bracket_replay")
    assert untimed(records_on) == untimed(records_off)


def test_annotations_install_one_hook_and_remove_it():
    obs.use_profiler_annotations()
    obs.use_profiler_annotations()
    try:
        assert len(port_hooks()) == 1
    finally:
        obs.use_profiler_annotations(False)
    assert not port_hooks()
    obs.use_profiler_annotations(False)
    assert not port_hooks()


def test_serve_request_ranges_nest(annotations):
    """One BOHB request of two brackets through a CPU ``ServePool``: one
    ``hpb.master_new_bracket`` a bracket, one ``hpb.master_ingest`` a
    result, and a pack-window wait inside a flush inside the Master loop
    (a second tenant's facade, live but idle, keeps each window open)."""
    pool = ServePool(VmapBackend(branin, device="cpu"), branin_space(seed=0),
                     pack_window_s=0.01)
    idle = pool.executor_for("b")
    opt = BOHB(configspace=branin_space(seed=5), run_id="serve-a", tenant_id="a",
               executor=pool.executor_for("a"), min_budget=1, max_budget=9, eta=3,
               seed=5, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = opt.run(n_iterations=2)
    opt.shutdown()
    idle.shutdown()
    pool.release_tenant("a")
    assert len(ranges(prof, "hpb.master_new_bracket")) == 2
    assert len(ranges(prof, "hpb.master_ingest")) == len(res.get_all_runs()) == 13 + 6
    runs, flushes = ranges(prof, "hpb.master_run"), ranges(prof, "hpb.pool_flush")
    waits = ranges(prof, "hpb.pool_pack_wait")
    assert len(runs) == 1 and flushes and waits

    def inside(inner, outer):
        return outer[0] <= inner[0] and inner[1] <= outer[1] and inner[2] == outer[2]

    assert all(any(inside(w, f) for f in flushes) for w in waits)
    assert all(inside(f, runs[0]) for f in flushes)
    for name in ("hpb.pool_round", "hpb.pool_dispatch", "hpb.pool_deliver",
                 "hpb.fused_dispatch", "hpb.serve_fetch"):
        assert ranges(prof, name), name


def gc_pauses():
    h = obs.get_metrics().snapshot()["histograms"].get("runtime.gc_pause_s")
    return (0, 0.0) if h is None else (h["count"], h["sum"])


def test_gc_collect_is_one_range_and_one_pause(annotations):
    was_enabled = gc.isenabled()
    gc.disable()  # only the explicit collection below runs
    try:
        before = gc_pauses()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            gc.collect()
        after = gc_pauses()
    finally:
        if was_enabled:
            gc.enable()
    assert len(ranges(prof, "hpb.gc")) == 1
    assert after[0] == before[0] + 1 and after[1] > before[1]


def test_gc_hook_off_observes_nothing():
    before = gc_pauses()
    gc.collect()
    assert gc_pauses() == before


def test_collection_under_the_registry_lock_does_not_deadlock(annotations):
    """A collection can start inside any allocation, also one made under
    the metrics registry's lock (a snapshot): the hook's observation
    re-enters the lock on the same thread."""
    hook = port_hooks()[0]
    done = []

    def collect_under_lock():
        with obs.get_metrics()._lock:
            hook("start", {"generation": 0})
            hook("stop", {"generation": 0})
        done.append(True)

    t = threading.Thread(target=collect_under_lock, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and done
