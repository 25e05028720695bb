"""The sweep cache, the pipelined chunk replay, the ``run_stats`` fields,
the timings sidecar and the transfer ledger of ``FusedBOHB.run()`` /
``run_incumbent``, on ``device="cpu"``, held against the reference's
``FusedBOHB`` on the same settings (Branin, budgets 1..9).
"""

import gc
import json
import threading
import weakref

import numpy as np
import pytest

from hpbandster_tpu_torch import FusedBOHB, obs
from hpbandster_tpu_torch.core.result import json_result_logger
from hpbandster_tpu_torch.ops.bracket import hyperband_bracket
from hpbandster_tpu_torch.optimizers import fused_bohb
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from hpbandster_tpu_torch import space as tspace
from tests.test_torch_harness import cond_space, ref  # noqa: F401

#: the settings both packages run here (the reference's test_sweep.py
#: pipelined-replay case: Branin's space seeded 3, budgets 1..9)
SETTINGS = dict(min_budget=1, max_budget=9, eta=3)


@pytest.fixture(autouse=True)
def fresh_cache():
    """Every test starts from an empty sweep cache: a sweep cached by an
    earlier test would bypass what a test patches or counts."""
    fused_bohb._SWEEP_CACHE.clear()
    yield
    fused_bohb._SWEEP_CACHE.clear()


def make(seed=47, space_seed=3, **kw):
    return FusedBOHB(configspace=branin_space(seed=space_seed), eval_fn=branin,
                     run_id="dyn", seed=seed, device="cpu", **SETTINGS, **kw)


def rows(res):
    return sorted((r.config_id, r.budget, r.loss) for r in res.get_all_runs())


def n_runs(n_iterations):
    return sum(sum(hyperband_bracket(i, 1, 9, 3).num_configs) for i in range(n_iterations))


# ------------------------------------------------------ the reference's runs
@pytest.fixture(scope="module")
def ref_runs(ref):  # noqa: F811
    """The reference's runs on this file's settings: ``{label: (run_stats,
    info keys of the runs, transfer counter delta)}`` for a chunked run,
    a static run and ``run_incumbent``."""
    from hpbandster_tpu.obs.runtime import transfer_counters
    from hpbandster_tpu.optimizers.fused_bohb import FusedBOHB as RefFusedBOHB

    def mk():
        return RefFusedBOHB(configspace=ref.toys.branin_space(seed=3),
                            eval_fn=ref.toys.branin_from_vector, run_id="dyn",
                            seed=47, **SETTINGS)

    out = {}
    for label, call in (
        ("chunked", lambda o: o.run(n_iterations=9, chunk_brackets=3)),
        ("static", lambda o: o.run(n_iterations=3)),
        ("resident", lambda o: o.run(n_iterations=3, resident=True)),
        ("incumbent", lambda o: o.run_incumbent(n_iterations=3)),
    ):
        opt = mk()
        before = transfer_counters()
        res = call(opt)
        after = transfer_counters()
        infos = (set() if label == "incumbent" else
                 {frozenset(r.info) for r in res.get_all_runs() if r.loss is not None})
        out[label] = (opt.run_stats, infos, {k: after[k] - before[k] for k in after},
                      res if label == "incumbent" else None)
    return out


def test_pipelined_replay_matches_sequential_and_records_overlap(ref_runs, tmp_path):
    """Chunk k's replay runs inside chunk k+1's window unless a
    ``checkpoint_path`` makes it sequential; the results are the same
    either way, and the overlap pattern is the reference's."""
    piped_opt = make()
    piped = rows(piped_opt.run(n_iterations=9, chunk_brackets=3))
    seq_opt = make()
    seq = rows(seq_opt.run(n_iterations=9, chunk_brackets=3,
                           checkpoint_path=str(tmp_path / "ck.pkl")))
    assert piped == seq
    pattern = [("replay_overlap_s" in s) for s in piped_opt.run_stats]
    assert pattern == [False, True, True]
    assert pattern == [("replay_overlap_s" in s) for s in ref_runs["chunked"][0]]
    assert all("replay_overlap_s" not in s for s in seq_opt.run_stats)
    assert all(s["replay_overlap_s"] >= 0 for s in piped_opt.run_stats[1:])


def test_later_chunk_failure_keeps_previous_chunk_replayed():
    """The deferred replay lands even when the next chunk dies before its
    dispatch; a retry continues with no duplicated runs."""
    opt = make(seed=53)
    orig = opt._sweep_built
    calls = {"n": 0}

    def failing(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("capture failed")
        return orig(*a, **k)

    opt._sweep_built = failing
    with pytest.raises(RuntimeError, match="capture failed"):
        opt.run(n_iterations=9, chunk_brackets=3)
    assert len(opt.iterations) == 3
    opt._sweep_built = orig
    res = opt.run(n_iterations=9, chunk_brackets=3)
    assert len(res.get_all_runs()) == n_runs(9)
    assert len(opt.iterations) == 9
    assert len({(r.config_id, r.budget) for r in res.get_all_runs()}) == n_runs(9)


def test_run_stats_and_job_info_keys_match_reference(ref_runs):
    """Every ``run_stats`` row and every run's info carry the reference's
    keys on the same run (the port's ``graph_*`` fields appear only on a
    card); the chunks after the first hit the cache."""
    opt = make()
    res = opt.run(n_iterations=9, chunk_brackets=3)
    ref_stats, ref_infos, _, _ = ref_runs["chunked"]
    assert [set(s) for s in opt.run_stats] == [set(s) for s in ref_stats]
    infos = {frozenset(r.info) for r in res.get_all_runs() if r.loss is not None}
    assert infos == ref_infos
    assert [s["compile_cache_hit"] for s in opt.run_stats] == [False, True, True]
    assert [s["compile_cache_hit"] for s in opt.run_stats] == [
        s["compile_cache_hit"] for s in ref_stats]
    assert opt.run_stats[0]["build_compile_s"] > 0.0
    assert [s["build_compile_s"] for s in opt.run_stats[1:]] == [0.0, 0.0]


@pytest.mark.parametrize("tier", [dict(), dict(chunk_brackets=2), dict(resident=True)],
                         ids=["static", "chunked", "resident"])
def test_second_optimizer_hits_the_cache(tier):
    """A second fresh optimizer of equal settings and seed runs on the
    cached sweep, and its ``Result`` equals the first's; another seed on
    the hit equals that seed's run on a freshly built sweep."""
    first = make(seed=5)
    want = rows(first.run(n_iterations=4, **tier))
    second = make(seed=5)
    got = rows(second.run(n_iterations=4, **tier))
    assert got == want
    assert not first.run_stats[0]["compile_cache_hit"]
    assert all(s["compile_cache_hit"] for s in second.run_stats)
    assert all(s["build_compile_s"] == 0.0 for s in second.run_stats)
    reseeded = rows(make(seed=6).run(n_iterations=4, **tier))
    fused_bohb._SWEEP_CACHE.clear()
    assert reseeded == rows(make(seed=6).run(n_iterations=4, **tier))


@pytest.mark.parametrize("tier", [dict(chunk_brackets=2), dict(resident=True)],
                         ids=["chunked", "resident"])
def test_two_threads_share_a_cached_sweep(tier):
    """Two threads run optimizers of one key on the same cached sweeps at
    once (seeds 5 and 6): every chunk is a hit and each ``Result`` equals
    its seed's run alone."""
    alone = {seed: rows(make(seed=seed).run(n_iterations=4, **tier)) for seed in (5, 6)}
    barrier = threading.Barrier(2)
    opts, got, errors = {}, {}, []

    def run(seed):
        try:
            opts[seed] = make(seed=seed)
            barrier.wait()
            got[seed] = rows(opts[seed].run(n_iterations=4, **tier))
        except BaseException as e:  # re-raised in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(seed,)) for seed in (5, 6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert got == alone
    assert all(s["compile_cache_hit"] for o in opts.values() for s in o.run_stats)


def test_dropped_sweep_is_freed_without_the_collector():
    """A built sweep holds no reference cycle: once the cache drops it, it
    (and on a card its graph) is freed at once, never by the cycle
    collector in the middle of a later capture."""
    opt = make()
    plans = [opt._plan(i) for i in range(2)]
    caps = {1.0: 256, 3.0: 256, 9.0: 256}
    gc.disable()
    try:
        sweep, _, hit = opt._sweep_built(plans, dynamic=True, caps=caps)
        assert not hit
        sweep(0, *opt._dynamic_warm(caps, 2)[0])
        ref_ = weakref.ref(sweep)
        del sweep
        assert ref_() is not None  # the cache holds it
        fused_bohb._SWEEP_CACHE.clear()
        assert ref_() is None
    finally:
        gc.enable()


def _cond_space_variant(seed):
    """``cond_space`` with its ordinal condition's threshold moved: the
    same hyperparameters (so the same codec), other conditions."""
    m = tspace
    cs = m.ConfigurationSpace(seed=seed)
    hps = {hp.name: hp for hp in cond_space(m, seed).get_hyperparameters()}
    cs.add_hyperparameters([hps[n] for n in ("x", "y", "opt", "momentum", "depth", "extra")])
    cs.add_condition(m.EqualsCondition(hps["momentum"], hps["opt"], "sgd"))
    cs.add_condition(m.GreaterThanCondition(hps["extra"], hps["depth"], 1))
    cs.add_forbidden_clause(m.ForbiddenAndConjunction(
        m.ForbiddenEqualsClause(hps["opt"], "adam"), m.ForbiddenEqualsClause(hps["depth"], 8)))
    return cs


def _cond_fn(v, budget):
    return branin(v[:, :2], budget) + 0.1 * v[:, 3] + 0.05 * v[:, 5]


def _cond_opt(space, seed=0):
    return FusedBOHB(configspace=space, eval_fn=_cond_fn, seed=seed, num_samples=8,
                     device="cpu", **SETTINGS)


@pytest.mark.parametrize("cause", ["kde_fit_flag", "device_metrics", "conditions",
                                   "forbidden_fallback"])
def test_cache_misses(cause, monkeypatch):
    """What changes the built program misses the cache: the resolved
    ``HPB_PALLAS_KDE_FIT`` flag, the metrics plane, the conditions, and
    the forbidden clauses' fallback vector; the same run again hits."""
    monkeypatch.delenv("HPB_PALLAS_KDE_FIT", raising=False)
    if cause in ("kde_fit_flag", "device_metrics"):
        make().run(n_iterations=2, chunk_brackets=2)
        if cause == "kde_fit_flag":
            monkeypatch.setenv("HPB_PALLAS_KDE_FIT", "1")
            kw = {}
        else:
            kw = {"device_metrics": True}
        second, third = make(), make()
        second.run(n_iterations=2, chunk_brackets=2, **kw)
        third.run(n_iterations=2, chunk_brackets=2, **kw)
    elif cause == "conditions":
        a = _cond_opt(cond_space(tspace, 0))
        b = _cond_opt(_cond_space_variant(0))
        assert a.codec.signature == b.codec.signature
        a.run(n_iterations=2)
        second, third = b, _cond_opt(_cond_space_variant(0))
        second.run(n_iterations=2)
        third.run(n_iterations=2)
    else:
        # the fallback vector is drawn from the optimizer's seed: another
        # seed on the same forbidden space draws another one
        a, second, third = (_cond_opt(cond_space(tspace, 0), seed=s) for s in (0, 1, 1))
        assert not np.array_equal(a._fallback_vector.numpy(), second._fallback_vector.numpy())
        for o in (a, second, third):
            o.run(n_iterations=2)
    assert not second.run_stats[0]["compile_cache_hit"]
    assert third.run_stats[0]["compile_cache_hit"]


def test_seed_does_not_key_the_sweep():
    """Without forbidden clauses the seed does not key the sweep."""
    make(seed=1).run(n_iterations=2)
    opt = make(seed=2)
    opt.run(n_iterations=2)
    assert opt.run_stats[0]["compile_cache_hit"]


def test_timings_sidecar_written_next_to_jsonl(tmp_path):
    """``fused_timings.json`` beside the logger's files equals
    ``run_stats``; a second optimizer on the same logger appends, and
    entries already on disk are not written twice."""
    logger = json_result_logger(str(tmp_path), overwrite=True)
    opt = make(seed=8, result_logger=logger)
    opt.run(n_iterations=2)
    with open(tmp_path / "fused_timings.json") as fh:
        stats = json.load(fh)
    assert stats == opt.run_stats
    assert stats[0]["evaluations"] > 0
    opt.run(n_iterations=3)  # the first row is on disk already
    other = make(seed=9, result_logger=logger)
    other.run(n_iterations=2, chunk_brackets=1)
    with open(tmp_path / "fused_timings.json") as fh:
        merged = json.load(fh)
    assert merged == opt.run_stats + other.run_stats


# ------------------------------------------------------------- transfers
def _port_delta(call):
    before = obs.transfer_counters()
    out = call()
    after = obs.transfer_counters()
    return {k: after[k] - before[k] for k in after}, out


@pytest.mark.parametrize("label", ["chunked", "static", "resident"])
def test_run_transfers_match_reference(ref_runs, label):
    """``run()``'s transfer ledger against the reference's on the same
    inputs, with the differences that are by design (ROADMAP C.3) pinned:
    the port seeds a ``torch.Generator`` on the host and uploads no seed
    (4 bytes and, where the previous chunk's device state carried the
    observations, the whole upload: one buffer fewer); its indices are
    int64 where the reference's are int32 (4 bytes more per evaluation);
    and it counts each chunk's fetch once, where the reference counts each
    bracket's (index, loss) pair again when it unpacks the fetched arrays
    (2 buffers and 8 bytes per evaluation)."""
    call = {"chunked": lambda o: o.run(n_iterations=9, chunk_brackets=3),
            "static": lambda o: o.run(n_iterations=3),
            "resident": lambda o: o.run(n_iterations=3, resident=True)}[label]
    opt = make()
    got, _ = _port_delta(lambda: call(opt))
    want = ref_runs[label][2]
    chunks = len(opt.run_stats)
    brackets = sum(len(s["brackets"]) for s in opt.run_stats)
    evaluations = sum(s["evaluations"] for s in opt.run_stats)
    no_upload = sum(s["warm_upload_bytes"] == 0 for s in opt.run_stats)
    assert got == {
        "transfers_h2d": want["transfers_h2d"] - no_upload,
        "transfer_bytes_h2d": want["transfer_bytes_h2d"] - 4 * chunks,
        "transfers_d2h": want["transfers_d2h"] - 2 * brackets,
        "transfer_bytes_d2h": want["transfer_bytes_d2h"] - 4 * evaluations,
    }
    gauges = obs.get_metrics().snapshot()["gauges"]
    assert gauges["sweep.transfer_bytes.h2d"] == got["transfer_bytes_h2d"]
    assert gauges["sweep.transfer_bytes.d2h"] == got["transfer_bytes_d2h"]
    assert gauges["sweep.host_syncs"] == got["transfers_h2d"] + got["transfers_d2h"]
    assert got["transfer_bytes_h2d"] == sum(s["warm_upload_bytes"] for s in opt.run_stats)


def test_run_incumbent_transfers_from_the_ledger(ref_runs):
    """``run_incumbent``'s ``transfers`` is the ledger's delta over the
    call: the reference's, less its 4-byte seed upload (ROADMAP C.3); it
    goes through the sweep cache like ``run()``."""
    want = ref_runs["incumbent"][3]
    opt = make()
    got, out = _port_delta(lambda: opt.run_incumbent(n_iterations=3))
    assert out["transfers"] == got
    assert got == dict(want["transfers"],
                       transfer_bytes_h2d=want["transfers"]["transfer_bytes_h2d"] - 4)
    assert set(out) == set(want)
    assert not out["compile_cache_hit"] and out["build_compile_s"] > 0.0
    again = make().run_incumbent(n_iterations=3)
    assert again["compile_cache_hit"] and again["build_compile_s"] == 0.0
    assert again["incumbent"] == out["incumbent"]
