"""Chunked ``FusedBOHB.run()`` on the dynamic-count tier: checkpoint and
resume, device-state threading, warm start from a previous ``Result``, and
loading a checkpoint written by the reference. All on ``device="cpu"``.
"""

import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

from hpbandster_tpu_torch import FusedBOHB
from hpbandster_tpu_torch.ops.bracket import hyperband_bracket
from hpbandster_tpu_torch.optimizers import fused_bohb
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_harness import REPO, ref  # noqa: F401
from tests.test_torch_sweep import _expected_runs_per_budget, _runs_per_budget


def make_fused(seed=7, **kw):
    return FusedBOHB(
        configspace=branin_space(seed=seed), eval_fn=branin, run_id="fused-ckpt",
        min_budget=1, max_budget=9, eta=3, seed=seed, min_points_in_model=5,
        device="cpu", **kw,
    )


def runs(result):
    return sorted((r.config_id, r.budget, r.loss) for r in result.get_all_runs())


def test_resume_matches_uninterrupted_run_exactly(tmp_path):
    """Cut a chunked run at a chunk boundary, resume from the checkpoint,
    and the completed result equals an uninterrupted run's exactly: the
    checkpoint restores the warm observations and the RNG position, so the
    resumed chunk draws the same seed over the same buffers."""
    path = str(tmp_path / "fused.pkl")
    ref_opt = make_fused()
    res_ref = ref_opt.run(n_iterations=4, chunk_brackets=2)

    make_fused().run(n_iterations=2, chunk_brackets=2, checkpoint_path=path)
    resumed = make_fused()
    resumed.load_checkpoint(path)
    assert len(resumed.iterations) == 2
    assert all(it.is_finished for it in resumed.iterations)
    res = resumed.run(n_iterations=4, chunk_brackets=2)

    assert runs(res) == runs(res_ref)
    assert res.get_id2config_mapping() == res_ref.get_id2config_mapping()
    assert res.get_incumbent_id() == res_ref.get_incumbent_id()
    assert any(d.config_info["model_based_pick"] for d in res.data.values())
    # per-run chunk infos survive the checkpoint round trip
    assert all("chunk_execute_s" in r.info for r in res.get_all_runs()
               if r.loss is not None)
    assert [s["chunk_index"] for s in resumed.run_stats] == [0, 1]


def test_mid_run_checkpoint_restores_warm_state_bitwise(tmp_path, monkeypatch):
    """The checkpoint written after chunk 0, while the same run goes on to
    change its warm buffers and RNG for chunk 1, restores exactly the
    state of that boundary and resumes to the uninterrupted result."""
    path, mid = str(tmp_path / "live.pkl"), str(tmp_path / "mid.pkl")
    orig = FusedBOHB.save_checkpoint

    def capture_first(self, p):
        orig(self, p)
        if not os.path.exists(mid):
            shutil.copy(p, mid)

    monkeypatch.setattr(FusedBOHB, "save_checkpoint", capture_first)
    res_ref = make_fused().run(n_iterations=4, chunk_brackets=2, checkpoint_path=path)
    with open(mid, "rb") as fh:
        state = pickle.load(fh)
    assert [s["HPB_iter"] for s in state["iterations"]] == [0, 1]
    assert state["warm_v"] and state["warm_l"] and state["use_pallas"] is True

    resumed = make_fused()
    resumed.load_checkpoint(mid)
    assert set(resumed._warm_v) == {float(b) for b in state["warm_v"]}
    for b, v in state["warm_v"].items():
        assert np.array_equal(resumed._warm_v[float(b)], v)
    for b, l in state["warm_l"].items():
        assert np.array_equal(resumed._warm_l[float(b)], l)
    assert resumed.rng.bit_generator.state == state["rng_state"]
    res = resumed.run(n_iterations=4, chunk_brackets=2)
    assert runs(res) == runs(res_ref)
    assert res.get_incumbent_id() == res_ref.get_incumbent_id()


def test_threaded_state_equals_reupload_every_chunk():
    """A run that hands each chunk the previous chunk's device state and a
    run that uploads the host's copy before every chunk (one run() call
    per chunk) see identical buffers, so their results are identical."""
    threaded = make_fused()
    res_t = threaded.run(n_iterations=6, chunk_brackets=2)
    uploaded = make_fused()
    for n in (2, 4, 6):
        res_u = uploaded.run(n_iterations=n, chunk_brackets=2)
    assert runs(res_t) == runs(res_u)
    assert res_t.get_id2config_mapping() == res_u.get_id2config_mapping()
    assert [s["warm_upload_bytes"] > 0 for s in threaded.run_stats] == [True, False, False]
    assert all(s["warm_upload_bytes"] > 0 for s in uploaded.run_stats)
    assert all(s["dynamic_counts"] for s in threaded.run_stats + uploaded.run_stats)


def test_tier_follows_the_knobs_not_the_remaining_schedule():
    """``chunk_brackets`` selects the dynamic tier whatever the chunk size;
    ``dynamic_counts`` forces either tier."""
    cases = [
        (dict(chunk_brackets=8), [True]),
        (dict(), [False]),
        (dict(dynamic_counts=True), [True]),
        (dict(chunk_brackets=2, dynamic_counts=False), [False, False]),
    ]
    for kw, tiers in cases:
        opt = make_fused()
        res = opt.run(n_iterations=4, **kw)
        assert [s["dynamic_counts"] for s in opt.run_stats] == tiers, kw
        assert _runs_per_budget(res) == _expected_runs_per_budget(4, 9.0)
    with pytest.raises(NotImplementedError):
        make_fused().run(n_iterations=2, resident=True)


def test_failed_chunk_keeps_completed_chunks():
    """A chunk that raises leaves every completed chunk's brackets in the
    optimizer; a retry continues with the remaining brackets only."""
    calls = {"n": 0, "fail_from": 10**9}

    def flaky(v, budget):
        calls["n"] += 1
        if calls["n"] >= calls["fail_from"]:
            raise RuntimeError("evaluation backend died")
        return branin(v, budget)

    opt = FusedBOHB(configspace=branin_space(seed=7), eval_fn=flaky,
                    min_budget=1, max_budget=9, eta=3, seed=7, device="cpu")
    calls["fail_from"] = calls["n"] + 4  # chunk 0 makes three stage calls
    with pytest.raises(RuntimeError, match="backend died"):
        opt.run(n_iterations=4, chunk_brackets=1)
    assert [it.HPB_iter for it in opt.iterations] == [0]
    assert opt.total_evaluated == 13
    calls["fail_from"] = 10**9
    res = opt.run(n_iterations=4, chunk_brackets=1)
    assert [it.HPB_iter for it in opt.iterations] == [0, 1, 2, 3]
    assert _runs_per_budget(res) == _expected_runs_per_budget(4, 9.0)


def test_checkpoint_guards(tmp_path):
    path = str(tmp_path / "g.pkl")
    make_fused().run(n_iterations=2, chunk_brackets=2, checkpoint_path=path)
    with open(path, "rb") as fh:
        state = pickle.load(fh)

    def load(mutate, opt=None):
        bad = dict(state)
        mutate(bad)
        p = str(tmp_path / "bad.pkl")
        with open(p, "wb") as fh:
            pickle.dump(bad, fh)
        (opt or make_fused()).load_checkpoint(p)

    with pytest.raises(ValueError, match="use_pallas=False"):
        load(lambda s: s.update(use_pallas=False))
    with pytest.raises(ValueError, match="FusedH2BO"):
        load(lambda s: s.update(optimizer_class="FusedH2BO"))
    with pytest.raises(ValueError, match="version"):
        load(lambda s: s.update(format_version=2))
    with pytest.raises(ValueError, match="num_samples"):
        load(lambda s: None, make_fused(num_samples=8))
    other = FusedBOHB(configspace=branin_space(seed=7), eval_fn=branin,
                      min_budget=1, max_budget=27, eta=3, seed=7,
                      min_points_in_model=5, device="cpu")
    with pytest.raises(ValueError):
        load(lambda s: None, other)
    opt = make_fused()
    opt.load_checkpoint(path)
    with pytest.raises(RuntimeError, match="fresh"):
        opt.load_checkpoint(path)


# -------------------------------------------------------------- warm start
def test_warmstart_from_previous_result():
    """previous_result= seeds the device buffers: bracket 0 of the warm run
    already makes model-based picks, and the old data rides into the
    Result under negative iteration ids."""
    cs = branin_space(seed=0)
    kw = dict(configspace=cs, eval_fn=branin, min_budget=1, max_budget=27,
              eta=3, device="cpu")
    prev = FusedBOHB(run_id="w0", seed=11, **kw).run(n_iterations=3)
    warm = FusedBOHB(run_id="w1", seed=12, previous_result=prev, **kw)
    res = warm.run(n_iterations=1, chunk_brackets=1)
    id2conf = res.get_id2config_mapping()
    assert sum(cid[0] < 0 for cid in id2conf) == len(prev.get_id2config_mapping())
    assert any(c["config_info"]["model_based_pick"]
               for cid, c in id2conf.items() if cid[0] == 0)
    assert len(res.get_all_runs()) == len(prev.get_all_runs()) + 27 + 9 + 3 + 1


def test_chained_warmstart_no_id_collision():
    """Warm-starting from an already warm-started Result never remaps old
    ids onto live bracket ids."""
    cs = branin_space(seed=0)
    kw = dict(configspace=cs, eval_fn=branin, min_budget=1, max_budget=9,
              eta=3, device="cpu")
    r1 = FusedBOHB(run_id="c0", seed=20, **kw).run(n_iterations=1)
    r2 = FusedBOHB(run_id="c1", seed=21, previous_result=r1, **kw).run(n_iterations=1)
    r3 = FusedBOHB(run_id="c2", seed=22, previous_result=r2, **kw).run(
        n_iterations=1, chunk_brackets=1)
    id2conf = r3.get_id2config_mapping()
    live = [cid for cid in id2conf if cid[0] >= 0]
    warm = [cid for cid in id2conf if cid[0] < 0]
    assert {cid[0] for cid in live} == {0}
    assert len({cid[0] for cid in warm}) == 2
    assert len(live) == 9
    assert len(r3.get_all_runs()) == 13 * 3


# ------------------------------------------------- the reference's checkpoint
def test_reference_checkpoint_loads_and_continues(ref, tmp_path, monkeypatch):
    """A checkpoint written by the reference's ``FusedBOHB(use_pallas=True)``
    after one chunk loads into the port: unpickling it imports nothing of
    the reference package, and the continued run has the reference
    continuation's bracket shapes and chunk seed."""
    from hpbandster_tpu.optimizers.fused_bohb import FusedBOHB as RefFusedBOHB

    monkeypatch.delenv("HPB_PALLAS_KDE_FIT", raising=False)
    path = str(tmp_path / "ref.pkl")
    ref_opt = RefFusedBOHB(
        configspace=ref.toys.branin_space(seed=7), eval_fn=ref.toys.branin_from_vector,
        min_budget=1, max_budget=9, eta=3, seed=7, min_points_in_model=5,
        use_pallas=True,
    )
    ref_opt.run(n_iterations=2, chunk_brackets=2, checkpoint_path=path)

    code = (
        "import pickle, sys\n"
        f"state = pickle.load(open({path!r}, 'rb'))\n"
        "bad = [m for m in sys.modules if m == 'hpbandster_tpu'"
        " or m.startswith('hpbandster_tpu.') or m == 'jax' or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "assert state['kind'] == 'fused' and state['use_pallas'] is True\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

    with open(path, "rb") as fh:
        state = pickle.load(fh)
    rng = np.random.default_rng()
    rng.bit_generator.state = state["rng_state"]
    want_seed = int(np.uint32(rng.integers(2**32, dtype=np.uint32)))

    seeds = []
    build = fused_bohb.make_fused_sweep_fn

    def recording_build(*a, **k):
        fn = build(*a, **k)

        def sweep(seed, *args, **kw):
            seeds.append(seed)
            return fn(seed, *args, **kw)

        return sweep

    monkeypatch.setattr(fused_bohb, "make_fused_sweep_fn", recording_build)
    opt = make_fused()
    opt.load_checkpoint(path)
    assert len(opt.iterations) == 2 and opt.total_evaluated == 19
    for b, v in state["warm_v"].items():
        assert np.array_equal(opt._warm_v[float(b)], v)
    res = opt.run(n_iterations=4, chunk_brackets=2)

    assert seeds == [want_seed]
    assert [(it.num_configs, it.budgets) for it in opt.iterations] == [
        (list(p.num_configs), [float(b) for b in p.budgets])
        for p in (ref.bracket.hyperband_bracket(i, 1, 9, 3) for i in range(4))
    ]
    assert [(list(p.num_configs), list(p.budgets)) for p in
            (hyperband_bracket(i, 1, 9, 3) for i in range(4))] == [
        (it.num_configs, it.budgets) for it in opt.iterations]
    assert _runs_per_budget(res) == _expected_runs_per_budget(4, 9.0)
    assert np.isfinite([r.loss for r in res.get_all_runs()]).all()
