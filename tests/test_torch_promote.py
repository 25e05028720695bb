"""The port's promotion rules (``hpbandster_tpu_torch.promote``) and the
Pareto functions of ``ops/bracket.py`` against the reference's.

* The Pareto rank and mask, on the tensor's device and on the host, equal
  the reference's jnp and numpy versions exactly on seeded objectives with
  NaN losses, NaN costs and ties.
* The reference's unit cases of ``tests/test_promote.py`` (ASHA, Pareto,
  learning-curve early stop, the rule registry, the promotion metric
  family, the replay harness) run on the port's classes and on the
  reference's, which must end in the same state.
* Over the host tier (the reference's ``TestASHAEndToEnd``): ASHA and the
  synchronous rule over the Dispatcher with paced workers, a straggler
  delaying one of two.
* End to end: ``BOHB(promotion_rule=r)`` for every rule on
  ``BatchedExecutor(VmapBackend(branin))`` on the CPU, with the reference's
  candidates fed through the draw seam, runs what the reference runs,
  journals the same ``promotion_decision`` records, and ``replay_records``
  gives byte-identical output in both packages on either journal; the two
  journals of one run replay alike within the loss tolerance.

Costs in ``promotion_decision`` records are timings (wall spans or the
run-time histogram's bucket), so they are compared by structure only;
losses agree within ``LOSS_ATOL``/``LOSS_RTOL`` (ROADMAP C.15).
"""

import importlib
import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.core.iteration import Status
from hpbandster_tpu_torch.core.job import Job
from hpbandster_tpu_torch.core.nameserver import NameServer
from hpbandster_tpu_torch.core.worker import Worker
from hpbandster_tpu_torch.ops import bracket as port_bracket
from hpbandster_tpu_torch.optimizers import BOHB
from hpbandster_tpu_torch.parallel import BatchedExecutor, VmapBackend
from hpbandster_tpu_torch.parallel.dispatcher import Dispatcher
from hpbandster_tpu_torch.promote import RULE_NAMES, resolve_rule
from hpbandster_tpu_torch.promote.asha import ASHAIteration
from hpbandster_tpu_torch.promote.earlystop import LCEarlyStopIteration
from hpbandster_tpu_torch.promote.pareto import ParetoIteration
from hpbandster_tpu_torch.promote.replay import (
    _hindsight,
    format_replay,
    promotion_waits,
    replay_records,
    worker_utilization,
)
from hpbandster_tpu_torch.space import ConfigurationSpace, UniformFloatHyperparameter
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_harness import REPO, ReferenceKDEDraws, ref, ref_opt  # noqa: F401

LOSS_ATOL = LOSS_RTOL = 1e-4
REPLAY_RULES = ("successive_halving", "asha", "pareto", "lc_earlystop")


@pytest.fixture(scope="module")
def ref_promote(ref, ref_opt):  # noqa: F811
    """The reference's obs, promote and export modules, imported inside the
    ``ref`` window and removed with it."""
    names = {"obs": "obs", "export": "obs.export", "promote": "promote",
             "asha": "promote.asha", "pareto": "promote.pareto",
             "earlystop": "promote.earlystop", "replay": "promote.replay",
             "iteration": "core.iteration", "job": "core.job"}
    return SimpleNamespace(**{
        k: importlib.import_module(f"hpbandster_tpu.{m}") for k, m in names.items()})


def packages(ref_promote):
    """The unit cases' classes in either package."""
    port = SimpleNamespace(Job=Job, Status=Status, ASHA=ASHAIteration,
                           Pareto=ParetoIteration, LC=LCEarlyStopIteration, obs=obs)
    r = ref_promote
    theirs = SimpleNamespace(Job=r.job.Job, Status=r.iteration.Status,
                             ASHA=r.asha.ASHAIteration, Pareto=r.pareto.ParetoIteration,
                             LC=r.earlystop.LCEarlyStopIteration, obs=r.obs)
    return {"port": port, "ref": theirs}


# ------------------------------------------------------------------ Pareto
def _objectives(seed, n, m):
    rng = np.random.default_rng(seed)
    obj = rng.uniform(size=(n, m)).astype(np.float32)
    obj[:, 0] = np.round(obj[:, 0], 1)  # ties in the loss
    obj[rng.uniform(size=n) < 0.15, 0] = np.nan  # crashed rows
    if m > 1:
        obj[rng.uniform(size=n) < 0.15, 1] = np.nan  # unmeasured costs
    if n > 1:
        obj[1] = obj[0]  # a duplicate row
    return obj


@pytest.mark.parametrize("seed,n,m", [(0, 1, 2), (1, 9, 2), (2, 27, 2), (3, 81, 3),
                                      (4, 40, 1), (5, 200, 2)])
def test_pareto_matches_reference(ref, seed, n, m):  # noqa: F811
    """``pareto_rank`` / ``pareto_promotion_mask`` on the tensor's device and
    their numpy twins equal the reference's jnp and numpy versions exactly,
    at every k."""
    import jax.numpy as jnp

    obj = _objectives(seed, n, m)
    want_rank = np.asarray(ref.bracket.pareto_rank(jnp.asarray(obj)))
    np.testing.assert_array_equal(ref.bracket.pareto_rank_np(obj), want_rank)
    np.testing.assert_array_equal(port_bracket.pareto_rank_np(obj), want_rank)
    np.testing.assert_array_equal(
        port_bracket.pareto_rank(torch.from_numpy(obj)).numpy(), want_rank)
    for k in sorted({0, 1, n // 3, n // 2, n}):
        want = np.asarray(ref.bracket.pareto_promotion_mask(jnp.asarray(obj), k))
        np.testing.assert_array_equal(ref.bracket.pareto_promotion_mask_np(obj, k), want)
        np.testing.assert_array_equal(port_bracket.pareto_promotion_mask_np(obj, k), want)
        got = port_bracket.pareto_promotion_mask(torch.from_numpy(obj), k)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
    if m == 1:  # one objective: the successive-halving rule
        np.testing.assert_array_equal(
            port_bracket.pareto_promotion_mask_np(obj, n // 3),
            port_bracket.sh_promotion_mask_np(obj[:, 0], n // 3) & ~np.isnan(obj[:, 0]))


# ------------------------------------------------------------------- units
def _sampler_factory():
    counter = {"n": 0}

    def sampler(budget):
        counter["n"] += 1
        return {"x": float(counter["n"])}, {}

    return sampler, counter


def _finish(P, it, config_id, budget, loss=None, exception=None, cost=None):
    job = P.Job(config_id, config=it.data[config_id].config, budget=budget)
    job.time_it("submitted").time_it("started").time_it("finished")
    if exception is None:
        job.result = {"loss": loss, "info": {"cost": cost} if cost is not None else {}}
    else:
        job.result = None
        job.exception = exception
    it.register_result(job)
    it.process_results()


def _state(it):
    return {cid: (d.status.name, d.budget, dict(d.results), d.config["x"])
            for cid, d in it.data.items()}


def _asha_partial_rung(P):
    it = P.ASHA(0, [9, 3, 1], [1.0, 3.0, 9.0], _sampler_factory()[0], eta=3)
    runs = [it.get_next_run() for _ in range(3)]
    assert all(r[2] == 1.0 for r in runs)
    _finish(P, it, runs[0][0], 1.0, 3.0)
    _finish(P, it, runs[1][0], 1.0, 1.0)
    # 2 of 9 done: floor(2/3) = 0, nothing promotable yet
    assert not any(d.status == P.Status.QUEUED and d.budget == 3.0 for d in it.data.values())
    _finish(P, it, runs[2][0], 1.0, 4.0)
    # 3 done: the best of the completed subset promotes, 6 still outstanding
    assert [c for c, d in it.data.items()
            if d.status == P.Status.QUEUED and d.budget == 3.0] == [runs[1][0]]
    return it


def _asha_promotion_first(P):
    sampler, counter = _sampler_factory()
    it = P.ASHA(0, [9, 3, 1], [1.0, 3.0, 9.0], sampler, eta=3)
    runs = [it.get_next_run() for _ in range(3)]
    for r, loss in zip(runs, [3.0, 1.0, 4.0]):
        _finish(P, it, r[0], 1.0, loss)
    sampled = counter["n"]
    nxt = it.get_next_run()
    # the promoted config's budget-3 job, not a fresh rung-0 sample
    assert nxt[0] == runs[1][0] and nxt[2] == 3.0 and counter["n"] == sampled
    return it


def _asha_crashes(P):
    it = P.ASHA(0, [3, 1], [1.0, 3.0], _sampler_factory()[0], eta=3)
    runs = [it.get_next_run() for _ in range(3)]
    _finish(P, it, runs[0][0], 1.0, exception="boom")
    _finish(P, it, runs[1][0], 1.0, 0.5)
    _finish(P, it, runs[2][0], 1.0, 0.7)
    assert [c for c, d in it.data.items() if d.budget == 3.0] == [runs[1][0]]
    nxt = it.get_next_run()
    _finish(P, it, nxt[0], 3.0, 0.4)
    assert it.is_finished
    assert [it.data[r[0]].status for r in runs] == [
        P.Status.CRASHED, P.Status.COMPLETED, P.Status.TERMINATED]
    return it


def _asha_contains_sync_topk(P):
    it = P.ASHA(0, [9, 3, 1], [1.0, 3.0, 9.0], _sampler_factory()[0], eta=3)
    losses = [5.0, 2.0, 8.0, 1.0, 9.0, 3.0, 7.0, 4.0, 6.0]
    runs = [it.get_next_run() for _ in range(9)]
    for r, loss in zip(runs, losses):
        _finish(P, it, r[0], 1.0, loss)
    promoted = {c for c, d in it.data.items() if d.budget == 3.0}
    assert {r[0] for r, l in zip(runs, losses) if l in sorted(losses)[:3]} <= promoted
    return it


def _asha_eta_from_ladder(P):
    it = P.ASHA(0, [9, 3, 1], [1.0, 3.0, 9.0], _sampler_factory()[0])
    assert it.eta == pytest.approx(3.0)
    return it


def _pareto_front(P):
    costs = {1.0: 1.0, 2.0: 4.0, 3.0: 0.1, 4.0: 5.0}
    it = P.Pareto(0, [4, 2, 1], [1.0, 3.0, 9.0], _sampler_factory()[0],
                  cost_fn=lambda datum, budget: costs[datum.config["x"]])
    runs = [it.get_next_run() for _ in range(4)]
    for r, loss in zip(runs, [0.2, 0.3, 0.9, 1.0]):
        _finish(P, it, r[0], 1.0, loss)
    assert {d.config["x"] for d in it.data.values() if d.budget == 3.0} == {1.0, 3.0}
    return it


def _pareto_reported_costs(P):
    # no cost_fn, no obs feed: the costs the evaluations reported rank
    it = P.Pareto(0, [3, 1], [1.0, 3.0], _sampler_factory()[0], obs_cost=False)
    runs = [it.get_next_run() for _ in range(3)]
    for r, loss, cost in zip(runs, [0.2, 0.3, 0.25], [5.0, 0.1, 1.0]):
        _finish(P, it, r[0], 1.0, loss, cost=cost)
    assert it.reported_cost(runs[1][0], 1.0) == 0.1
    return it


def _lc_hopeless(P):
    it = P.LC(0, [3, 2, 1], [1.0, 3.0, 9.0], _sampler_factory()[0],
              cut_fn=lambda target: 0.05)
    runs = [it.get_next_run() for _ in range(3)]
    for r, loss in zip(runs, [0.04, 0.5, 0.6]):
        _finish(P, it, r[0], 1.0, loss)
    promoted = [d for d in it.data.values() if d.budget == 3.0]
    assert len(promoted) == 1 and promoted[0].config["x"] == 1.0
    return it


def _lc_without_cut(P):
    it = P.LC(0, [3, 2, 1], [1.0, 3.0, 9.0], _sampler_factory()[0])
    runs = [it.get_next_run() for _ in range(3)]
    for r, loss in zip(runs, [0.3, 0.1, 0.9]):
        _finish(P, it, r[0], 1.0, loss)
    assert {d.config["x"] for d in it.data.values() if d.budget == 3.0} == {1.0, 2.0}
    return it


UNIT_CASES = {
    "asha_promotes_on_partial_rung": _asha_partial_rung,
    "asha_promotion_dispatches_before_fresh_samples": _asha_promotion_first,
    "asha_crashes_never_promote_and_finalize": _asha_crashes,
    "asha_full_rung_contains_sync_topk": _asha_contains_sync_topk,
    "asha_eta_from_budget_ladder": _asha_eta_from_ladder,
    "pareto_hand_built_front": _pareto_front,
    "pareto_reported_costs_rank": _pareto_reported_costs,
    "lc_hopeless_config_terminated": _lc_hopeless,
    "lc_without_cut_is_sync_topk": _lc_without_cut,
}


@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_rule_units_match_reference(ref_promote, case, tmp_path):
    """Each unit case passes on the port's class and on the reference's,
    the two end in the same bracket state, and their journals hold the same
    promotion records (costs compared by value: here they come from
    ``cost_fn`` or the reported ``cost``, or are wall spans)."""
    states, records = {}, {}
    for name, P in packages(ref_promote).items():
        path = str(tmp_path / f"{name}.jsonl")
        handle = P.obs.configure(journal_path=path)
        try:
            it = UNIT_CASES[case](P)
        finally:
            handle.close()
        states[name] = _state(it)
        records[name] = [_decision_view(r, costs=it.promotion_rule == "pareto")
                         for r in obs.read_journal(path)
                         if r["event"] in ("promotion_decision", "bracket_promotion")]
    assert states["port"] == states["ref"]
    assert records["port"] == records["ref"]


def test_pareto_audit_record_carries_ranks_and_costs(tmp_path):
    path = str(tmp_path / "j.jsonl")
    handle = obs.configure(journal_path=path)
    try:
        it = ParetoIteration(0, [2, 1], [1.0, 3.0], _sampler_factory()[0],
                             cost_fn=lambda d, b: d.config["x"])
        runs = [it.get_next_run() for _ in range(2)]
        _finish(SimpleNamespace(Job=Job), it, runs[0][0], 1.0, 0.5)
        _finish(SimpleNamespace(Job=Job), it, runs[1][0], 1.0, 0.9)
    finally:
        handle.close()
    (promo,) = [r for r in obs.read_journal(path) if r["event"] == "promotion_decision"]
    assert promo["rule"] == "pareto"
    assert promo["pareto_rank"] == [0, 1] and promo["costs"] == [1.0, 2.0]


def test_pareto_cost_feed_order():
    """``cost_fn`` > reported cost > the registry's budget-keyed run-time
    histogram (once it holds ``COST_FEED_MIN_COUNT`` observations, resolved
    once per budget) > the wall span."""
    registry = obs.MetricsRegistry()
    it = ParetoIteration(0, [2, 1], [1.0, 3.0], _sampler_factory()[0],
                         cost_registry=registry)
    a, b = (it.get_next_run() for _ in range(2))
    _finish(SimpleNamespace(Job=Job), it, a[0], 1.0, 0.5, cost=7.0)
    assert it.promotion_cost(a[0], 1.0) == 7.0
    assert it.wall_span_cost(a[0], 1.0) is not None
    # b has not run: no reported cost, no feed, no span
    assert it.promotion_cost(b[0], 1.0) is None
    hist = registry.histogram("master.job_run_s.b1")
    for _ in range(7):
        hist.observe(0.02)
    it._feed_cache = None
    assert it._obs_feed(1.0) is None  # 7 < 8 observations: no feed yet
    hist.observe(0.02)
    it._feed_cache = None
    assert it._obs_feed(1.0) == 0.05  # the p50 bucket's upper bound
    hist.observe(100.0)
    assert it._obs_feed(1.0) == 0.05  # cached for this budget
    fixed = ParetoIteration(0, [2, 1], [1.0, 3.0], _sampler_factory()[0],
                            cost_fn=lambda d, bgt: 3.0, cost_registry=registry)
    c = fixed.get_next_run()
    assert fixed.promotion_cost(c[0], 1.0) == 3.0


# ------------------------------------------------------------ rule registry
class _NullExecutor:
    """An executor for wiring checks that never run jobs."""

    def __init__(self):
        self.started = []

    def start(self, new_result_callback, new_worker_callback):
        self.started.append(True)

    def number_of_workers(self):
        return 1

    def submit_job(self, job):  # pragma: no cover
        raise AssertionError("a wiring check must not submit")

    def shutdown(self, shutdown_workers=False):
        pass


def test_rule_registry_matches_reference(ref_promote):
    """The same vocabulary as the reference, each name resolving to the
    port's class of the reference's name; an unknown name is refused with
    the vocabulary."""
    from hpbandster_tpu_torch.core.successive_halving import (
        JaxSuccessiveHalving,
        SuccessiveHalving,
    )

    assert RULE_NAMES == ref_promote.promote.RULE_NAMES
    for name in RULE_NAMES:
        cls = resolve_rule(name)
        assert cls.__module__.startswith("hpbandster_tpu_torch.")
        assert cls.__name__ == ref_promote.promote.resolve_rule(name).__name__
    assert resolve_rule("sync") is SuccessiveHalving
    assert resolve_rule("successive_halving_jax") is JaxSuccessiveHalving
    assert resolve_rule("asha") is ASHAIteration
    with pytest.raises(ValueError, match="asha"):
        resolve_rule("warp_speed")


def test_promote_package_module_is_stdlib_only():
    """``promote/__init__.py`` loaded on its own imports neither torch nor
    numpy (rule names validate without the implementations)."""
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('p', r'{REPO}/hpbandster_tpu_torch/promote/__init__.py')\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        "assert 'asha' in mod.RULE_NAMES\n"
        "sys.exit(1 if ('torch' in sys.modules or 'numpy' in sys.modules) else 0)\n"
    )
    assert subprocess.run([sys.executable, "-c", code], timeout=60).returncode == 0


@pytest.mark.parametrize("rule", RULE_NAMES)
def test_bohb_promotion_rule_selects_iteration_class(rule):
    """``BOHB(promotion_rule=r)`` builds the rule's iteration class with what
    it asks for: ``eta`` (ASHA), the optimizer's incumbent reader as
    ``cut_fn`` (early stopping), the optimizer's device (the device rule)."""
    cs = branin_space(seed=1)
    opt = BOHB(configspace=cs, run_id="pr", executor=_NullExecutor(), min_budget=1,
               max_budget=9, eta=3, promotion_rule=rule, device="cpu")
    try:
        assert opt.iteration_class is resolve_rule(rule)
        assert opt.promotion_rule == rule == opt.config["promotion_rule"]
        it = opt.get_next_iteration(0, {})
        assert isinstance(it, resolve_rule(rule))
        if rule == "asha":
            assert it.eta == pytest.approx(3.0)
        if rule == "lc_earlystop":
            assert it.cut_fn == opt.best_loss_at
        if rule == "successive_halving_jax":
            assert it.device.type == "cpu"
    finally:
        opt.shutdown()


def test_invalid_rule_rejected_before_executor_starts():
    ex = _NullExecutor()
    with pytest.raises(ValueError, match="unknown promotion rule"):
        BOHB(configspace=branin_space(seed=1), run_id="bad", executor=ex,
             min_budget=1, max_budget=9, eta=3, promotion_rule="ahsa", device="cpu")
    assert ex.started == []


# ------------------------------------------------------ promotion metrics
def test_promotion_metric_family(ref_promote):
    """``emit_bracket_promotion`` advances ``bracket.promotions.<rule>.<rung>``
    by the promoted count, a name the reference's exporter parses into the
    ``rule`` and ``rung`` labels."""
    name = "bracket.promotions.test_rule_xyz.1"
    before = obs.get_metrics().counter(name).value
    obs.emit_bracket_promotion(0, 1, "test_rule_xyz", promoted=3, candidates=9,
                               budget=1.0, next_budget=3.0)
    assert obs.get_metrics().counter(name).value - before == 3
    fam, labels = ref_promote.export.metric_family(name)
    assert fam == "hpbandster_bracket_promotions"
    assert labels == {"rule": "test_rule_xyz", "rung": "1"}


# ------------------------------------------------------------- end to end
def _decision_view(rec, costs=False):
    """A promotion record without its stamps and timings: costs keep their
    structure (present, count, None where unmeasured) unless ``costs``."""
    out = {k: v for k, v in rec.items()
           if k not in ("t_wall", "t_mono", "host", "pid", "trace_id", "costs")}
    if "costs" in rec:
        out["costs"] = rec["costs"] if costs else [c is None for c in rec["costs"]]
    return out


def _close_losses(a, b):
    """Two records' loss lists agree within the loss tolerance."""
    for key in ("losses", "survivor_losses"):
        x = np.array([np.nan if v is None else v for v in a.pop(key)], np.float64)
        y = np.array([np.nan if v is None else v for v in b.pop(key)], np.float64)
        np.testing.assert_allclose(x, y, atol=LOSS_ATOL, rtol=LOSS_RTOL)
    for key in ("cut_threshold",):
        x, y = a.pop(key), b.pop(key)
        assert (x is None) == (y is None)
        if x is not None:
            assert abs(x - y) <= LOSS_ATOL + LOSS_RTOL * abs(y)
    if "scores" in a or "scores" in b:
        x = np.array([np.nan if v is None else v for v in a.pop("scores")], np.float64)
        y = np.array([np.nan if v is None else v for v in b.pop("scores")], np.float64)
        np.testing.assert_allclose(x, y, atol=LOSS_ATOL, rtol=LOSS_RTOL)


def _assert_close(a, b):
    """Two replay reports equal but for floats within the loss tolerance."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_close(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_close(x, y)
    elif isinstance(a, float) and isinstance(b, float):
        assert abs(a - b) <= LOSS_ATOL + LOSS_RTOL * abs(b), (a, b)
    else:
        assert a == b


def _rule_run(ref, ref_opt, ref_promote, rule, tmp_path, package):  # noqa: F811
    """One ``BOHB(promotion_rule=rule)`` run of Branin at budgets 1..9, 4
    iterations, seed 0, journaled; the metrics registry is emptied first,
    so the run-time histograms (Pareto's cost feed) hold this run only."""
    path = str(tmp_path / f"{package}-{rule}.jsonl")
    if package == "ref":
        o = ref_promote.obs
        cs = ref.toys.branin_space(seed=0)
        ex = ref_opt.parallel.BatchedExecutor(
            ref_opt.parallel.VmapBackend(ref.toys.branin_from_vector), cs,
            bucket_brackets=False)
        kw = {}
        cls = ref_opt.optimizers.BOHB
    else:
        o = obs
        cs = branin_space(seed=0)
        ex = BatchedExecutor(VmapBackend(branin, device="cpu"), cs)
        kw = {"device": "cpu"}
        cls = BOHB
    o.get_metrics().reset()
    opt = cls(configspace=cs, run_id="rule", executor=ex, min_budget=1, max_budget=9,
              eta=3, seed=0, min_points_in_model=4, promotion_rule=rule, **kw)
    if package == "port":
        opt.config_generator.draws = ReferenceKDEDraws(ref, trickle_seed=0)
    handle = o.configure(journal_path=path)
    try:
        res = opt.run(n_iterations=4)
    finally:
        handle.close()
        opt.shutdown()
    return opt, res, obs.read_journal(path)


@pytest.mark.parametrize("rule", RULE_NAMES)
def test_rule_runs_match_reference(ref, ref_opt, ref_promote, rule, tmp_path):  # noqa: F811
    """Every rule end to end against the reference run for run: the same
    configs and budgets, the same fused brackets and evaluations, equal
    ``promotion_decision`` records, and byte-identical replays in both
    packages over both journals."""
    from tests.test_torch_e2e_batched import _assert_same_runs

    opt_r, res_r, rec_r = _rule_run(ref, ref_opt, ref_promote, rule, tmp_path, "ref")
    opt, res, rec = _rule_run(ref, ref_opt, ref_promote, rule, tmp_path, "port")
    _assert_same_runs(res_r, res)
    # ASHA may over-promote (an early promotion that later leaves the top
    # 1/eta keeps its slot); the barrier rules run the HyperBand plan
    n_evals = opt_r.executor.total_evaluated
    assert opt.executor.total_evaluated == n_evals
    assert n_evals >= 35 if rule == "asha" else n_evals == 35
    assert opt.executor.fused_brackets_run == opt_r.executor.fused_brackets_run == 3
    assert [type(it).__name__ for it in opt.iterations] == [
        type(it).__name__ for it in opt_r.iterations]

    def decisions(records):
        out = []
        for r in records:
            if r["event"] != "promotion_decision":
                continue
            view = _decision_view(r)
            if r["rule"] == "pareto" and len(set(r["costs"])) > 1:
                # a Pareto rung ranked on wall spans (under 8 runs at its
                # budget): the domination counts are timings, the mask (a
                # top-1 here) is not
                assert r["n_promoted"] <= 1, r
                view.pop("scores", None)
                view.pop("pareto_rank", None)
            out.append(view)
        return out

    got, want = decisions(rec), decisions(rec_r)
    assert got and len(got) == len(want)
    for a, b in zip(got, want):
        _close_losses(a, b)
        assert a == b
    names = [r["event"] for r in rec]
    assert names.count("bracket_created") == 4
    assert names.count("job_finished") + names.count("job_failed") == n_evals
    assert names.count("config_sampled") == sum(len(it.data) for it in opt.iterations)

    for records in (rec, rec_r):
        for replay_rule in REPLAY_RULES:
            mine = replay_records(records, replay_rule)
            theirs = ref_promote.replay.replay_records(records, replay_rule)
            assert json.dumps(mine, sort_keys=True) == json.dumps(theirs, sort_keys=True)
            assert format_replay(mine) == ref_promote.replay.format_replay(theirs)
        assert promotion_waits(records) == ref_promote.replay.promotion_waits(records)
    # the same run's two journals replay alike: the losses within tolerance
    # (Pareto replays rank on the journaled costs, which are timings)
    for replay_rule in ("successive_halving", "asha", "lc_earlystop"):
        _assert_close(replay_records(rec, replay_rule), replay_records(rec_r, replay_rule))
    # the config lineages of both journals tell the same story
    lin, lin_r = obs.config_lineage(rec), obs.config_lineage(rec_r)
    assert set(lin) == set(lin_r)
    for key in lin:
        assert lin[key]["rungs"] == lin_r[key]["rungs"], key
        assert sorted(lin[key]["results"]) == sorted(lin_r[key]["results"])


# ------------------------------------------------------------------ replay
@pytest.fixture(scope="module")
def journal_records(tmp_path_factory, ref):  # noqa: F811
    """The journal of one sync BOHB run of the port (budgets 1..27)."""
    path = str(tmp_path_factory.mktemp("replay") / "j.jsonl")
    cs = branin_space(seed=5)
    opt = BOHB(configspace=cs, run_id="replay",
               executor=BatchedExecutor(VmapBackend(branin, device="cpu"), cs),
               min_budget=1, max_budget=27, eta=3, seed=5, min_points_in_model=4,
               device="cpu")
    with obs.configure(journal_path=path):
        opt.run(n_iterations=4)
    opt.shutdown()
    return obs.read_journal(path)


@pytest.mark.parametrize("rule", REPLAY_RULES)
def test_replay_byte_identical_and_equal_to_reference(journal_records, ref_promote, rule):
    rep_a = replay_records(journal_records, rule)
    rep_b = replay_records(journal_records, rule)
    assert json.dumps(rep_a, sort_keys=True) == json.dumps(rep_b, sort_keys=True)
    assert format_replay(rep_a) == format_replay(rep_b)
    assert rep_a["aggregate"]["decisions"] >= 2
    theirs = ref_promote.replay.replay_records(journal_records, rule)
    assert json.dumps(rep_a, sort_keys=True) == json.dumps(theirs, sort_keys=True)


def test_replay_identity_asha_floor_and_unknown(journal_records):
    rep = replay_records(journal_records, "successive_halving")
    assert rep["aggregate"]["decisions_changed"] == 0
    assert rep["aggregate"]["configs_changed"] == 0
    for row in rep["decisions"]:
        assert row["regret_delta"] in (0.0, None)
        assert row["inversion_delta"] in (0, None)
    for row in replay_records(journal_records, "asha", eta=3.0)["decisions"]:
        assert row["n_promoted_replay"] <= row["n_candidates"] // 3 + 1
    with pytest.raises(ValueError, match="unknown promotion rule"):
        replay_records(journal_records, "warp_speed")
    # ported: the fleet's busy fraction from summarize's aggregation
    util = worker_utilization(journal_records)
    assert set(util) == {"window_s", "per_worker", "busy_fraction"}


def test_tied_scores_do_not_fake_zero_regret():
    """Pareto's domination counts tie across a front: the hindsight
    tie-break is candidate order, not the next loss."""
    lineages = {
        (0, 0, 0): {"sampled": None, "results": {3.0: 0.9}, "rungs": []},
        (0, 0, 1): {"sampled": None, "results": {3.0: 0.1}, "rungs": []},
    }
    out = _hindsight([(0, 0, 0), (0, 0, 1)], [0.0, 0.0], [True, True], 3.0, lineages)
    assert out["rank1_regret"] == pytest.approx(0.8)
    assert out["inversions"] == 1


class TestStragglerAuditLoop:
    """The reference's straggler ledger cases on the port's obs layer: a
    flagged config rides the next promotion decision of its rung, run and
    tenant, and the live detector feeds the ledger."""

    def test_flagged_config_rides_next_promotion_decision(self, tmp_path):
        journal = str(tmp_path / "j.jsonl")
        handle = obs.configure(journal_path=journal)
        try:
            obs.note_straggler((0, 0, 1))
            obs.note_straggler((7, 0, 0))  # another rung's straggler
            obs.emit_promotion_decision(
                0, 0, 1.0, 3.0,
                config_ids=[(0, 0, 0), (0, 0, 1)],
                losses=[0.5, 0.9], promoted=[True, False],
            )
            obs.emit_promotion_decision(
                0, 1, 3.0, 9.0,
                config_ids=[(0, 0, 0)], losses=[0.4], promoted=[True],
            )
        finally:
            handle.close()
        promos = [
            r for r in obs.read_journal(journal)
            if r["event"] == "promotion_decision"
        ]
        assert promos[0]["straggler_observed"] == [[0, 0, 1]]
        # drained: the marker rides exactly one record; the foreign
        # rung's marker does not leak into an unrelated decision
        assert "straggler_observed" not in promos[1]
        # report surfaces the correlation on the decision row
        from hpbandster_tpu_torch.obs.report import build_report

        rep = build_report(obs.read_journal(journal))
        rows = rep["promotion_regret"]["decisions"]
        assert rows[0]["stragglers_observed"] == 1
        assert rows[1]["stragglers_observed"] == 0
        # cleanup: the unmatched (7,0,0) marker must not leak into
        # other tests' process-global ledger
        obs.drain_stragglers([(7, 0, 0)])

    def test_ledger_scoped_by_budget_rung(self):
        # under ASHA a config promoted from rung 0 and flagged while
        # running at budget 3 appears in BOTH rungs' candidate censuses;
        # the marker must ride the rung that actually stalled
        obs.note_straggler((0, 0, 2), budget=3.0)
        assert obs.drain_stragglers([(0, 0, 2)], budget=1.0) == []
        assert obs.drain_stragglers([(0, 0, 2)], budget=3.0) == [(0, 0, 2)]
        # budget-less notes (hand-rolled / foreign journals) wildcard
        obs.note_straggler((0, 0, 9))
        assert obs.drain_stragglers([(0, 0, 9)], budget=1.0) == [(0, 0, 9)]

    def test_ledger_scoped_by_run_and_tenant(self):
        # config-id triples restart at (0,0,0) every sweep: a marker
        # noted in one run (or tenant) must not drain into another's
        # promotion decision — the bench's sequential sync/asha pairing
        # and concurrent serve tenants both depend on it
        with obs.use_run("run-a"):
            obs.note_straggler((0, 0, 3))
        with obs.use_tenant("acme"):
            obs.note_straggler((0, 0, 4))
        with obs.use_run("run-b"):
            assert obs.drain_stragglers([(0, 0, 3)]) == []
        with obs.use_tenant("bob"):
            assert obs.drain_stragglers([(0, 0, 4)]) == []
        with obs.use_run("run-a"):
            assert obs.drain_stragglers([(0, 0, 3)]) == [(0, 0, 3)]
        with obs.use_tenant("acme"):
            assert obs.drain_stragglers([(0, 0, 4)]) == [(0, 0, 4)]
        # inside a job's trace the run identity comes from the trace
        # itself — the path the anomaly detector notes through
        with obs.use_trace(obs.new_trace("run-c")):
            obs.note_straggler((0, 0, 5))
        assert obs.drain_stragglers([(0, 0, 5)]) == []
        with obs.use_run("run-c"):
            assert obs.drain_stragglers([(0, 0, 5)]) == [(0, 0, 5)]

    def test_live_detector_feeds_ledger(self):
        from hpbandster_tpu_torch.obs.anomaly import AnomalyDetector, AnomalyRules

        det = AnomalyDetector(
            rules=AnomalyRules(
                straggler_min_samples=3, straggler_factor=2.0,
                cooldown_s=0.0,
            ),
            bus=obs.get_bus(),
        )
        base = {"event": "job_finished", "budget": 1.0, "loss": 0.5,
                "t_wall": 1.0, "t_mono": 1.0}
        for i in range(4):
            det.process(dict(base, run_s=0.1, config_id=[0, 0, i]))
        fired = det.process(
            dict(base, run_s=30.0, config_id=[0, 0, 9])
        )
        assert fired and fired[0]["rule"] == "straggler"
        assert obs.drain_stragglers([(0, 0, 9)]) == [(0, 0, 9)]


# ------------------------------------------------- over the host tier
class _PacedWorker(Worker):
    """Budget-independent loss (promotion parity needs rank stability
    across budgets) with optional injected per-evaluation delay."""

    straggle_s = 0.0

    def compute(self, config_id, config, budget, working_directory):
        if self.straggle_s:
            time.sleep(self.straggle_s)
        x = float(config["x"])
        return {"loss": (x - 0.37) ** 2, "info": {}}


def _space(seed):
    cs = ConfigurationSpace(seed=seed)
    cs.add_hyperparameter(UniformFloatHyperparameter("x", 0.0, 1.0))
    return cs


def _run_sweep(seed, rule, n_workers=1, straggler_s=0.0, journal=None,
               anomaly=None):
    handle = (
        obs.configure(journal_path=journal, anomaly=anomaly)
        if journal else None
    )
    run_id = f"promote-e2e-{seed}-{rule or 'sync'}"
    ns = NameServer(run_id=run_id, host="127.0.0.1", port=0)
    host, port = ns.start()
    opt = None
    try:
        for i in range(n_workers):
            w = _PacedWorker(
                run_id=run_id, nameserver=host, nameserver_port=port, id=i,
            )
            if i == 0:
                w.straggle_s = straggler_s
            w.run(background=True)
        d = Dispatcher(
            run_id=run_id, nameserver=host, nameserver_port=port,
            ping_interval=0.1, discover_interval=0.1,
        )
        opt = BOHB(
            configspace=_space(seed), run_id=run_id, executor=d,
            min_budget=1, max_budget=9, eta=3, seed=seed,
            min_points_in_model=10_000,  # pure seeded sampling
            promotion_rule=rule, device="cpu",
        )
        res = opt.run(n_iterations=1, min_n_workers=n_workers)
        return res
    finally:
        if opt is not None:
            opt.shutdown(shutdown_workers=True)
        ns.shutdown()
        if handle is not None:
            handle.close()


class TestASHAEndToEnd:
    """The reference's ``TestASHAEndToEnd`` over the port's host tier: a
    ``NameServer``, paced ``Worker`` threads and the ``Dispatcher``."""

    def test_parity_with_sync_on_straggler_free_run(self):
        """Acceptance: zero stragglers -> the ASHA sweep's final
        incumbent matches the synchronous sweep on the same seed."""
        res_sync = _run_sweep(11, None)
        res_asha = _run_sweep(11, "asha")
        inc_sync = res_sync.get_incumbent_id()
        inc_asha = res_asha.get_incumbent_id()
        assert inc_sync is not None
        assert inc_asha == inc_sync
        loss_sync = res_sync.data[inc_sync].results[9.0]
        loss_asha = res_asha.data[inc_asha].results[9.0]
        assert loss_asha == pytest.approx(loss_sync)
        # same seeded rung-0 configs in both sweeps
        cfg_sync = {
            cid: d.config["x"] for cid, d in res_sync.data.items()
        }
        cfg_asha = {
            cid: d.config["x"] for cid, d in res_asha.data.items()
        }
        assert cfg_sync == cfg_asha

    def test_straggler_no_longer_stalls_sibling_promotions(self, tmp_path):
        """Acceptance: with one delayed worker, ASHA promotions proceed
        (higher-budget results land before the straggler's rung-0
        result), barrier stall ~ 0 vs sync's full-rung stall, and the
        exactly-once audit lineage stays duplicate-free."""
        from hpbandster_tpu_torch.obs.anomaly import AnomalyRules

        rules = AnomalyRules(
            straggler_min_samples=3, straggler_factor=2.0, cooldown_s=0.0,
        )
        j_sync = str(tmp_path / "sync.jsonl")
        j_asha = str(tmp_path / "asha.jsonl")
        _run_sweep(7, None, n_workers=2, straggler_s=0.5,
                   journal=j_sync, anomaly=rules)
        _run_sweep(7, "asha", n_workers=2, straggler_s=0.5,
                   journal=j_asha, anomaly=rules)
        rec_sync = obs.read_journal(j_sync)
        rec_asha = obs.read_journal(j_asha)

        def first_higher_before_last_low(records):
            last_low = None
            first_high = None
            for i, r in enumerate(records):
                if r.get("event") != "job_finished" or "loss" not in r:
                    continue
                if r.get("budget") == 1.0:
                    last_low = i
                elif first_high is None:
                    first_high = i
            return (
                first_high is not None and last_low is not None
                and first_high < last_low
            )

        # sync: the barrier forbids any budget-3 result before the rung
        # completes; asha: sibling promotions overtook the straggler
        assert not first_higher_before_last_low(rec_sync)
        assert first_higher_before_last_low(rec_asha)

        # measured barrier stall: under sync EVERY rung-0 promotion
        # waited ~ the straggler delay (the rung could not cut until the
        # delayed result landed); under asha the first promotion wave
        # fired the moment its quota opened — near-zero wait. (Later
        # asha waves can legitimately wait: floor(n_done/eta) grows with
        # completions, so the k-th promotion needs k*eta results — a
        # quota, not a barrier.)
        waits_sync = promotion_waits(rec_sync)
        waits_asha = promotion_waits(rec_asha)
        assert waits_sync["max_wait_s"] is not None
        assert waits_sync["max_wait_s"] > 0.25
        first_asha = waits_asha["per_decision"][0]
        assert first_asha["rung"] == 0
        assert first_asha["mean_wait_s"] < 0.2
        # worker utilization must not regress under async promotion
        util_sync = worker_utilization(rec_sync)["busy_fraction"]
        util_asha = worker_utilization(rec_asha)["busy_fraction"]
        assert util_sync is not None and util_asha is not None
        assert util_asha >= util_sync - 0.05

        # exactly-once lineage on the async journal: every submission
        # joined exactly one terminal result, no duplicates
        submitted, terminals = [], []
        for r in rec_asha:
            if r["event"] == "job_submitted":
                submitted.append((tuple(r["config_id"]), r["budget"]))
            elif r["event"] in ("job_finished", "job_failed") and "loss" in r:
                terminals.append((tuple(r["config_id"]), r["budget"]))
        assert len(submitted) == len(set(submitted))
        assert len(terminals) == len(set(terminals))
        assert set(submitted) == set(terminals)

        # asha decisions are journaled under their rule name
        asha_promos = [
            r for r in rec_asha if r.get("event") == "promotion_decision"
        ]
        assert asha_promos
        assert all(p["rule"] == "asha" for p in asha_promos)
