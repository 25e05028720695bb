"""The fused sweep's bulk replay into the ``Result``.

``ConfigurationSpace.from_vectors`` decodes a bracket's vectors a column at
a time and must equal ``from_vector`` row by row: values, Python types and
key order. ``_ReplayIteration.record_stage`` writes a whole stage of device
results at once and must leave the bookkeeping, the ``result_logger``'s
lines and the journal's records as the per-job replay did: the oracle here
is a copy of that loop (``_per_job_replay``), fed the same device outputs
as the bulk path, so only timestamps may differ.
"""

import math

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.core.iteration import Status
from hpbandster_tpu_torch.core.job import Job
from hpbandster_tpu_torch.optimizers.fused_bohb import (
    FusedBOHB,
    FusedH2BO,
    FusedHyperBand,
    FusedRandomSearch,
    _ReplayIteration,
)
from hpbandster_tpu_torch.space import (
    CategoricalHyperparameter,
    ConfigurationSpace,
    Constant,
    EqualsCondition,
    GreaterThanCondition,
    OrdinalHyperparameter,
    UniformFloatHyperparameter,
    UniformIntegerHyperparameter,
)
from hpbandster_tpu_torch.workloads.toys import branin, branin_space

OPTIMIZERS = [FusedBOHB, FusedHyperBand, FusedH2BO, FusedRandomSearch]


class _Halved(UniformFloatHyperparameter):
    """A subclass with its own decode: the column path must call it."""

    def from_unit(self, u):
        return 0.5 * super().from_unit(u)


def _every_kind(conditional: bool) -> ConfigurationSpace:
    cs = ConfigurationSpace(seed=0)
    cs.add_hyperparameters([
        UniformFloatHyperparameter("f", -2.0, 3.5),
        # lower + (upper - lower) rounds below upper for "g" and above it
        # for "e": u is clamped to [0, 1] before the scale and the value to
        # [lower, upper] after it, as from_unit does
        UniformFloatHyperparameter("g", -0.3, 0.9),
        UniformFloatHyperparameter("e", -3.0, 0.1),
        UniformFloatHyperparameter("lf", 1e-5, 1.0, log=True),
        UniformFloatHyperparameter("qf", 0.0, 10.0, q=0.5),
        UniformIntegerHyperparameter("i", -3, 17),
        UniformIntegerHyperparameter("li", 1, 1024, log=True),
        CategoricalHyperparameter("c", ["a", "b", 3, None]),
        OrdinalHyperparameter("o", [1, 2, 4, 8]),
        Constant("k", "const"),
        _Halved("h", 0.0, 1.0),
    ])
    if conditional:
        # children declared before their parents: _active_set orders keys
        cs.add_condition(EqualsCondition(cs.get_hyperparameter("f"),
                                         cs.get_hyperparameter("c"), "a"))
        cs.add_condition(GreaterThanCondition(cs.get_hyperparameter("qf"),
                                              cs.get_hyperparameter("o"), 2))
    return cs


def _edge_matrix(cs: ConfigurationSpace, n: int = 600) -> np.ndarray:
    """Uniform rows past the unit interval on both sides, choice indices
    past both ends and on their half-way points, NaN and inf cells, and
    whole rows at 0, 1, -0.0 and one ulp outside."""
    rng = np.random.default_rng(7)
    m = rng.uniform(-0.3, 1.3, size=(n, cs.dim))
    for j, hp in enumerate(cs.get_hyperparameters()):
        if hp.num_choices:
            m[:, j] = rng.uniform(-1.6, hp.num_choices + 0.6, n)
            m[:40, j] = np.arange(40) % (2 * hp.num_choices + 2) / 2 - 0.5
    m[rng.uniform(size=m.shape) < 0.08] = np.nan
    m[50:60:3] = np.inf
    m[61, ::2] = -np.inf
    m[62], m[63], m[64] = 0.0, 1.0, -0.0
    m[65] = np.nextafter(0.0, -1.0)
    m[66] = np.nextafter(1.0, 2.0)
    m[67] = 0.5
    return m


def _shape(cfg):
    """A config as what equality must hold on: each key in order, each
    value's repr (signed zeros differ) and its exact type."""
    return type(cfg), [(k, repr(v), type(v)) for k, v in cfg.items()]


@pytest.mark.parametrize("conditional", [False, True], ids=["plain", "conditional"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_from_vectors_equals_from_vector(conditional, dtype):
    cs = _every_kind(conditional)
    m = _edge_matrix(cs).astype(dtype)
    got = cs.from_vectors(m)
    want = [cs.from_vector(v) for v in m]
    assert [_shape(c) for c in got] == [_shape(c) for c in want]
    if conditional:
        # inactive children are dropped, as in from_vector
        assert any("f" not in c for c in got) and any("qf" not in c for c in got)
    assert any(len(c) < cs.dim - 2 for c in got)  # the non-finite cells


def test_from_vectors_shapes():
    cs = _every_kind(False)
    assert cs.from_vectors(np.zeros((0, cs.dim))) == []
    with pytest.raises(ValueError):
        cs.from_vectors(np.zeros(cs.dim))
    with pytest.raises(ValueError):
        cs.from_vectors(np.zeros((3, cs.dim + 1)))
    assert ConfigurationSpace().from_vectors(np.zeros((2, 0))) == [{}, {}]


# ------------------------------------------------------------ the replay
def _per_job_replay(self, b_i, plan, out, stages, job_info=None):
    """The per-job replay the bulk path replaced, verbatim but for the
    names it imports: one ``from_vector`` per config, one ``Job`` and one
    ``get_next_run`` / ``register_result`` per evaluation."""
    vectors = np.asarray(out.vectors)
    mb_mask = np.asarray(out.model_based)
    promotion_sets = [set(int(i) for i in idx) for idx, _ in stages[1:]]
    promotion_sets.append(set())

    def no_sampler(budget):
        raise RuntimeError("fused replay must not sample fresh configs")

    obs.emit_bracket_created(
        b_i, plan.num_configs, plan.budgets,
        eta=self.eta, random_fraction=self.random_fraction,
    )
    it = _ReplayIteration(
        HPB_iter=b_i,
        num_configs=list(plan.num_configs),
        budgets=list(plan.budgets),
        config_sampler=no_sampler,
        promotion_sets=promotion_sets,
        result_logger=self.result_logger,
    )
    self.iterations.append(it)
    for i in range(plan.num_configs[0]):
        cfg = dict(self.configspace.from_vector(vectors[i]))
        it.add_configuration(
            cfg,
            {
                "model_based_pick": bool(mb_mask[i]),
                "sample_reason": "fused_sweep",
                "fused_sweep": True,
            },
        )
    loss_of = [dict(zip(map(int, idx), map(float, losses))) for idx, losses in stages]
    stage_no = 0
    while True:
        nr = it.get_next_run()
        if nr is None:
            if not it.process_results():
                break
            stage_no += 1
            continue
        config_id, cfg, budget = nr
        job = Job(config_id, config=cfg, budget=budget,
                  working_directory=self.working_directory)
        job.time_it("submitted")
        job.time_it("started")
        loss = loss_of[stage_no][config_id[2]]
        if not np.isnan(loss):
            job.result = {"loss": loss, "info": dict(job_info or {})}
        else:
            job.result = None
            job.exception = f"non-finite loss {loss!r} at budget {budget}"
        job.time_it("finished")
        obs.emit(
            obs.JOB_FAILED if job.exception is not None else obs.JOB_FINISHED,
            config_id=list(config_id), budget=budget,
            loss=float(loss) if np.isfinite(loss) else None,
        )
        if self.result_logger is not None:
            self.result_logger(job)
        it.register_result(job)
        self.total_evaluated += 1


class _Lines:
    """A result logger that keeps what the JSONL logger would write, with
    the timestamps apart."""

    def __init__(self):
        self.lines, self.stamps = [], []

    def new_config(self, config_id, config, config_info):
        self.lines.append(("config", tuple(config_id), _shape(config), dict(config_info)))

    def __call__(self, job):
        self.lines.append(("result", job.id, sorted(job.kwargs), job.kwargs["budget"],
                           _shape(job.kwargs["config"]), job.result, job.exception))
        self.stamps.append(dict(job.timestamps))


def _mixed_space() -> ConfigurationSpace:
    cs = ConfigurationSpace(seed=0)
    x = UniformFloatHyperparameter("x", 0.0, 1.0)
    lr = UniformFloatHyperparameter("lr", 1e-4, 1.0, log=True)
    n = UniformIntegerHyperparameter("n", 1, 64, log=True)
    opt = CategoricalHyperparameter("opt", ["sgd", "adam"])
    mom = UniformFloatHyperparameter("momentum", 0.0, 0.99)
    depth = OrdinalHyperparameter("depth", [1, 2, 4, 8])
    cs.add_hyperparameters([x, lr, n, opt, mom, depth])
    cs.add_condition(EqualsCondition(mom, opt, "sgd"))
    return cs


def _crashing(loss_fn):
    """``loss_fn`` with NaN where the first dim is below 0.1 (a crash) and
    +inf above 0.9 (a diverged run, a valid result)."""

    def eval_fn(v, budget):
        loss = loss_fn(v, budget)
        loss = torch.where(v[:, 0] < 0.1, torch.full_like(loss, math.nan), loss)
        return torch.where(v[:, 0] > 0.9, torch.full_like(loss, math.inf), loss)

    return eval_fn


SPACES = {
    "branin": (branin_space, _crashing(branin)),
    "mixed": (_mixed_space, _crashing(lambda v, b: (v[:, :3] - 0.3).pow(2).sum(1) / b)),
}


def _make(cls, space, eval_fn, **kw):
    return cls(configspace=space(), eval_fn=eval_fn, min_budget=1, max_budget=27,
               eta=3, num_samples=8, seed=3, device="cpu", **kw)


def _recorded_replays(cls, space, eval_fn, n_iterations=5, chunk_brackets=2):
    """Run a sweep and keep every ``_replay_bracket`` call's arguments,
    through the seam the benchmark's ``replay_share.sweep`` wraps."""
    opt = _make(cls, space, eval_fn)
    calls = []
    inner = opt._replay_bracket

    def recording(*args):
        calls.append(args)
        inner(*args)

    opt._replay_bracket = recording
    res = opt.run(n_iterations=n_iterations, chunk_brackets=chunk_brackets)
    return opt, res, calls


def _replayed(cls, space, eval_fn, calls, replay):
    """A fresh optimizer's bookkeeping after ``replay`` of ``calls``, with
    a result logger and a journal sink attached."""
    lines = _Lines()
    opt = _make(cls, space, eval_fn, result_logger=lines)
    events = []
    detach = obs.get_bus().subscribe(events.append)
    try:
        for args in calls:
            replay(opt, *args)
    finally:
        detach()
    return opt, lines, events


def _state(opt):
    out = []
    for it in opt.iterations:
        rows = [(cid, _shape(d.config), d.config_info, d.results, d.exceptions,
                 d.infos, d.status, d.budget, sorted(d.time_stamps))
                for cid, d in it.data.items()]
        out.append((it.HPB_iter, it.actual_num_configs, it.stage, it.is_finished,
                    it.num_running, rows))
    return out


def _record(ev):
    """An event without its clocks (which ride beside its fields)."""
    return ev.name, ev.fields


@pytest.mark.parametrize("space_name", sorted(SPACES))
@pytest.mark.parametrize("cls", OPTIMIZERS, ids=lambda c: c.__name__)
def test_bulk_replay_equals_per_job_replay(cls, space_name):
    space, eval_fn = SPACES[space_name]
    opt, res, calls = _recorded_replays(cls, space, eval_fn)
    # the seam replay_share.sweep reads: one call per bracket
    assert len(calls) == 5 and [a[0] for a in calls] == list(range(5))
    losses = [r.loss for r in res.get_all_runs()]
    assert None in losses and math.inf in losses, "the schedule must crash and diverge"

    want, want_lines, want_events = _replayed(cls, space, eval_fn, calls, _per_job_replay)
    got, got_lines, got_events = _replayed(
        cls, space, eval_fn, calls, lambda o, *a: o._replay_bracket(*a))

    assert {obs.CONFIG_SAMPLED, obs.JOB_FINISHED, obs.JOB_FAILED} <= {e.name for e in want_events}
    assert _state(got) == _state(want)
    assert got.total_evaluated == want.total_evaluated == opt.total_evaluated
    assert got_lines.lines == want_lines.lines
    assert [_record(e) for e in got_events] == [_record(e) for e in want_events]
    for ev in got_events:
        if ev.name == obs.PROMOTION_DECISION:
            # no row reported a cost, and a shared clock read is none
            assert ev.fields["costs"] == [None] * len(ev.fields["costs"])
    for stamps in got_lines.stamps:
        assert list(stamps) == ["submitted", "started", "finished"]
        assert stamps["submitted"] <= stamps["started"] <= stamps["finished"]
    for it in got.iterations:
        for d in it.data.values():
            for b, ts in d.time_stamps.items():
                assert ts["submitted"] <= ts["started"] <= ts["finished"]
            # every row owns its info: a Result's runs must not alias
            assert len({id(i) for i in d.infos.values()}) == len(d.infos)
        infos = [id(i) for d in it.data.values() for i in d.infos.values()]
        assert len(set(infos)) == len(infos)


@pytest.mark.parametrize("cls", OPTIMIZERS, ids=lambda c: c.__name__)
def test_replay_counters_cover_every_evaluation(cls):
    metrics = obs.get_metrics()
    rows0 = metrics.counter("fused.replay_rows").value
    stages0 = metrics.counter("fused.replay_stages").value
    opt, res, calls = _recorded_replays(cls, *SPACES["branin"], n_iterations=4,
                                        chunk_brackets=3)
    assert len(calls) == 4
    assert metrics.counter("fused.replay_rows").value - rows0 == opt.total_evaluated
    assert opt.total_evaluated == len(res.get_all_runs())
    assert (metrics.counter("fused.replay_stages").value - stages0
            == sum(len(plan.num_configs) for _, plan, *_ in calls))


def _stage_zero(n=3, budgets=(1.0, 3.0)):
    it = _ReplayIteration(
        HPB_iter=0, num_configs=[n, 1], budgets=list(budgets),
        config_sampler=lambda b: None, promotion_sets=[{0}, set()],
    )
    for i in range(n):
        it.add_configuration({"x": float(i)}, {})
    return it


@pytest.mark.parametrize("ids", [[0, 1], [0, 1, 3], [0, 1, 1], [0, 1, 2, 2]],
                         ids=["missing", "foreign", "duplicate", "extra"])
def test_record_stage_refuses_ids_that_are_not_the_queue(ids):
    it = _stage_zero()
    with pytest.raises(RuntimeError, match="queued"):
        it.record_stage(np.array(ids), np.zeros(len(ids), np.float32), {}, ".")
    assert all(d.status == Status.QUEUED and not d.results for d in it.data.values())


def test_record_stage_writes_rows_in_queue_order():
    it = _stage_zero()
    lines = _Lines()
    it.result_logger = lines
    info = {"k": 1}
    n = it.record_stage(np.array([2, 0, 1]), np.array([0.5, np.nan, np.inf], np.float32),
                        info, "wd")
    assert n == 3 and it.num_running == 0
    d0, d1, d2 = (it.data[(0, 0, i)] for i in range(3))
    assert (d0.results, d1.results, d2.results) == ({1.0: None}, {1.0: math.inf}, {1.0: 0.5})
    assert d0.exceptions == {1.0: "non-finite loss nan at budget 1.0"}
    assert d0.infos == {} and d1.infos == d2.infos == {1.0: info}
    assert d1.infos[1.0] is not d2.infos[1.0] and d1.infos[1.0] is not info
    assert all(d.status == Status.REVIEW for d in (d0, d1, d2))
    assert [line[1] for line in lines.lines] == [(0, 0, 0), (0, 0, 1), (0, 0, 2)]
    assert it.process_results() and it.stage == 1
    # the promoted row is the next stage's queue: a stage of the wrong size
    with pytest.raises(RuntimeError):
        it.record_stage(np.array([0, 1]), np.zeros(2, np.float32), {}, ".")
    assert it.record_stage(np.array([0]), np.array([0.25], np.float32), {}, ".") == 1
