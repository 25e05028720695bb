"""The cost half of the capture ledger on the CPU: ``obs.runtime.count_cost``
(the counterpart of the reference's XLA cost analysis), the kernels'
shape-only costs (``ops/cuda_kde.py``), the ledger's costed rows and
counters, the roofline (``obs/profile.py``) and the sweep's ledger labels.

Parity with the reference's ``tracked_jit(...).lower(x).compile()`` rows:
FLOPs equal on ``x @ x.T`` and on a straight-line MLP, bytes equal on
``x @ x.T``. The port counts every op unfused, so the MLP's bytes are the
hand count of its eager ops, above XLA's fused count; a loop runs in
Python, so its body counts once per step where XLA counts a ``scan``'s
body once (ROADMAP C.36). Both differences are pinned here.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.obs.profile import format_roofline, roofline_report
from hpbandster_tpu_torch.obs.runtime import CompileTracker, count_cost, kernel_cost
from hpbandster_tpu_torch.ops import cuda_kde
from hpbandster_tpu_torch.ops.bracket import hyperband_bracket
from hpbandster_tpu_torch.ops.kde import KDE
from hpbandster_tpu_torch.ops.sweep import (
    build_space_codec,
    make_fused_sweep_fn,
    plan_additions,
    pow2_capacities,
)
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_harness import ref  # noqa: F401

PEAKS = {"kind": "test-card", "flops_per_s": 100e12, "bytes_per_s": 1e12,
         "ridge_flops_per_byte": 100.0}
NO_PEAKS = {"kind": "cpu", "flops_per_s": None, "bytes_per_s": None,
            "ridge_flops_per_byte": None}


@pytest.fixture(scope="module")
def ref_cost(ref):  # noqa: F811
    """The reference's ledger, roofline and ``tracked_jit``, inside the
    ``ref`` window."""
    import importlib

    return SimpleNamespace(
        runtime=importlib.import_module("hpbandster_tpu.obs.runtime"),
        profile=importlib.import_module("hpbandster_tpu.obs.profile"),
        obs=importlib.import_module("hpbandster_tpu.obs"),
        sweep=ref.sweep, toys=ref.toys,
    )


def xla_cost(ref_cost, fn, *args):
    """The reference's ledger row for ``fn`` compiled ahead of time on
    ``args``: its XLA cost analysis."""
    trk = ref_cost.runtime.CompileTracker()
    ref_cost.runtime.tracked_jit(
        fn, name="f", tracker=trk, registry=ref_cost.obs.MetricsRegistry(),
        bus=ref_cost.obs.EventBus()).lower(*args).compile()
    (row,) = trk.program_costs()
    return row


def mlp_inputs():
    rng = np.random.default_rng(0)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((64, 32), (32, 64), (64,), (64, 16), (16,))]


# -------------------------------------------------- counts against XLA's
def test_matmul_counts_as_xla(ref_cost):
    x = np.ones((32, 32), np.float32)
    want = xla_cost(ref_cost, lambda x: x @ x.T, x)
    t = torch.from_numpy(x)
    with count_cost() as got:
        t @ t.T
    assert (got["flops"], got["bytes_accessed"]) == (65536, 12288)
    assert (want["flops"], want["bytes_accessed"]) == (65536.0, 12288.0)
    assert got["by_kind"] == {"matmul": {"flops": 65536, "bytes_accessed": 12288, "ops": 1}}


def test_straight_line_mlp_flops_equal_xla(ref_cost):
    import jax

    arrays = mlp_inputs()
    want = xla_cost(ref_cost, lambda x, w1, b1, w2, b2: (
        jax.nn.relu(x @ w1 + b1) @ w2 + b2).sum(), *arrays)
    x, w1, b1, w2, b2 = map(torch.from_numpy, arrays)
    with count_cost() as got:
        (torch.relu(x @ w1 + b1) @ w2 + b2).sum()
    assert got["flops"] == want["flops"] == 403455
    # unfused: mm, add, relu, mm, add, sum, each reading its operands and
    # writing its output once; XLA fuses the adds and the relu away
    f32 = 4
    hand = f32 * (
        (64 * 32 + 32 * 64 + 64 * 64)      # x @ w1
        + (64 * 64 + 64 + 64 * 64)         # + b1
        + (64 * 64 + 64 * 64)              # relu
        + (64 * 64 + 64 * 16 + 64 * 16)    # @ w2
        + (64 * 16 + 16 + 64 * 16)         # + b2
        + (64 * 16 + 1))                   # sum
    assert got["bytes_accessed"] == hand == 135492
    assert want["bytes_accessed"] == 102748.0 <= hand


def test_addmm_bias_and_backward():
    """``addmm`` counts its bias add (XLA: a dot and an add); the backward
    of ``torch.autograd.grad`` counts too: two more products per weight
    product whose input needs a gradient, one where only the weight does."""
    x, w1, b1, w2, b2 = map(torch.from_numpy, mlp_inputs())
    with count_cost() as fused:
        (torch.relu(torch.addmm(b1, x, w1)) @ w2 + b2).sum()
    with count_cost() as plain:
        (torch.relu(x @ w1 + b1) @ w2 + b2).sum()
    assert fused["flops"] == plain["flops"] == 403455
    w1.requires_grad_(True)
    w2.requires_grad_(True)
    with count_cost() as grad:
        loss = (torch.relu(x @ w1 + b1) @ w2 + b2).sum()
        torch.autograd.grad(loss, (w1, w2))
    products = grad["by_kind"]["matmul"]
    # forward 2 products, backward dW1, dW2 and dH (x needs no gradient)
    assert products["ops"] == 5
    assert products["flops"] == 2 * 262144 + 3 * 131072


def test_scan_body_counts_per_step(ref_cost):
    """XLA counts a while loop's body once; the port's loop runs in Python
    and counts every step (C.36)."""
    import jax

    rng = np.random.default_rng(1)
    h = rng.normal(size=(64, 128)).astype(np.float32)
    w = rng.normal(size=(128, 128)).astype(np.float32)
    want = xla_cost(ref_cost, lambda h, w: jax.lax.scan(
        lambda c, _: (c @ w, c.sum()), h, None, length=10), h, w)
    assert want["flops"] == 2105345.0  # one body: the product, the sum, the loop
    c, tw = torch.from_numpy(h), torch.from_numpy(w)
    with count_cost() as got:
        sums = []
        for _ in range(10):
            sums.append(c.sum())
            c = c @ tw
        torch.stack(sums)
    assert got["by_kind"]["matmul"]["flops"] == 10 * 2 * 64 * 128 * 128 == 20971520
    assert got["by_kind"]["reduction"]["flops"] == 10 * (64 * 128 - 1)
    assert got["flops"] == 20971520 + 81910


def test_conventions_by_kind():
    """Transcendentals, copies, fills and indexing count no FLOPs; views
    and allocations no bytes; a reduction n - 1 FLOPs per output."""
    a = torch.ones((8, 16))
    idx = torch.arange(4)
    with count_cost() as got:
        a.exp()
        a.clone()
        a.T.reshape(-1)
        torch.empty((8, 16))
        a.sum(dim=1)
        a[idx]
        a.sort(dim=1)
    kinds = got["by_kind"]
    assert kinds["transcendental"] == {"flops": 0, "bytes_accessed": 2 * 512, "ops": 1}
    assert kinds["reduction"] == {"flops": 8 * 15, "bytes_accessed": 512 + 32, "ops": 1}
    assert kinds["other"]["flops"] == 0
    assert "free" not in kinds and got["flops"] == 8 * 15


def test_count_reads_nothing_off_and_nests():
    a = torch.ones((4, 4))
    obs.set_enabled(False)
    try:
        with count_cost() as off:
            a + a
    finally:
        obs.set_enabled(True)
    assert off == {}
    with count_cost() as outer:
        a + a
        with count_cost() as inner:
            a * a
    assert inner["flops"] == 16 and outer["flops"] == 32


# ------------------------------------------------------ the kernels' costs
def _kde(rng, n, d, live):
    data = torch.from_numpy(rng.uniform(size=(n, d)).astype(np.float32))
    mask = torch.zeros(n)
    mask[:live] = 1.0
    return KDE(data, mask, torch.full((d,), 0.3))


#: shapes of the kernel table in PERF.md and their costs as ``(flops,
#: bytes, exponentials)``, worked out by hand from the kernels' work (see
#: ``kde_score_cost`` / ``kde_moments_cost``), with the table's Bound ms:
#: the chunked path's largest launches, the 50-bracket resident round's and
#: ``sharded_model``'s (score: s, d, n_good, n_bad, live_good, live_bad;
#: moments: rows, d, sides, with the 2^20-row scale check)
SCORE_TABLE = [
    ((5184, 6, 256, 256, 7, 8), (2099520, 159584, 77760), 0.00004764),
    ((5184, 6, 1024, 1024, 13, 76), (12457152, 202592, 461376), 0.0001859),
    ((131072, 2, 65536, 65536, 819, 4641), (7872184320, 3145760, 715653120), 0.1711),
]
MOMENTS_TABLE = [
    ((256, 6, 2), (12800, 8408, 0), 0.00000251),
    ((1 << 20, 6, 2), (52428800, 33554648, 0), 0.01002),
    ((65536, 2, 2), (1179648, 1048648, 0), 0.000313),
]


@pytest.mark.parametrize("fn,shape,want,bound_ms", [
    *(("score", *row) for row in SCORE_TABLE), *(("moments", *row) for row in MOMENTS_TABLE)])
def test_kernel_costs_at_the_kernel_tables_shapes(fn, shape, want, bound_ms):
    """The shape-only costs pinned in numbers at the kernel table's shapes,
    and ``chip_smoke.py``'s bound of them equal to the table's Bound ms: a
    change to either formula fails here."""
    import chip_smoke

    cost = (cuda_kde.kde_score_cost if fn == "score" else cuda_kde.kde_moments_cost)(*shape)
    assert (cost.flops, cost.bytes_accessed, cost.transcendentals) == want
    ms, _ = chip_smoke.bound_ms(cost.bytes_accessed, cost.flops, cost.transcendentals)
    assert ms == pytest.approx(bound_ms, rel=5e-4)


@pytest.mark.parametrize("s,d,ng,nb", [(64, 2, 8, 24), (576, 6, 256, 256)])
def test_kde_score_cost_is_the_bound_formula(s, d, ng, nb):
    """The scorer's formula with every row live, and ``chip_smoke.py``'s
    bound taking this run's live rows from the masks; live counts only
    narrow the pairs."""
    import chip_smoke

    c = cuda_kde.kde_score_cost(s, d, ng, nb)
    pairs = s * (ng + nb)
    assert c == (pairs * (4 * d + 3), 4 * (s * d + (ng + nb) * (d + 1) + 4 * d + s), pairs)
    rng = np.random.default_rng(s)
    cands = torch.from_numpy(rng.uniform(size=(s, d)).astype(np.float32))
    good, bad = _kde(rng, ng, d, ng), _kde(rng, nb, d, nb // 2)
    vt = torch.zeros(d)
    assert chip_smoke.kde_score_work(cands, _kde(rng, ng, d, ng), _kde(rng, nb, d, nb), vt) == (
        c.bytes_accessed, c.flops, c.transcendentals)
    part = cuda_kde.kde_score_cost(s, d, ng, nb, ng, nb // 2)
    assert chip_smoke.kde_score_work(cands, good, bad, vt) == (
        part.bytes_accessed, part.flops, part.transcendentals)
    assert part.bytes_accessed == c.bytes_accessed and part.flops < c.flops


@pytest.mark.parametrize("c,d,sides", [(256, 6, 2), (64, 2, 1)])
def test_kde_moments_cost_is_the_bound_formula(c, d, sides):
    import chip_smoke

    cost = cuda_kde.kde_moments_cost(c, d, sides)
    assert cost == (sides * c * (4 * d + 1),
                    4 * (c * d + sides * c + d + sides * 3 * d + sides * d), 0)
    data, masks = torch.zeros((c, d)), torch.zeros((sides, c))
    assert chip_smoke.kde_moments_work(data, masks) == (
        cost.bytes_accessed, cost.flops, cost.transcendentals)


def test_entry_points_count_the_kernel_not_the_plain_version():
    """Inside a window the entry points count their kernel's cost once,
    with every buffer row live, and none of the plain version's ops; a
    call nested in another entry point adds nothing."""
    rng = np.random.default_rng(3)
    d = 3
    cands = torch.from_numpy(rng.uniform(size=(40, d)).astype(np.float32))
    good, bad = _kde(rng, 10, d, 4), _kde(rng, 20, d, 0)
    vt, cards = torch.zeros(d), torch.zeros(d)
    with count_cost() as got:
        cuda_kde.score_candidates(cands, good, bad, vt, cards)
    want = cuda_kde.kde_score_cost(40, d, 10, 20)
    assert got["by_kind"] == {"kde_score": {
        "flops": want.flops, "bytes_accessed": want.bytes_accessed, "ops": 1}}
    data, masks = good.data, torch.stack([good.mask, 1.0 - good.mask])
    moments = cuda_kde.kde_moments_cost(10, d, 2)
    for call in (lambda: cuda_kde.masked_moments(data, masks),
                 lambda: cuda_kde.moment_bandwidths(data, masks, cards)):
        with count_cost() as got:
            call()
        assert got == {"flops": moments.flops, "bytes_accessed": moments.bytes_accessed,
                       "by_kind": {"kde_moments": {"flops": moments.flops,
                                                   "bytes_accessed": moments.bytes_accessed,
                                                   "ops": 1}}}
    with count_cost() as got:
        cuda_kde.moment_bandwidths(data, good.mask, cards)
    assert got["flops"] == cuda_kde.kde_moments_cost(10, d, 1).flops
    with kernel_cost("kde_score", cuda_kde.kde_score_cost, 1, 1, 1, 1):
        pass  # no window open: nothing to count, nothing raised


# ------------------------------------------------- programs of the port
def _recording(monkeypatch):
    """Record every kernel cost the entry points count."""
    seen = []
    for name in ("kde_score_cost", "kde_moments_cost"):
        fn = getattr(cuda_kde, name)

        def wrapped(*shape, _fn=fn, _name=name):
            c = _fn(*shape)
            seen.append((_name, c))
            return c

        monkeypatch.setattr(cuda_kde, name, wrapped)
    return seen


def _kernel_share(seen, prefix):
    costs = [c for name, c in seen if name.startswith(prefix)]
    return sum(c.flops for c in costs), sum(c.bytes_accessed for c in costs), len(costs)


def test_chunk_body_counts_deterministically(monkeypatch):
    """A dynamic-tier chunk on Branin (the body a card captures as one
    graph), with the moments-kernel fit: the same count on every run, and
    the kernels' launches times their per-launch costs inside it."""
    monkeypatch.setenv("HPB_PALLAS_KDE_FIT", "1")
    plans = [hyperband_bracket(i, 1.0, 9.0, 3.0) for i in range(3)]
    fn = make_fused_sweep_fn(
        branin, plans, build_space_codec(branin_space(seed=0)), device="cpu",
        dynamic_counts=True, capacities=pow2_capacities(plan_additions(plans)),
        return_state=True, num_samples=16, min_points_in_model=2)
    counts = []
    for _ in range(2):
        seen = _recording(monkeypatch)
        with count_cost() as got:
            fn(11)
        counts.append(got)
        monkeypatch.undo()
        monkeypatch.setenv("HPB_PALLAS_KDE_FIT", "1")
    assert counts[0] == counts[1]
    kinds = counts[0]["by_kind"]
    for kernel in ("kde_score", "kde_moments"):
        flops, nbytes, n = _kernel_share(seen, kernel)
        assert n > 0 and kinds[kernel] == {"flops": flops, "bytes_accessed": nbytes, "ops": n}
    assert counts[0]["flops"] == sum(k["flops"] for k in kinds.values())
    assert counts[0]["bytes_accessed"] == sum(k["bytes_accessed"] for k in kinds.values())


def _bucket_runners(eval_fn, max_budget=9.0):
    from hpbandster_tpu_torch.ops.bracket import hyperband_schedule
    from hpbandster_tpu_torch.ops.buckets import build_bucket_set, make_bucketed_bracket_fn

    bs = build_bucket_set(hyperband_schedule(int(max_budget), 1, max_budget, 3))
    return [make_bucketed_bracket_fn(eval_fn, b, device="cpu", device_metrics=False)
            for b in bs.buckets]


def quad_eval(vec, budget):
    return ((vec - 0.5) ** 2).sum(-1) * (1.0 + 1.0 / budget)


def test_bucket_body_counts_deterministically():
    """A ``fused_bucket`` program's body: the same count on every run, its
    products and pointwise work present, no kernel (a bucket runs no
    model)."""
    runner = _bucket_runners(quad_eval)[0]
    runner.ensure_compiled(2)
    prog = runner.program
    counts = []
    for _ in range(2):
        with count_cost() as got:
            prog._body(*prog._buffers)
        counts.append(got)
    assert counts[0] == counts[1] and counts[0]["bytes_accessed"] > 0
    assert counts[0]["by_kind"]["pointwise"]["flops"] > 0
    assert not {"kde_score", "kde_moments"} & set(counts[0]["by_kind"])


def test_training_chunk_matmuls_against_the_analytic_count():
    """A tiny teacher stage: the counted products equal
    ``workloads/flops.py``'s training count less the first layer's input
    gradient (the inputs need none) plus the validation forward, which the
    analytic count leaves out; within 15% of it."""
    from hpbandster_tpu_torch.workloads import flops
    from hpbandster_tpu_torch.workloads.teacher import TeacherConfig, make_teacher_eval_fn

    cfg = TeacherConfig(n_train=256, n_val=64, student_width=16, batch_size=64)
    eval_fn = make_teacher_eval_fn(cfg, device="cpu")
    n, d_in, width = 5, cfg.d_in, cfg.student_width
    steps_per_epoch = cfg.n_train // cfg.batch_size
    for budget in (1, 3):
        with count_cost() as got:
            eval_fn(torch.rand(n, 4), float(budget))
        analytic = n * budget * flops.teacher_epoch_flops(cfg)
        no_input_grad = n * budget * steps_per_epoch * 2 * cfg.batch_size * d_in * width
        val_forward = n * 2 * cfg.n_val * (d_in * width + width * width + width * cfg.n_classes)
        counted = got["by_kind"]["matmul"]["flops"]
        assert counted == analytic - no_input_grad + val_forward
        assert 0.85 <= counted / analytic <= 1.0


def _tiny_training():
    from hpbandster_tpu_torch.workloads.cnn import CNNConfig, make_cnn_eval_fn
    from hpbandster_tpu_torch.workloads.teacher import TeacherConfig, make_teacher_eval_fn

    return {
        "teacher": make_teacher_eval_fn(TeacherConfig(n_train=256, n_val=64, student_width=16,
                                                      batch_size=64), device="cpu"),
        "cnn": make_cnn_eval_fn(CNNConfig(image_size=8, width=8, n_classes=4, n_train=64,
                                          n_val=32, batch_size=32), device="cpu"),
    }


@pytest.mark.parametrize("workload", ["teacher", "cnn"])
def test_uniform_steps_reuse_counts_what_every_step_dispatches(workload):
    """A training evaluation counted with the first step's count reused for
    the later steps equals the same evaluation counted op by op at every
    step (``reuse_steps=False``), kind by kind."""
    eval_fn = _tiny_training()[workload]
    x = torch.from_numpy(np.random.default_rng(1).uniform(size=(5, 4)).astype(np.float32))
    with count_cost() as reused:
        eval_fn(x, 9.0)
    with count_cost(reuse_steps=False) as every:
        eval_fn(x, 9.0)
    assert reused["by_kind"]["matmul"]["flops"] > 0
    assert reused == every


def test_uniform_steps_are_the_sum_of_single_steps():
    """``momentum_sgd_steps`` over three steps counts what three one-step
    calls from the same cycle positions count (each wholly op by op), less
    the two extra calls' set-up; another dispatch mode on the stack still
    sees every step's ops."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from hpbandster_tpu_torch.workloads.train import momentum_sgd_steps

    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(size=(3, 4, 2)).astype(np.float32))
    train = (torch.from_numpy(rng.normal(size=(12, 4)).astype(np.float32)),
             torch.from_numpy(rng.normal(size=(12, 2)).astype(np.float32)))
    hyper = [torch.full((3,), v) for v in (0.1, 0.9, 1e-4)]

    def loss_fn(params, xb, yb):
        return ((torch.einsum("bi,nij->nbj", xb, params["w"]) - yb) ** 2).mean((1, 2))

    def run(n_steps, step0):
        return momentum_sgd_steps({"w": w}, {"w": torch.zeros_like(w)}, *hyper, train,
                                  n_steps, step0, loss_fn, 4, 12)

    with count_cost() as setup:  # what a call dispatches around its steps
        run(0, 0)
    with count_cost() as three:
        run(3, 0)
    singles = []
    for step0 in range(3):
        with count_cost() as one:
            run(1, step0)
        singles.append(one)
    for key in ("flops", "bytes_accessed"):
        assert three[key] + 2 * setup[key] == sum(c[key] for c in singles) > 0

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    seen = []
    for n_steps in (0, 1, 3):
        with count_cost() as c, Ops() as ops:
            run(n_steps, 0)
        seen.append((ops.n, c["flops"]))
    assert seen[2][0] - seen[0][0] == 3 * (seen[1][0] - seen[0][0]) > 0
    assert seen[2][1] == three["flops"]


def test_capture_runs_with_garbage_collection_off(monkeypatch):
    """``RoundGraph`` captures with Python's garbage collector off (a
    collection inside a capture may destroy another graph that only a dead
    reference cycle holds, which invalidates the capture), counts the body,
    and turns the collector back on, also when the body raises. The card's
    calls are stand-ins here."""
    import collections
    import contextlib
    import gc

    from hpbandster_tpu_torch.ops import graphs

    class Stream:
        def wait_stream(self, other):
            pass

    class Graph:
        def __init__(self, keep_graph=False):
            pass

        def register_generator_state(self, gen):
            pass

        def instantiate(self):
            pass

    trk = CompileTracker()
    monkeypatch.setattr(graphs, "_capture_stream", lambda device: Stream())
    monkeypatch.setattr(graphs, "CAPTURES", collections.Counter())
    monkeypatch.setattr(graphs, "get_compile_tracker", lambda: trk)
    monkeypatch.setattr(graphs.cuda_kde, "prepare_capture", lambda device, stream: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, stream=None, capture_error_mode=None:
                        contextlib.nullcontext())
    x = torch.ones(4, 4)
    seen = []

    def body():
        seen.append(gc.isenabled())
        x @ x

    assert gc.isenabled()
    graph = graphs.RoundGraph(body, "cpu", name="probe", signature="s")
    assert seen == [False] and gc.isenabled()
    assert graph.cost["flops"] == 2 * 4 * 4 * 4
    assert trk.program_costs()[0]["flops"] == 128

    def failing():
        seen.append(gc.isenabled())
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.RoundGraph(failing, "cpu", name="probe")
    assert seen == [False, False] and gc.isenabled()


# --------------------------------------------------- the ledger and roofline
def _both_trackers(ref_cost, records):
    """The same records into a port and a reference ledger."""
    port, refd = CompileTracker(), ref_cost.runtime.CompileTracker()
    for trk, o in ((port, obs), (refd, ref_cost.obs)):
        for label, sig, seconds, cost in records:
            trk.record(label, sig, seconds, registry=o.MetricsRegistry(),
                       bus=o.EventBus(), cost=cost)
    return port, refd


RECORDS = [
    ("dense", "a", 0.01, {"flops": 200e9, "bytes_accessed": 1e9}),
    ("gather", "b", 0.02, {"flops": 1e9, "bytes_accessed": 1e9}),
    ("dense", "a", 0.03, {"flops": 200e9, "bytes_accessed": 1e9}),
    ("fused_sweep", "f32[8,8]", 0.5, {"flops": 2e12, "bytes_accessed": 1e9}),
    ("copy", "c", 0.0, {"flops": 0.0, "bytes_accessed": 4e6}),
]


@pytest.mark.parametrize("peaks,seconds", [
    (PEAKS, None),
    (PEAKS, {"dense": 0.1, "gather@b": 0.005, "copy": 0.01}),
    (NO_PEAKS, {"fused_sweep": 0.25}),
])
def test_roofline_rows_equal_the_reference(ref_cost, peaks, seconds):
    port, refd = _both_trackers(ref_cost, RECORDS)
    assert port.program_costs() == refd.program_costs()
    got = roofline_report(tracker=port, peaks=peaks, seconds_by_program=seconds, transfers={})
    want = ref_cost.profile.roofline_report(tracker=refd, peaks=peaks,
                                            seconds_by_program=seconds, transfers={})
    assert got == want
    assert format_roofline(got) == ref_cost.profile.format_roofline(want)


def test_ledger_counters_and_events_equal_the_reference(ref_cost):
    """``runtime.flops.<fn>`` / ``runtime.bytes_accessed.<fn>`` and the
    ``xla_compile`` event's cost fields, on the same costed record."""
    seen = {}
    for name, o, trk in (("port", obs, CompileTracker()),
                         ("ref", ref_cost.obs, ref_cost.runtime.CompileTracker())):
        reg, bus, events = o.MetricsRegistry(), o.EventBus(), []
        bus.subscribe(events.append)
        trk.record("fused_bucket", "f32[27,2], i64[3]", 0.5, registry=reg, bus=bus,
                   cost={"flops": 1234.0, "bytes_accessed": 5678.0})
        seen[name] = (reg.snapshot()["counters"], events[0].fields)
    assert seen["port"] == seen["ref"]
    assert seen["port"][0]["runtime.flops.fused_bucket"] == 1234


class TestCostCapture:
    """The reference's ``tests/test_profile.py`` ``TestCostCapture``, with a
    counted window where the reference compiles ahead of time."""

    def test_counted_record_carries_cost_and_counters(self):
        reg, bus, events = obs.MetricsRegistry(), obs.EventBus(), []
        bus.subscribe(events.append)
        trk = CompileTracker()
        x = torch.ones((32, 32))
        with count_cost() as cost:
            x @ x.T
        trk.record("cost_matmul", "f32[32,32]", 0.01, registry=reg, bus=bus, cost=cost)
        (p,) = trk.program_costs()
        assert p["fn"] == "cost_matmul" and p["compiles"] == 1
        assert p["flops"] == 65536.0 and p["bytes_accessed"] == 12288.0
        counters = reg.snapshot()["counters"]
        assert counters["runtime.flops.cost_matmul"] == int(p["flops"])
        assert counters["runtime.bytes_accessed.cost_matmul"] == int(p["bytes_accessed"])
        compile_events = [e for e in events if e.name == obs.XLA_COMPILE]
        assert len(compile_events) == 1 and compile_events[0].fields["flops"] == p["flops"]

    def test_reset_clears_program_costs(self):
        trk = CompileTracker()
        trk.record("f", "sig", 0.1, registry=obs.MetricsRegistry(), bus=obs.EventBus(),
                   cost={"flops": 10.0})
        assert len(trk.program_costs()) == 1
        trk.reset()
        assert trk.program_costs() == []

    def test_costed_program_table_is_bounded(self):
        trk = CompileTracker()
        reg, bus = obs.MetricsRegistry(), obs.EventBus()
        for i in range(trk.MAX_PROGRAMS + 10):
            trk.record("f", f"sig{i}", 0.0, registry=reg, bus=bus, cost={"flops": 1.0})
        assert len(trk.program_costs()) == trk.MAX_PROGRAMS == 256


class TestRoofline:
    """The reference's ``TestRoofline`` cases on the port."""

    def tracker_with(self, *entries):
        trk = CompileTracker()
        reg, bus = obs.MetricsRegistry(), obs.EventBus()
        for label, sig, cost in entries:
            trk.record(label, sig, 0.01, registry=reg, bus=bus, cost=cost)
        return trk

    def test_bound_classification_and_floor(self):
        trk = self.tracker_with(
            ("dense", "a", {"flops": 200e9, "bytes_accessed": 1e9}),
            ("gather", "b", {"flops": 1e9, "bytes_accessed": 1e9}),
        )
        rep = roofline_report(tracker=trk, peaks=PEAKS, transfers={})
        by_fn = {p["fn"]: p for p in rep["programs"]}
        assert rep["program_count"] == 2
        assert by_fn["dense"]["bound"] == "compute" and by_fn["gather"]["bound"] == "memory"
        assert by_fn["dense"]["roofline_floor_s"] == pytest.approx(200e9 / 100e12)
        assert by_fn["gather"]["roofline_floor_s"] == pytest.approx(1e9 / 1e12)
        assert rep["caveats"] == []

    def test_utilization_from_measured_seconds(self):
        trk = self.tracker_with(("dense", "a", {"flops": 1e12, "bytes_accessed": 1e9}))
        rep = roofline_report(tracker=trk, peaks=PEAKS, seconds_by_program={"dense": 0.1},
                              transfers={})
        p = rep["programs"][0]
        assert p["achieved_flops_per_s"] == pytest.approx(1e13)
        assert p["utilization_vs_peak"] == pytest.approx(0.1)

    def test_cpu_caveat_without_peaks(self):
        trk = self.tracker_with(("f", "a", {"flops": 10.0, "bytes_accessed": 5.0}))
        rep = roofline_report(tracker=trk, peaks=NO_PEAKS, transfers={})
        p = rep["programs"][0]
        assert p["intensity_flops_per_byte"] == 2.0
        assert p["bound"] is None and p["roofline_floor_s"] is None
        assert rep["caveats"]

    def test_format_renders_rows(self):
        trk = self.tracker_with(("dense", "f32[8,8]", {"flops": 2e12, "bytes_accessed": 1e9}))
        text = format_roofline(roofline_report(tracker=trk, peaks=PEAKS, transfers={}))
        assert "dense[f32[8,8]]" in text and "compute" in text and "test-card" in text

    def test_roofline_covers_every_bucket_program(self):
        """Every bucket program of a schedule, its body counted as a
        capture counts it, has a classified roofline row."""
        from hpbandster_tpu_torch.ops.graphs import shape_signature

        trk = CompileTracker()
        reg, bus = obs.MetricsRegistry(), obs.EventBus()
        runners = _bucket_runners(quad_eval)
        assert len(runners) >= 1
        for r in runners:
            r.ensure_compiled(2)
            prog = r.program
            with count_cost() as cost:
                prog._body(*prog._buffers)
            trk.record(prog.name, shape_signature(*prog._buffers), 0.0, registry=reg,
                       bus=bus, cost=cost)
        rep = roofline_report(tracker=trk, peaks=PEAKS, transfers={})
        assert rep["program_count"] == len(runners)
        for p in rep["programs"]:
            assert p["fn"] == "fused_bucket" and p["flops"] > 0 and p["bound"] == "memory"
        text = format_roofline(rep)
        assert sum("fused_bucket[" in line for line in text.splitlines()) == len(runners)


# ------------------------------------------------------------- ledger labels
@pytest.mark.parametrize("program_name", [None, "ensemble_sweep"])
@pytest.mark.parametrize("resident", [False, True])
def test_sweep_labels_equal_the_reference(ref_cost, monkeypatch, program_name, resident):
    """``make_fused_sweep_fn(program_name=)``'s ledger label, resident and
    on a multi-process mesh (spmd), as the reference names its program."""
    import jax

    from hpbandster_tpu_torch.ops import sweep as port_sweep

    plans = [hyperband_bracket(i, 1.0, 9.0, 3.0) for i in range(2)]
    rc = ref_cost.sweep.build_space_codec(ref_cost.toys.branin_space(seed=0))
    kw = dict(dynamic_counts=True, resident=True) if resident else {}
    want = ref_cost.sweep.make_fused_sweep_fn(
        ref_cost.toys.branin_from_vector, plans, rc, program_name=program_name, **kw).label
    codec = build_space_codec(branin_space(seed=0))
    caps = pow2_capacities(plan_additions(plans))
    port_kw = dict(dynamic_counts=True, resident=True, capacities=caps) if resident else {}
    got = make_fused_sweep_fn(branin, plans, codec, device="cpu",
                              program_name=program_name, **port_kw).label
    assert got == want == (program_name or "fused_sweep") + ("_resident" if resident else "")

    import hpbandster_tpu.parallel.mesh as ref_mesh

    monkeypatch.setattr(ref_mesh, "is_multiprocess_mesh", lambda mesh: True)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("config",))
    want_spmd = ref_cost.sweep.make_fused_sweep_fn(
        ref_cost.toys.branin_from_vector, plans, rc, program_name=program_name, mesh=mesh,
        **kw).label
    monkeypatch.setattr(port_sweep, "is_multiprocess_mesh", lambda mesh: True)
    from hpbandster_tpu_torch.parallel.mesh import config_mesh

    got_spmd = make_fused_sweep_fn(branin, plans, codec, device="cpu",
                                   mesh=config_mesh([torch.device("cpu")]),
                                   program_name=program_name, **port_kw).label
    assert got_spmd == want_spmd == got + "_spmd"


def test_sharded_sweep_takes_a_program_name(monkeypatch):
    """``run_sharded_fused_sweep(program_name=)`` builds its sweep under
    that label (on the CPU nothing is captured, so nothing is recorded)."""
    import hpbandster_tpu_torch.ops.sweep as port_sweep
    from hpbandster_tpu_torch.parallel import multihost
    from hpbandster_tpu_torch.parallel.mesh import config_mesh

    built = []

    def spy(*args, **kwargs):
        fn = make_fused_sweep_fn(*args, **kwargs)
        built.append(fn.label)
        return fn

    monkeypatch.setattr(port_sweep, "make_fused_sweep_fn", spy)
    multihost._SHARDED_FN_CACHE.clear()
    try:
        multihost.run_sharded_fused_sweep(
            branin, branin_space(seed=0), n_configs=64, mesh=config_mesh([torch.device("cpu")]),
            seed=0, program_name="probe_sweep", resident=True, publish_gauges=False)
    finally:
        multihost._SHARDED_FN_CACHE.clear()
    assert built == ["probe_sweep_resident"]
