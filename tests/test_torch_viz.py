"""The port's plots (``hpbandster_tpu_torch/viz``) against the reference's
(``hpbandster_tpu/viz``), on the CPU with matplotlib's headless Agg backend.

Mirrors ``tests/test_viz.py``'s five tests on the same data: a ``HyperBand``
run on Branin (numpy sampling, the reference's configurations draw for
draw) and a hand-written run journal. Each plot is drawn by both packages,
the port's over its own ``Result``, and held to the reference's figure: the
same artists (scatter collections with their offsets, lines with their
data, legend labels), the same correlation matrix and the same tool-tip
strings. Losses enter the figures, so they agree within ``atol 1e-4, rtol
1e-4`` (XLA and eager PyTorch evaluate Branin differently, ROADMAP C.15);
timestamps differ run to run and are compared only through what does not
depend on them.
"""

import json

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from hpbandster_tpu_torch.optimizers import HyperBand  # noqa: E402
from hpbandster_tpu_torch.parallel import BatchedExecutor, VmapBackend  # noqa: E402
from hpbandster_tpu_torch.viz import (  # noqa: E402
    concurrent_runs_over_time,
    correlation_across_budgets,
    default_tool_tips,
    finished_runs_over_time,
    incumbent_trajectory_from_journal,
    interactive_HBS_plot,
    losses_over_time,
)
from hpbandster_tpu_torch.workloads.toys import branin, branin_space  # noqa: E402
from tests.test_torch_harness import ref, ref_opt  # noqa: E402,F401

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def results(ref, ref_opt):  # noqa: F811
    """The reference test's run (HyperBand, Branin, budgets 1..9, three
    iterations, seed 0) in both packages, and the reference's viz module."""
    import importlib

    import matplotlib.pyplot as plt

    cs = branin_space(seed=0)
    opt = HyperBand(configspace=cs, run_id="viz", executor=BatchedExecutor(
        VmapBackend(branin, device="cpu"), cs), min_budget=1, max_budget=9, eta=3, seed=0)
    mine = opt.run(n_iterations=3)
    opt.shutdown()
    rcs = ref.toys.branin_space(seed=0)
    ropt = ref_opt.optimizers.HyperBand(
        configspace=rcs, run_id="viz",
        executor=ref_opt.parallel.BatchedExecutor(
            ref_opt.parallel.VmapBackend(ref.toys.branin_from_vector), rcs),
        min_budget=1, max_budget=9, eta=3, seed=0)
    theirs = ropt.run(n_iterations=3)
    ropt.shutdown()
    yield mine, theirs, importlib.import_module("hpbandster_tpu.viz")
    plt.close("all")


def _offsets(ax):
    return [np.asarray(c.get_offsets()) for c in ax.collections]


def _legend(ax):
    return [t.get_text() for t in ax.get_legend().get_texts()]


def test_losses_over_time(results):
    mine, theirs, rviz = results
    _, ax = losses_over_time(mine.get_all_runs())
    _, rax = rviz.losses_over_time(theirs.get_all_runs())
    assert len(ax.collections) == len(rax.collections) >= 2  # one scatter per budget
    assert _legend(ax) == _legend(rax)
    for got, want in zip(_offsets(ax), _offsets(rax)):
        assert got.shape == want.shape
        np.testing.assert_allclose(np.sort(got[:, 1]), np.sort(want[:, 1]), **TOL)


def test_concurrent_and_finished(results):
    mine, theirs, rviz = results
    _, ax = concurrent_runs_over_time(mine.get_all_runs())
    _, rax = rviz.concurrent_runs_over_time(theirs.get_all_runs())
    assert ax.lines and len(ax.lines) == len(rax.lines)
    # the count of runs in flight, event by event: starts and finishes
    assert len(ax.lines[0].get_ydata()) == len(rax.lines[0].get_ydata())
    assert ax.lines[0].get_ydata()[-1] == rax.lines[0].get_ydata()[-1] == 0
    _, ax = finished_runs_over_time(mine.get_all_runs())
    _, rax = rviz.finished_runs_over_time(theirs.get_all_runs())
    assert ax.lines and _legend(ax) == _legend(rax)
    for line, rline in zip(ax.lines, rax.lines):
        np.testing.assert_array_equal(line.get_ydata(), rline.get_ydata())


def test_correlation_across_budgets(results):
    mine, theirs, rviz = results
    _, _, corr = correlation_across_budgets(mine)
    _, _, want = rviz.correlation_across_budgets(theirs)
    assert corr.shape == want.shape == (3, 3)
    for i in range(3):
        if np.isfinite(corr[i, i]):
            assert corr[i, i] == pytest.approx(1.0)
    np.testing.assert_array_equal(np.isfinite(corr), np.isfinite(want))
    np.testing.assert_allclose(corr[np.isfinite(corr)], want[np.isfinite(want)], **TOL)


def test_interactive_plot_and_tooltips(results):
    mine, theirs, rviz = results
    lcs = mine.get_learning_curves()
    tips = default_tool_tips(mine)
    assert set(tips) == set(mine.get_id2config_mapping())
    want_tips = rviz.default_tool_tips(theirs)
    assert sorted(tips) == sorted(want_tips)
    # the same lines of the same configs (losses printed in full differ in
    # their last digits between the frameworks: compared up to them)
    for cid in tips:
        assert [line.split(": loss")[0] for line in tips[cid].splitlines()] == \
            [line.split(": loss")[0] for line in want_tips[cid].splitlines()]
    _, ax = interactive_HBS_plot(lcs, tool_tip_strings=tips)
    _, rax = rviz.interactive_HBS_plot(theirs.get_learning_curves(), tool_tip_strings=want_tips)
    assert ax.lines and len(ax.lines) == len(rax.lines)
    for line, rline in zip(ax.lines, rax.lines):
        np.testing.assert_array_equal(line.get_xdata(), rline.get_xdata())
        np.testing.assert_allclose(line.get_ydata(), rline.get_ydata(), **TOL)


def test_incumbent_trajectory_from_journal(results, tmp_path):
    """The audit-sourced trajectory plot: the journal in, the step curve and
    the arm-attributed improvement markers out, equal to the reference's on
    the same journal."""
    _, _, rviz = results
    path = str(tmp_path / "j.jsonl")
    with open(path, "w", encoding="utf-8") as fh:
        for i, (loss, model) in enumerate([(9.0, False), (5.0, True), (7.0, False), (2.0, True)]):
            fh.write(json.dumps({
                "event": "config_sampled", "t_wall": 10.0 + i, "config_id": [0, 0, i],
                "budget": 1.0, "model_based_pick": model}) + "\n")
            fh.write(json.dumps({
                "event": "job_finished", "t_wall": 10.5 + i, "config_id": [0, 0, i],
                "budget": 1.0, "run_s": 0.1, "loss": loss}) + "\n")
    _, ax = incumbent_trajectory_from_journal(path)
    _, rax = rviz.incumbent_trajectory_from_journal(path)
    assert ax.lines, "incumbent step curve missing"
    assert len(ax.collections) >= 3
    assert {"incumbent", "model-based", "random"} <= set(_legend(ax))
    assert _legend(ax) == _legend(rax)
    for got, want in zip(_offsets(ax), _offsets(rax)):
        np.testing.assert_array_equal(got, want)
    for line, rline in zip(ax.lines, rax.lines):
        np.testing.assert_array_equal(line.get_xydata(), rline.get_xydata())
