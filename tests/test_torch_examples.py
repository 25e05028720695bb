"""The port's example ladder (``hpbandster_tpu_torch/examples``) on the CPU.

Each example runs in process through its ``main(argv)`` with
``--device cpu`` at ``tests/test_examples.py``'s arguments, prints the
lines that test asserts for its counterpart, and runs per budget what the
JAX package's bracket plan says for the same arguments (the plan taken
from the reference through the harness's ``ref`` window). Example 3 spawns
worker processes and is slow, as its counterpart is.
"""

from __future__ import annotations

import importlib
import threading

import numpy as np
import pytest

from tests.test_torch_harness import ref  # noqa: F401  (fixture)

PKG = "hpbandster_tpu_torch.examples"


def run_example(name, *args):
    module = importlib.import_module(f"{PKG}.{name}")
    return module.main([*args, "--device", "cpu"])


def runs_per_budget(runs):
    got = {}
    for budget in runs:
        got[float(budget)] = got.get(float(budget), 0) + 1
    return got


def plan(ref, n_iterations, min_budget, max_budget, eta=3.0):  # noqa: F811
    """Runs per budget of the reference's HyperBand brackets."""
    want = {}
    for i in range(n_iterations):
        p = ref.bracket.hyperband_bracket(i, float(min_budget), float(max_budget), float(eta))
        for k, b in zip(p.num_configs, p.budgets):
            want[float(b)] = want.get(float(b), 0) + int(k)
    return want


def check_result(ref, res, n_iterations, min_budget, max_budget):  # noqa: F811
    runs = res.get_all_runs()
    assert runs_per_budget(r.budget for r in runs) == plan(
        ref, n_iterations, min_budget, max_budget)
    assert np.isfinite([r.loss for r in runs]).all()


def test_example_1_sequential(ref, capsys):  # noqa: F811
    res = run_example("example_1_local_sequential", "--n_iterations", "2")
    out = capsys.readouterr().out
    assert "best found configuration" in out
    check_result(ref, res, 2, 1, 9)


def test_example_2_threads(ref, capsys):  # noqa: F811
    res = run_example("example_2_local_parallel_threads", "--n_workers", "3",
                      "--n_iterations", "2")
    out = capsys.readouterr().out
    assert "best:" in out and "workers that served jobs" in out
    check_result(ref, res, 2, 1, 9)


@pytest.mark.slow
def test_example_3_processes(ref, capsys):  # noqa: F811
    res = run_example("example_3_local_parallel_processes", "--n_workers", "2",
                      "--n_iterations", "2")
    assert "best:" in capsys.readouterr().out
    check_result(ref, res, 2, 1, 9)


def test_example_4_cluster(ref, tmp_path, capsys):  # noqa: F811
    """The master and one worker, each on its own thread, meet through the
    credentials file in the shared directory; the master's result logger
    writes there too."""
    shared = str(tmp_path)
    out = {}

    def master():
        out["res"] = run_example("example_4_cluster", "--master", "--shared_directory",
                                 shared, "--min_n_workers", "1", "--n_iterations", "2")

    def worker():
        out["worker"] = run_example("example_4_cluster", "--worker",
                                    "--shared_directory", shared)

    threads = [threading.Thread(target=master, daemon=True),
               threading.Thread(target=worker, daemon=True)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert "best:" in capsys.readouterr().out
    check_result(ref, out["res"], 2, 1, 9)
    assert (tmp_path / "results.json").exists() and (tmp_path / "configs.json").exists()


def test_example_5_mlp_worker(ref, capsys):  # noqa: F811
    res = run_example("example_5_mlp_worker", "--n_workers", "1", "--n_iterations", "1",
                      "--min_budget", "5", "--max_budget", "15")
    assert "val loss at max budget" in capsys.readouterr().out
    check_result(ref, res, 1, 5, 15)


def test_example_6_analysis_warmstart(ref, tmp_path, capsys):  # noqa: F811
    res = run_example("example_6_analysis_warmstart", "--out_dir", str(tmp_path), "--plot")
    assert "phase 3 final incumbent loss" in capsys.readouterr().out
    assert (tmp_path / "losses_over_time.png").exists()
    # the warm-started result holds phase 1's four brackets and its own two
    want = plan(ref, 4, 1, 27)
    for b, k in plan(ref, 2, 1, 27).items():
        want[b] = want.get(b, 0) + k
    runs = res.get_all_runs()
    assert runs_per_budget(r.budget for r in runs) == want
    assert np.isfinite([r.loss for r in runs]).all()


def test_example_7_tpu_batched(ref, capsys):  # noqa: F811
    res = run_example("example_7_tpu_batched", "--n_iterations", "2",
                      "--min_budget", "5", "--max_budget", "45")
    out = capsys.readouterr().out
    assert "configs/s" in out and "devices: 1 (cpu)" in out
    check_result(ref, res, 2, 5, 45)


@pytest.mark.parametrize("extra, mode", [
    ((), "fused whole-sweep"),
    (("--chunk_brackets", "2", "--checkpoint", "{tmp}/sweep.pkl"), "2-bracket chunks"),
    (("--no-fused",), "per-bracket batched"),
], ids=["fused", "chunked_checkpoint", "per_bracket"])
def test_example_8_large_sweep(ref, tmp_path, capsys, extra, mode):  # noqa: F811
    extra = [a.format(tmp=tmp_path) for a in extra]
    res = run_example("example_8_large_sweep", "--n_iterations", "4", "--max_budget", "9",
                      *extra)
    out = capsys.readouterr().out
    assert "incumbent loss" in out and mode in out
    check_result(ref, res, 4, 1, 9)
    if "--checkpoint" in extra:
        assert (tmp_path / "sweep.pkl").exists()


def test_example_9_multihost_batched_workers(ref, capsys):  # noqa: F811
    res = run_example("example_9_multihost_batched_workers", "--n_iterations", "3",
                      "--max_budget", "9")
    out = capsys.readouterr().out
    assert "batched workers" in out and "incumbent loss" in out
    check_result(ref, res, 3, 1, 9)


def test_example_10_multihost_fused_spmd(ref, capfd):  # noqa: F811
    """Two gloo ranks of two CPU devices each run the fused sweep; their
    run records agree, and their schedule is the reference's plan."""
    got = run_example("example_10_multihost_fused_spmd")
    out = capfd.readouterr().out
    assert "SPMD OK" in out and got["ranks"] == 2
    assert runs_per_budget(b for _, b, _ in got["records"]) == plan(ref, 4, 1, 27)
    assert np.isfinite([loss for _, _, loss in got["records"]]).all()


def test_example_11_transformer_fused(ref, capsys):  # noqa: F811
    res = run_example("example_11_transformer_fused", "--tiny", "--n_iterations", "2",
                      "--min_budget", "9", "--max_budget", "81")
    out = capsys.readouterr().out
    assert "configs/s" in out and "copied-half val accuracy" in out
    check_result(ref, res, 2, 9, 81)


def test_example_12_long_context_ring(capsys):
    got = run_example("example_12_long_context_ring", "--seq_per_device", "32",
                      "--head_dim", "16", "--striped")
    out = capsys.readouterr().out
    assert "never" in out and "grads finite: OK" in out
    assert "prefix parity vs dense" in out
    assert got["t"] == 32 * 8 and got["err"] < 5e-2 and got["grads_finite"]
