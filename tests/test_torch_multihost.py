"""The port's multi-process tier (``hpbandster_tpu_torch/parallel/multihost.py``)
on the CPU: ranks spawned as fresh interpreters (``tests/torch_multihost_child.py``,
which imports the port alone) join a gloo group and run the same sweeps over
a mesh of two ``cpu`` devices per rank.

Held, as the reference's two-process test holds its ranks: every rank
reaches bit-identical decisions (the runs of ``HyperBand``, ``BOHB`` and a
conditional ``FusedBOHB``, the sharded sweep's incumbent), and only rank 0
writes the result log. Held further against one process: the ranks' runs
equal the single-process runs bit for bit (the fused optimizer unmeshed, the
sharded sweep on a one-process mesh of as many shards), and ``HyperBand``'s
equal the reference's single-process run (its configurations exactly, its
losses within ``atol 1e-4, rtol 1e-4``: XLA contracts Branin's polynomial
differently from eager PyTorch, ROADMAP C.15). The reference's own
two-process run cannot run on the CPU (its backend refuses multi-process
computations, ``tests/test_multihost.py``).

Every wait is bounded: a free port from a bound socket, the group's
rendezvous and collectives (60 s), and each rank's exit.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch.optimizers import FusedBOHB
from hpbandster_tpu_torch.parallel import multihost
from hpbandster_tpu_torch.parallel.mesh import config_mesh
from hpbandster_tpu_torch.space import (
    CategoricalHyperparameter,
    ConfigurationSpace,
    EqualsCondition,
    UniformFloatHyperparameter,
)
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_harness import REPO, ref, ref_opt  # noqa: F401

CHILD = REPO / "tests" / "torch_multihost_child.py"
#: a rank's whole run; a hung rendezvous fails the test instead of the suite
RANK_TIMEOUT_S = 180
LOSS_ATOL = LOSS_RTOL = 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(n, outdir):
    """Run ``n`` ranks to their end; returns each rank's dump."""
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    procs = [subprocess.Popen(
        [sys.executable, str(CHILD), coordinator, str(n), str(i), str(outdir)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out}"
    dumps = []
    for i in range(n):
        with open(outdir / f"rank_{i}.json") as f:
            dumps.append(json.load(f))
    return dumps


def _cond_space():
    cs = ConfigurationSpace(seed=1)
    arm = CategoricalHyperparameter("arm", ["a", "b"])
    extra = UniformFloatHyperparameter("extra", 0.0, 1.0)
    cs.add_hyperparameters([UniformFloatHyperparameter("x", 0.0, 1.0),
                            UniformFloatHyperparameter("y", 0.0, 1.0), arm, extra])
    cs.add_condition(EqualsCondition(extra, arm, "a"))
    return cs


def _single_process_twins(n_shards):
    """What one process computes: the conditional FusedBOHB unmeshed, and
    the sharded sweep on a one-process mesh of ``n_shards`` shards."""
    def cond_eval(v, budget):
        return branin(v[:, :2], budget) + 0.05 * v[:, 3]

    fopt = FusedBOHB(configspace=_cond_space(), eval_fn=cond_eval, run_id="one",
                     min_budget=1, max_budget=9, eta=3, seed=1, min_points_in_model=5,
                     device="cpu")
    fopt.run(n_iterations=1)
    fopt.run(n_iterations=2)
    fres = fopt.run(n_iterations=3, chunk_brackets=1)
    fused = sorted([list(r.config_id), float(r.budget), float(r.loss)]
                   for r in fres.get_all_runs() if r.loss is not None)
    multihost._SHARDED_FN_CACHE.clear()
    sharded = multihost.run_sharded_fused_sweep(
        branin, branin_space(seed=0), n_configs=256,
        mesh=config_mesh([torch.device("cpu")] * n_shards), seed=3)
    return fused, sharded


def _reference_hyperband(ref, ref_opt):  # noqa: F811
    cs = ref.toys.branin_space(seed=0)
    ex = ref_opt.parallel.BatchedExecutor(
        ref_opt.parallel.VmapBackend(ref.toys.branin_from_vector), cs, bucket_brackets=False)
    opt = ref_opt.optimizers.HyperBand(configspace=cs, run_id="ref", executor=ex,
                                       min_budget=1, max_budget=9, eta=3, seed=0)
    res = opt.run(n_iterations=3)
    opt.shutdown()
    return sorted([list(r.config_id), float(r.budget), float(r.loss)]
                  for r in res.get_all_runs() if r.loss is not None)


def _assert_close_runs(got, want):
    assert [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               atol=LOSS_ATOL, rtol=LOSS_RTOL)


def test_two_ranks_decide_identically_and_only_rank_0_logs(tmp_path, ref, ref_opt):  # noqa: F811
    rank0, rank1 = _spawn_ranks(2, tmp_path)
    # SPMD determinism: every decision is the same on both ranks
    assert rank0 == rank1
    assert len(rank0["hyperband"]) > 0 and len(rank0["bohb"]) > 0 and len(rank0["fused"]) > 0
    assert rank0["sharded"]["loss"] is not None
    assert rank0["sharded_balance"] == [rank0["sharded_balance"][0]] * 4
    # only rank 0 logs
    assert (tmp_path / "logged" / "results.json").exists()
    assert (tmp_path / "logged" / "configs.json").exists()
    assert sorted(os.listdir(tmp_path)) == ["logged", "rank_0.json", "rank_1.json"]
    # the ranks' runs are one process's runs
    fused, sharded = _single_process_twins(4)
    assert rank0["fused"] == fused
    assert rank0["sharded"] == sharded["incumbent"]
    _assert_close_runs(rank0["hyperband"], _reference_hyperband(ref, ref_opt))


def test_one_rank_group_equals_one_process(tmp_path):
    """A one-rank gloo group runs the same code through the group's
    gathers: its runs equal one process's without a group."""
    (rank0,) = _spawn_ranks(1, tmp_path)
    fused, sharded = _single_process_twins(2)
    assert rank0["fused"] == fused
    assert rank0["sharded"] == sharded["incumbent"]
    assert sorted(os.listdir(tmp_path)) == ["logged", "rank_0.json"]
