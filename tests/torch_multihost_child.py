"""One rank of the port's multi-process test (``tests/test_torch_multihost.py``);
not collected by pytest.

The rank joins a gloo group on the CPU, builds a config mesh of two local
``cpu`` devices per rank over the group, and runs the same deterministic
sweeps as every other rank (the SPMD driver contract of
``hpbandster_tpu_torch/parallel/multihost.py``): ``HyperBand`` and ``BOHB``
over ``MultiHostBatchedExecutor``, ``FusedBOHB(mesh=)`` on a conditional
space (static, warm static and chunked), and ``run_sharded_fused_sweep``. It
writes what it decided into ``<outdir>``; only rank 0 attaches a result
logger. It imports the port alone.

Usage: python torch_multihost_child.py <coordinator host:port> <num_procs> <proc_id> <outdir>
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def runs_of(res):
    """Every finished run as ``[config_id, budget, loss]``, sorted."""
    return sorted([list(r.config_id), float(r.budget), float(r.loss)]
                  for r in res.get_all_runs() if r.loss is not None)


def main() -> None:
    coordinator, num_procs, proc_id, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from hpbandster_tpu_torch.core.result import json_result_logger
    from hpbandster_tpu_torch.optimizers import BOHB, FusedBOHB, HyperBand
    from hpbandster_tpu_torch.parallel import VmapBackend
    from hpbandster_tpu_torch.parallel.mesh import config_mesh, is_multiprocess_mesh
    from hpbandster_tpu_torch.parallel.multihost import (
        MultiHostBatchedExecutor,
        initialize_multihost,
        is_primary_host,
        run_sharded_fused_sweep,
    )
    from hpbandster_tpu_torch.space import (
        CategoricalHyperparameter,
        ConfigurationSpace,
        EqualsCondition,
        UniformFloatHyperparameter,
    )
    from hpbandster_tpu_torch.workloads.toys import branin, branin_space

    got = initialize_multihost(coordinator, num_procs, proc_id, backend="gloo", timeout_s=60)
    assert got == proc_id, (got, proc_id)
    try:
        mesh = config_mesh([torch.device("cpu")] * 2, process_group=dist.group.WORLD)
        assert mesh.shape == {"config": 2 * num_procs}, mesh
        assert is_multiprocess_mesh(mesh) == (num_procs > 1)
        out = {}
        for name, cls, kw in (("hyperband", HyperBand, {}),
                              ("bohb", BOHB, {"min_points_in_model": 4, "device": "cpu"})):
            executor = MultiHostBatchedExecutor(VmapBackend(branin, mesh=mesh),
                                                branin_space(seed=0))
            assert executor.primary == (proc_id == 0) == is_primary_host()
            logger = None
            if executor.primary and name == "bohb":
                logger = json_result_logger(os.path.join(outdir, "logged"), overwrite=True)
            opt = cls(configspace=branin_space(seed=0), run_id=f"dist-{name}",
                      executor=executor, min_budget=1, max_budget=9, eta=3, seed=0,
                      result_logger=logger, **kw)
            res = opt.run(n_iterations=3)
            opt.shutdown()
            out[name] = runs_of(res)

        cs = ConfigurationSpace(seed=1)
        arm = CategoricalHyperparameter("arm", ["a", "b"])
        extra = UniformFloatHyperparameter("extra", 0.0, 1.0)
        cs.add_hyperparameters([UniformFloatHyperparameter("x", 0.0, 1.0),
                                UniformFloatHyperparameter("y", 0.0, 1.0), arm, extra])
        cs.add_condition(EqualsCondition(extra, arm, "a"))

        def cond_eval(v, budget):
            return branin(v[:, :2], budget) + 0.05 * v[:, 3]

        fopt = FusedBOHB(configspace=cs, eval_fn=cond_eval, run_id="dist-fused",
                         min_budget=1, max_budget=9, eta=3, seed=1, mesh=mesh,
                         min_points_in_model=5)
        fopt.run(n_iterations=1)
        fopt.run(n_iterations=2)
        fres = fopt.run(n_iterations=3, chunk_brackets=1)
        assert not fopt.run_stats[1]["dynamic_counts"] and fopt.run_stats[-1]["dynamic_counts"]
        for entry in fres.get_id2config_mapping().values():
            assert ("extra" in entry["config"]) == (entry["config"]["arm"] == "a")
        out["fused"] = runs_of(fres)
        if num_procs > 1:
            try:
                fopt.run_incumbent(2)
            except ValueError as e:
                assert "single-process" in str(e)
            else:
                raise AssertionError("run_incumbent ran on a multi-process mesh")

        sharded = run_sharded_fused_sweep(branin, branin_space(seed=0), n_configs=256,
                                          mesh=mesh, seed=3)
        out["sharded"] = sharded["incumbent"]
        out["sharded_balance"] = sharded["per_device_configs"]
        with open(os.path.join(outdir, f"rank_{proc_id}.json"), "w") as f:
            json.dump(out, f)
        print(f"rank {proc_id}: OK", flush=True)
        # every rank is done with the group before any tears it down
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
