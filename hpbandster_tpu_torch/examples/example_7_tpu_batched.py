"""Example 7: the batched path on the card — the point of this framework.

Ported from ``examples/example_7_tpu_batched.py`` (the file keeps its
name): the same MLP search as example 5, but every successive-halving
stage is ONE batched computation: all configs of the stage train
simultaneously on the device, over a config mesh of ``--device``. No
nameserver, no RPC — the Master drives a BatchedExecutor directly.
"""

import argparse
import time

from hpbandster_tpu_torch.device import resolve_device
from hpbandster_tpu_torch.examples.example_1_local_sequential import add_device_arg
from hpbandster_tpu_torch.optimizers import BOHB
from hpbandster_tpu_torch.parallel import BatchedExecutor, VmapBackend, config_mesh
from hpbandster_tpu_torch.workloads.mlp import MLPConfig, make_mlp_eval_fn, mlp_space


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n_iterations", type=int, default=4)
    p.add_argument("--min_budget", type=float, default=10)
    p.add_argument("--max_budget", type=float, default=270)
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cs = mlp_space(seed=0)
    devices = [device]
    backend = VmapBackend(make_mlp_eval_fn(MLPConfig(), device=device),
                          mesh=config_mesh(devices))
    executor = BatchedExecutor(backend, cs)

    bohb = BOHB(
        configspace=cs,
        run_id="example7",
        executor=executor,
        min_budget=args.min_budget,
        max_budget=args.max_budget,
        eta=3,
        seed=0,
        device=device,
    )
    t0 = time.perf_counter()
    res = bohb.run(n_iterations=args.n_iterations)
    dt = time.perf_counter() - t0
    bohb.shutdown()

    inc = res.get_incumbent_id()
    print(f"devices: {len(devices)} ({devices[0].type})")
    print(f"evaluated {executor.total_evaluated} configs in {dt:.2f}s "
          f"({executor.total_evaluated / dt:.1f} configs/s)")
    print(f"best config: {res.get_id2config_mapping()[inc]['config']}")
    print(f"val loss at max budget: {res.get_runs_by_id(inc)[-1].loss:.4f}")
    return res


if __name__ == "__main__":
    main()
