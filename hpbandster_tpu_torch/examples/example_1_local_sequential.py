"""Example 1: local sequential run — one in-process worker.

Ported from ``examples/example_1_local_sequential.py``: start a
NameServer, run one Worker in the background *inside this process*,
optimize a toy objective with BOHB, inspect the Result. The objective runs
on the host; BOHB's model proposals are scored on ``--device``.
"""

import argparse

import numpy as np

from hpbandster_tpu_torch import BOHB, NameServer, Worker
from hpbandster_tpu_torch.device import resolve_device
from hpbandster_tpu_torch.space import ConfigurationSpace, UniformFloatHyperparameter


class MyWorker(Worker):
    """Toy objective: distance of x to 0.75 (known optimum), noisier at
    small budgets."""

    def compute(self, config_id, config, budget, working_directory):
        x = config["x"]
        noise = 0.1 * np.random.RandomState(config_id[2]).randn() / np.sqrt(budget)
        return {"loss": float((x - 0.75) ** 2 + noise), "info": {"budget": budget}}


def get_configspace():
    cs = ConfigurationSpace()
    cs.add_hyperparameter(UniformFloatHyperparameter("x", 0.0, 1.0))
    return cs


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device for the device work (default cuda; cpu on request)")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n_iterations", type=int, default=4)
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    ns = NameServer(run_id="example1", host="127.0.0.1", port=0)
    host, port = ns.start()

    w = MyWorker(run_id="example1", nameserver=host, nameserver_port=port)
    w.run(background=True)

    bohb = BOHB(
        configspace=get_configspace(),
        run_id="example1",
        nameserver=host,
        nameserver_port=port,
        min_budget=1,
        max_budget=9,
        device=device,
    )
    res = bohb.run(n_iterations=args.n_iterations)

    bohb.shutdown(shutdown_workers=True)
    ns.shutdown()

    id2config = res.get_id2config_mapping()
    incumbent = res.get_incumbent_id()
    print(f"best found configuration: {id2config[incumbent]['config']}")
    print(f"total configurations sampled: {len(id2config)}")
    print(f"total runs executed: {len(res.get_all_runs())}")
    return res


if __name__ == "__main__":
    main()
