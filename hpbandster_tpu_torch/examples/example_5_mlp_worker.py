"""Example 5: a real training workload — MLP hyperparameter search.

Ported from ``examples/example_5_mlp_worker.py``: each worker trains a
PyTorch MLP on a classification task, with budget = number of SGD steps.
This is the *host-pool* version — each worker trains one config at a time
on ``--device``, exactly like the reference. Compare example 7, where the
same workload runs as one batched computation on the card.
"""

import argparse

import torch

from hpbandster_tpu_torch import BOHB, NameServer, Worker
from hpbandster_tpu_torch.device import resolve_device
from hpbandster_tpu_torch.examples.example_1_local_sequential import add_device_arg
from hpbandster_tpu_torch.workloads.mlp import MLPConfig, make_mlp_eval_fn, mlp_space


class MLPWorker(Worker):
    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)
        self.eval_fn = make_mlp_eval_fn(MLPConfig(), device=self.device)
        self.space = mlp_space()

    def compute(self, config_id, config, budget, working_directory):
        vec = torch.as_tensor(self.space.to_vector(config), dtype=torch.float32,
                              device=self.device)
        loss = float(self.eval_fn(vec[None], float(budget))[0])
        return {"loss": loss, "info": {"steps": int(budget)}}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n_workers", type=int, default=2)
    p.add_argument("--n_iterations", type=int, default=3)
    p.add_argument("--min_budget", type=float, default=10)
    p.add_argument("--max_budget", type=float, default=270)
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    ns = NameServer(run_id="example5", host="127.0.0.1", port=0)
    host, port = ns.start()
    for i in range(args.n_workers):
        MLPWorker(
            run_id="example5", nameserver=host, nameserver_port=port, id=i,
            device=device,
        ).run(background=True)

    bohb = BOHB(
        configspace=mlp_space(),
        run_id="example5",
        nameserver=host,
        nameserver_port=port,
        min_budget=args.min_budget,
        max_budget=args.max_budget,
        eta=3,
        device=device,
    )
    res = bohb.run(n_iterations=args.n_iterations, min_n_workers=args.n_workers)
    bohb.shutdown(shutdown_workers=True)
    ns.shutdown()

    inc = res.get_incumbent_id()
    runs = res.get_runs_by_id(inc)
    print(f"best config: {res.get_id2config_mapping()[inc]['config']}")
    print(f"val loss at max budget: {runs[-1].loss:.4f}")
    return res


if __name__ == "__main__":
    main()
