"""Example 2: local parallel run — several background-thread workers.

Ported from ``examples/example_2_local_parallel_threads.py``: same as
example 1 but a pool of workers serving jobs concurrently; the dispatcher
discovers all of them and the master's queue sizes itself to the worker
count.
"""

import argparse

from hpbandster_tpu_torch import BOHB, NameServer
from hpbandster_tpu_torch.device import resolve_device
from hpbandster_tpu_torch.examples.example_1_local_sequential import (
    MyWorker,
    add_device_arg,
    get_configspace,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n_workers", type=int, default=4)
    p.add_argument("--n_iterations", type=int, default=4)
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    ns = NameServer(run_id="example2", host="127.0.0.1", port=0)
    host, port = ns.start()

    workers = []
    for i in range(args.n_workers):
        w = MyWorker(run_id="example2", nameserver=host, nameserver_port=port, id=i)
        w.run(background=True)
        workers.append(w)

    bohb = BOHB(
        configspace=get_configspace(),
        run_id="example2",
        nameserver=host,
        nameserver_port=port,
        min_budget=1,
        max_budget=9,
        device=device,
    )
    res = bohb.run(n_iterations=args.n_iterations, min_n_workers=args.n_workers)

    bohb.shutdown(shutdown_workers=True)
    ns.shutdown()

    incumbent = res.get_incumbent_id()
    print(f"best: {res.get_id2config_mapping()[incumbent]['config']}")
    served = {j.worker_name for j in bohb.jobs}
    print(f"workers that served jobs: {len(served)}")
    return res


if __name__ == "__main__":
    main()
