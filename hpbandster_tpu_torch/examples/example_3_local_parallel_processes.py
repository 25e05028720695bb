"""Example 3: local parallel run — workers as separate OS processes.

Ported from ``examples/example_3_local_parallel_processes.py``: the same
module doubles as master and worker; run with ``--worker`` to start a
worker process. The master spawns the workers itself here for convenience
(``python -m`` with the repo on ``PYTHONPATH``), but the pattern is exactly
what a cluster job array does (see example 4). The workers' objective runs
on the host; BOHB's model proposals are scored on ``--device``.
"""

import argparse
import os
import subprocess
import sys

from hpbandster_tpu_torch import BOHB, NameServer
from hpbandster_tpu_torch.device import resolve_device
from hpbandster_tpu_torch.examples.example_1_local_sequential import (
    MyWorker,
    add_device_arg,
    get_configspace,
)

#: the directory holding the package, put on the workers' PYTHONPATH
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_MODULE = "hpbandster_tpu_torch.examples.example_3_local_parallel_processes"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--worker", action="store_true", help="run as a worker process")
    p.add_argument("--nameserver", type=str, default="127.0.0.1")
    p.add_argument("--nameserver_port", type=int, default=0)
    p.add_argument("--n_workers", type=int, default=3)
    p.add_argument("--n_iterations", type=int, default=4)
    add_device_arg(p)
    args = p.parse_args(argv)

    if args.worker:
        w = MyWorker(
            run_id="example3",
            nameserver=args.nameserver,
            nameserver_port=args.nameserver_port,
            timeout=30,  # self-shutdown when idle
        )
        w.run(background=False)  # blocks, serving jobs
        return None

    device = resolve_device(args.device)
    ns = NameServer(run_id="example3", host="127.0.0.1", port=0)
    host, port = ns.start()

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [_ROOT, env.get("PYTHONPATH")]))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", _MODULE,
             "--worker", "--nameserver", host, "--nameserver_port", str(port)],
            env=env,
        )
        for _ in range(args.n_workers)
    ]
    try:
        bohb = BOHB(
            configspace=get_configspace(),
            run_id="example3",
            nameserver=host,
            nameserver_port=port,
            min_budget=1,
            max_budget=9,
            device=device,
        )
        res = bohb.run(n_iterations=args.n_iterations, min_n_workers=args.n_workers)
        bohb.shutdown(shutdown_workers=True)
        ns.shutdown()
        for proc in procs:
            proc.wait(timeout=10)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)

    incumbent = res.get_incumbent_id()
    print(f"best: {res.get_id2config_mapping()[incumbent]['config']}")
    return res


if __name__ == "__main__":
    main()
