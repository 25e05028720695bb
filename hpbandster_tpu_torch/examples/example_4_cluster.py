"""Example 4: cluster deployment via shared-filesystem credentials.

Ported from ``examples/example_4_cluster.py`` (the SGE/SLURM pattern): the
master starts a NameServer with a ``working_directory`` on a shared
filesystem, which drops ``HPB_run_<id>_pyro.pkl`` there; every worker
process on any host calls ``load_nameserver_credentials()`` to find it.
Submit this module once with ``--master`` and N times with ``--worker``
(e.g. as a job array). The workers' objective runs on the host; the
master's model proposals are scored on ``--device``.

Example SLURM sketch::

    sbatch --ntasks=1 run.sh --master --shared_directory /nfs/run1
    sbatch --array=1-32 run.sh --worker --shared_directory /nfs/run1
"""

import argparse

from hpbandster_tpu_torch import BOHB, NameServer, json_result_logger
from hpbandster_tpu_torch.device import resolve_device
from hpbandster_tpu_torch.examples.example_1_local_sequential import (
    MyWorker,
    add_device_arg,
    get_configspace,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--master", action="store_true")
    p.add_argument("--worker", action="store_true")
    p.add_argument("--run_id", type=str, default="example4")
    p.add_argument("--shared_directory", type=str, required=True)
    p.add_argument("--nic_name", type=str, default=None)
    p.add_argument("--min_n_workers", type=int, default=4)
    p.add_argument("--n_iterations", type=int, default=8)
    add_device_arg(p)
    args = p.parse_args(argv)

    if args.worker:
        w = MyWorker(run_id=args.run_id, timeout=120)
        w.load_nameserver_credentials(args.shared_directory)
        w.run(background=False)
        return None

    from hpbandster_tpu_torch.utils import nic_name_to_host

    device = resolve_device(args.device)
    host = nic_name_to_host(args.nic_name)
    ns = NameServer(
        run_id=args.run_id, host=host, port=0,
        working_directory=args.shared_directory,
    )
    ns_host, ns_port = ns.start()

    bohb = BOHB(
        configspace=get_configspace(),
        run_id=args.run_id,
        nameserver=ns_host,
        nameserver_port=ns_port,
        min_budget=1,
        max_budget=9,
        result_logger=json_result_logger(args.shared_directory, overwrite=True),
        device=device,
    )
    res = bohb.run(
        n_iterations=args.n_iterations, min_n_workers=args.min_n_workers
    )
    bohb.shutdown(shutdown_workers=True)
    ns.shutdown()
    print(f"best: {res.get_id2config_mapping()[res.get_incumbent_id()]['config']}")
    return res


if __name__ == "__main__":
    main()
