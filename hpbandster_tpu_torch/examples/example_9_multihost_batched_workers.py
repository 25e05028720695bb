"""Example 9: the multi-host batched tier — one card (or mesh) per worker.

Ported from ``examples/example_9_multihost_batched_workers.py``. Between
the single-program fused sweep (example 8) and the one-config-per-RPC host
pool (examples 2-4) sits the ``TPUBatchedWorker`` tier (it keeps the
reference's name): every worker process owns its local device or mesh,
registers with the nameserver like any other worker, and evaluates a whole
*vector* of configurations per RPC as one batched device computation. The
master side (``RPCBatchBackend`` inside a ``BatchedExecutor``) splits each
stage's wave across the registered workers proportional to their device
counts, retries failed shards on survivors, and keeps the usual elastic
join/leave semantics. The master's model proposals are scored on
``--device``.

This module demonstrates the full topology in one process (workers as
background threads); point the workers at a remote nameserver to split it
for real.
"""

import argparse
import time

from hpbandster_tpu_torch import NameServer
from hpbandster_tpu_torch.device import resolve_device
from hpbandster_tpu_torch.examples.example_1_local_sequential import add_device_arg
from hpbandster_tpu_torch.optimizers import BOHB
from hpbandster_tpu_torch.parallel import BatchedExecutor, RPCBatchBackend, TPUBatchedWorker
from hpbandster_tpu_torch.workloads.toys import BRANIN_OPT, branin, branin_space


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n_workers", type=int, default=2)
    p.add_argument("--n_iterations", type=int, default=8)
    p.add_argument("--min_budget", type=float, default=1)
    p.add_argument("--max_budget", type=float, default=81)
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cs = branin_space(seed=0)
    ns = NameServer(run_id="ex9", host="127.0.0.1", port=0)
    host, port = ns.start()

    # in production: one of these per host, each owning its local devices
    # (mesh="auto" shards each wave over every visible card)
    workers = []
    try:
        for i in range(args.n_workers):
            w = TPUBatchedWorker(
                run_id="ex9",
                eval_fn=branin,
                configspace=cs,
                mesh="auto" if i == 0 else None,  # demo: mixed device counts
                device=device,
                nameserver=host,
                nameserver_port=port,
                id=i,
            )
            w.run(background=True)
            workers.append(w)

        backend = RPCBatchBackend("ex9", host, port)
        backend.wait_for_workers(args.n_workers, timeout=30)
        print(f"pool: {args.n_workers} batched workers, {backend.parallelism} devices")

        bohb = BOHB(
            configspace=cs, run_id="ex9",
            executor=BatchedExecutor(backend, cs),
            min_budget=args.min_budget, max_budget=args.max_budget, eta=3, seed=0,
            device=device,
        )
        t0 = time.perf_counter()
        res = bohb.run(n_iterations=args.n_iterations)
        dt = time.perf_counter() - t0
        bohb.shutdown()
    finally:
        for w in workers:
            w.shutdown()
        ns.shutdown()

    runs = res.get_all_runs()
    print(
        f"{len(runs)} evaluations over RPC waves in {dt:.1f}s "
        f"({len(runs) / dt:.1f} configs/s)"
    )
    traj = res.get_incumbent_trajectory()
    print(f"incumbent loss: {traj['losses'][-1]:.4f} (optimum ~{BRANIN_OPT:.4f})")
    return res


if __name__ == "__main__":
    main()
