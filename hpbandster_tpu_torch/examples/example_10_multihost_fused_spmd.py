"""Example 10: the fused whole-sweep tier across processes (SPMD).

Ported from ``examples/example_10_multihost_fused_spmd.py``. The flagship
``FusedBOHB`` path (example 8) runs a whole multi-bracket sweep on the
device. This example runs it over a ``torch.distributed`` group: every
rank runs the IDENTICAL program, the config mesh spans every rank's
devices, each wave's evaluations shard over the 'config' axis and the
stage records gather back to every rank — so each rank's driver replays
identical promotion decisions with no coordination beyond the group's
collectives (NCCL between cards, gloo on the CPU).

In production, launch one copy per card (or host):

    python -m hpbandster_tpu_torch.examples.example_10_multihost_fused_spmd \\
        --coordinator <host0>:1234 --num_processes 4 --process_id <rank>

Run without ``--coordinator`` to see the topology demonstrated locally:
the module launches its ranks itself — two gloo ranks of two CPU devices
each with ``--device cpu``, one NCCL rank per visible card otherwise —
and checks that the ranks' run records agree (a lone rank's record is
held to the same sweep run in one process, without the group).
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

from hpbandster_tpu_torch.examples.example_1_local_sequential import add_device_arg

_MODULE = "hpbandster_tpu_torch.examples.example_10_multihost_fused_spmd"
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: devices of each rank's share of the mesh on the CPU (the reference's
#: demo gives each host two virtual CPU devices)
_CPU_DEVICES_PER_RANK = 2


def _runs_of(res):
    return sorted(
        (list(r.config_id), float(r.budget), float(r.loss))
        for r in res.get_all_runs()
        if r.loss is not None
    )


def _sweep(mesh, device, logger=None):
    from hpbandster_tpu_torch.optimizers import FusedBOHB
    from hpbandster_tpu_torch.workloads.toys import branin, branin_space

    opt = FusedBOHB(
        configspace=branin_space(seed=0),
        eval_fn=branin,
        run_id="ex10",
        min_budget=1,
        max_budget=27,
        eta=3,
        seed=0,
        mesh=mesh,
        device=device,
        result_logger=logger,
    )
    res = opt.run(n_iterations=4)
    opt.shutdown()
    return res


def run_rank(coordinator: str, num_processes: int, process_id: int,
             device_name: str, out_path: str = "") -> None:
    import torch
    import torch.distributed as dist

    from hpbandster_tpu_torch.core.result import json_result_logger
    from hpbandster_tpu_torch.device import resolve_device
    from hpbandster_tpu_torch.parallel.mesh import config_mesh
    from hpbandster_tpu_torch.parallel.multihost import initialize_multihost, is_primary_host

    device = resolve_device(device_name)
    backend = "gloo" if device.type == "cpu" else "nccl"
    initialize_multihost(coordinator, num_processes, process_id, backend=backend,
                         timeout_s=120)
    try:
        if device.type == "cpu":
            local = [device] * _CPU_DEVICES_PER_RANK
        else:
            local = [torch.device("cuda", torch.cuda.current_device())]
        mesh = config_mesh(local, process_group=dist.group.WORLD)
        # side effects gate on the primary rank; everything else is identical
        # on every rank (same seed -> same deterministic driver control flow)
        logger = (
            json_result_logger(".ex10_results", overwrite=True)
            if is_primary_host() and not out_path
            else None
        )
        res = _sweep(mesh, local[0], logger)
        runs = _runs_of(res)
        print(
            f"rank {dist.get_rank()}/{num_processes}: "
            f"{len(runs)} evaluations over {mesh.size} mesh devices, "
            f"incumbent {res.get_incumbent_id()}",
            flush=True,
        )
        if out_path:
            with open(out_path, "w") as fh:
                json.dump(runs, fh)
        # every rank is done with the group before any tears it down
        dist.barrier()
    finally:
        dist.destroy_process_group()


def self_launch_demo(device_name: str, timeout: float = 600) -> dict:
    """Launch the ranks on this machine and hold their run records equal."""
    import torch

    from hpbandster_tpu_torch.device import resolve_device

    device = resolve_device(device_name)
    n = 2 if device.type == "cpu" else torch.cuda.device_count()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [_ROOT, env.get("PYTHONPATH")]))
    with tempfile.TemporaryDirectory() as td:
        procs = [
            subprocess.Popen(
                [
                    sys.executable, "-m", _MODULE,
                    "--coordinator", coordinator,
                    "--num_processes", str(n),
                    "--process_id", str(i),
                    "--dump", os.path.join(td, f"runs_{i}.json"),
                    "--device", device_name,
                ],
                env=env,
            )
            for i in range(n)
        ]
        try:
            for p in procs:
                p.wait(timeout=timeout)
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait(timeout=10)
        if not all(p.returncode == 0 for p in procs):
            raise RuntimeError(f"a rank failed: {[p.returncode for p in procs]}")
        records = []
        for i in range(n):
            with open(os.path.join(td, f"runs_{i}.json")) as fh:
                records.append([[list(c), b, loss] for c, b, loss in json.load(fh)])
    if n == 1:
        # a lone rank: its record against the same sweep without the group
        alone = [[list(c), b, loss] for c, b, loss in _runs_of(_sweep(None, device))]
        records.append(alone)
    if any(r != records[0] for r in records[1:]):
        raise RuntimeError("ranks disagreed on the run record")
    print(f"demo: {n} rank(s) replayed {len(records[0])} identical runs — SPMD OK")
    return {"ranks": n, "runs": len(records[0]), "records": records[0]}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", default="")
    p.add_argument("--num_processes", type=int, default=0)
    p.add_argument("--process_id", type=int, default=-1)
    p.add_argument("--dump", default="", help=argparse.SUPPRESS)
    add_device_arg(p)
    args = p.parse_args(argv)
    if not args.coordinator:
        return self_launch_demo(args.device)
    run_rank(args.coordinator, args.num_processes, args.process_id, args.device, args.dump)
    return None


if __name__ == "__main__":
    main()
