"""One rank of the tensor-parallel step's two-process test
(``tests/test_torch_tensor_parallel.py``); not collected by pytest.

The rank joins a gloo group on the CPU and runs the split MLP step and its
gradients on three meshes over the group: ``(1, 2)`` with the model axis
across the ranks (one ``cpu`` position a rank, ``config_model_mesh``),
``(2, 2)`` with the model axis across the ranks (each rank one column),
and ``(2, 2)`` with the config axis across the ranks (each rank a row of
two local positions, ``config_model_mesh``). The inputs come from numpy
with a fixed seed (the same as the test's). Each rank writes the gathered
trees, losses and gradients into ``<outdir>/rank_<r>.npz``. It imports the
port alone.

Usage: python torch_tensor_parallel_child.py <coordinator host:port> <proc_id> <outdir>
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def inputs(n=8, d_in=8, width=8, n_classes=4, batch=16, seed=0):
    """The step's inputs as numpy: a lane-stacked tree, a velocity, a
    batch and per-lane hyperparameters."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shapes = {"w1": (n, d_in, width), "b1": (n, width), "w2": (n, width, width),
              "b2": (n, width), "w3": (n, width, n_classes), "b3": (n, n_classes)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    velocity = {k: 0.1 * rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    x = rng.normal(size=(batch, d_in)).astype(np.float32)
    y = rng.integers(0, n_classes, size=(batch,))
    hp = {"lrs": rng.uniform(0.01, 0.3, n), "momenta": rng.uniform(0.0, 0.99, n),
          "wds": rng.uniform(1e-6, 1e-3, n)}
    return params, velocity, x, y, {k: v.astype(np.float32) for k, v in hp.items()}


def main() -> None:
    coordinator, proc_id, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import torch.distributed as dist

    from hpbandster_tpu_torch.parallel.mesh import Mesh, config_model_mesh
    from hpbandster_tpu_torch.parallel.multihost import initialize_multihost
    from hpbandster_tpu_torch.parallel.tensor_parallel import (
        gather_mlp_params,
        mlp_grads_tp,
        sgd_train_step_batch_tp,
        shard_mlp_params,
    )

    initialize_multihost(coordinator, 2, proc_id, backend="gloo", timeout_s=60)
    try:
        group = dist.group.WORLD
        cpu = torch.device("cpu")
        meshes = {
            "model_1x2": config_model_mesh(1, [cpu], process_group=group),
            "model_2x2": Mesh([[cpu, cpu], [cpu, cpu]], ("config", "model"),
                              ranks=[[0, 1], [0, 1]], process_group=group),
            "config_2x2": config_model_mesh(2, [cpu, cpu], process_group=group),
        }
        assert meshes["model_1x2"].ranks.tolist() == [[0, 1]]
        assert meshes["config_2x2"].ranks.tolist() == [[0, 0], [1, 1]]
        params, velocity, x, y, hp = inputs()
        t = {k: torch.from_numpy(v) for k, v in params.items()}
        tv = {k: torch.from_numpy(v) for k, v in velocity.items()}
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        out = {}
        for name, mesh in meshes.items():
            sp, sv = shard_mlp_params(t, mesh), shard_mlp_params(tv, mesh)
            new_p, new_v, losses = sgd_train_step_batch_tp(
                sp, sv, tx, ty, *(torch.from_numpy(hp[k]) for k in ("lrs", "momenta", "wds")),
                mesh)
            grads, _ = mlp_grads_tp(sp, tx, ty, mesh)
            for kind, tree in (("params", new_p), ("velocity", new_v), ("grads", grads)):
                for k, v in gather_mlp_params(tree, mesh).items():
                    out[f"{name}.{kind}.{k}"] = v.numpy()
            out[f"{name}.losses"] = losses.numpy()
        np.savez(os.path.join(outdir, f"rank_{proc_id}.npz"), **out)
        print(f"rank {proc_id}: OK", flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
