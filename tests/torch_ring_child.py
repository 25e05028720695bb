"""One rank of the port's two-rank ring attention test
(``tests/test_torch_ring_attention.py``); not collected by pytest.

The rank joins a gloo group on the CPU and builds a four-shard ``seq`` ring
over the group, two ``cpu`` shards per rank, so that a rotation moves one
block inside the rank and sends one to the next rank. On the same global
inputs as the test (numpy, seeded) it runs the ring on its own blocks,
contiguous and striped, forward and backward under its share of a global
loss, and the sequence-parallel transformer with its parameter gradients
summed over the ranks; it writes its rows and gradients into ``<outdir>``.
It imports the port alone.

Usage: python torch_ring_child.py <coordinator host:port> <num_procs> <proc_id> <outdir>
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, H, DH = 32, 2, 8


def global_qkv():
    """The ring's global ``[T, H, dh]`` inputs."""
    import numpy as np

    rng = np.random.default_rng(21)
    return [rng.standard_normal((T, H, DH)).astype(np.float32) for _ in range(3)]


def transformer_inputs():
    """A small transformer config, two lanes of parameters and ``[2, 16]``
    tokens, all from seeds."""
    import numpy as np
    import torch

    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from hpbandster_tpu_torch.workloads import transformer as tfm

    cfg = tfm.TransformerConfig(vocab=8, prefix_len=8, d_model=16, n_heads=2, n_layers=2,
                                d_ff=32)
    gen = torch.Generator().manual_seed(5)
    params = tfm.init_transformer_params(tfm.draw_transformer_unit_params(gen, cfg),
                                         torch.tensor([1.0, 0.6]))
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab + 1, size=(2, cfg.seq_len - 1)))
    return cfg, params, tokens


def main() -> None:
    coordinator, num_procs, proc_id, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from hpbandster_tpu_torch.ops.fused import tree_leaves, tree_map
    from hpbandster_tpu_torch.ops.ring_attention import (
        ring_attention_block,
        seq_mesh,
        stripe_indices,
    )
    from hpbandster_tpu_torch.parallel.multihost import initialize_multihost
    from hpbandster_tpu_torch.workloads import transformer as tfm

    got = initialize_multihost(coordinator, num_procs, proc_id, backend="gloo", timeout_s=60)
    assert got == proc_id, (got, proc_id)
    try:
        mesh = seq_mesh([torch.device("cpu")] * 2, process_group=dist.group.WORLD)
        assert mesh.shape == {"seq": 2 * num_procs}, mesh
        n_shards = 2 * num_procs
        out = {}
        q, k, v = global_qkv()
        per = T // num_procs
        for name, striped in (("contiguous", False), ("striped", True)):
            layout = stripe_indices(T, n_shards)[0] if striped else list(range(T))
            rows = layout[proc_id * per:(proc_id + 1) * per]
            ts = [torch.from_numpy(a[rows]).requires_grad_() for a in (q, k, v)]
            o = ring_attention_block(*ts, mesh, causal=True, compute_dtype=torch.float32,
                                     striped=striped)
            (o ** 2).sum().div(T * H * DH).backward()
            out[name] = {"out": o.detach().tolist(),
                         **{f"d{n}": t.grad.tolist() for n, t in zip("qkv", ts)}}
        cfg, params, tokens = transformer_inputs()
        params = tree_map(lambda p: p.requires_grad_(), params)
        half = tokens.shape[1] // num_procs
        local = tokens[:, proc_id * half:(proc_id + 1) * half]
        logits = tfm.transformer_forward_seq_parallel(params, local, cfg, mesh)
        n_global = logits.numel() * num_procs
        (logits ** 2).sum().div(n_global).backward()
        out["logits"] = logits.detach().tolist()
        out["grads"] = [p.grad.tolist() for p in tree_leaves(params)]
        with open(os.path.join(outdir, f"rank_{proc_id}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
