"""Example 12: long-context attention — the sequence axis over a ring.

Ported from ``examples/example_12_long_context_ring.py``. A sequence far
longer than one device would want to hold is attended EXACTLY by sharding
positions across the mesh's 'seq' ring (``ops/ring_attention.py``):
queries stay resident while K/V blocks rotate with online-softmax
accumulation, and the backward pass re-rotates K/V so TRAINING memory
stays O(T/P · d) per shard too. ``--striped`` selects the load-balanced
causal schedule (positions striped across the ring) — same exact result,
balanced work.

The ring's shards are ``--device`` repeated :data:`RING_SHARDS` times (the
reference's demo ran over eight devices). The demo runs forward +
backward at a context length scaled by the ring size, checks the result
against dense attention on a small prefix, and prints the per-shard memory
arithmetic that makes the point.
"""

import argparse
import time

import torch

from hpbandster_tpu_torch.device import resolve_device
from hpbandster_tpu_torch.examples.example_1_local_sequential import add_device_arg
from hpbandster_tpu_torch.ops.ring_attention import make_ring_attention, seq_mesh

#: shards of the ring (the device repeated)
RING_SHARDS = 8


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seq_per_device", type=int, default=512)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--head_dim", type=int, default=64)
    p.add_argument("--striped", action="store_true")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    n = RING_SHARDS
    mesh = seq_mesh([device] * n)
    t = args.seq_per_device * n
    h, dh = args.heads, args.head_dim

    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((t, h, dh), generator=gen, device=device) for _ in range(3))

    ring = make_ring_attention(mesh, striped=args.striped)

    def grads_of(q, k, v):
        q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
        (ring(q, k, v) ** 2).mean().backward()
        return q.grad, k.grad, v.grad

    t0 = time.perf_counter()
    grads = grads_of(q, k, v)
    _sync(device)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    grads_of(q, k, v)
    _sync(device)
    steady = time.perf_counter() - t0

    # correctness spot-check: CAUSAL output at position p depends only on
    # positions <= p, so the ring's first rows must equal dense attention
    # computed over just that prefix
    t0_chk = min(128, t)
    with torch.no_grad():
        out = ring(q, k, v)
        s = torch.einsum("qhd,khd->hqk", q[:t0_chk], k[:t0_chk]) * (dh ** -0.5)
        causal = torch.tril(torch.ones((t0_chk, t0_chk), dtype=torch.bool, device=device))
        s = torch.where(causal[None], s, torch.full_like(s, -1e30))
        dense = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v[:t0_chk])
        err = float((out[:t0_chk] - dense).abs().max())
    assert err < 5e-2, f"ring diverged from dense on the prefix: {err}"

    blk_mb = args.seq_per_device * h * dh * 4 / 2**20
    full_mb = t * h * dh * 4 / 2**20
    print(f"devices: {n} ({device.type}, one device repeated); "
          f"context T={t} ({args.seq_per_device}/device), "
          f"H={h}, dh={dh}, striped={args.striped}")
    print(f"prefix parity vs dense (first {t0_chk} positions): "
          f"max|d| = {err:.1e}")
    print(f"per-device K or V block: {blk_mb:.1f} MiB; "
          f"full-sequence K or V: {full_mb:.1f} MiB — the ring never "
          f"materializes the full tensor, forward OR backward")
    print(f"forward+backward: {first:.2f}s first call, "
          f"{steady:.2f}s steady-state")
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    assert finite
    print("grads finite: OK")
    return {"t": t, "err": err, "first_s": first, "steady_s": steady, "grads_finite": finite}


if __name__ == "__main__":
    main()
