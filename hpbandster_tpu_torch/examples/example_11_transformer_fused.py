"""Example 11: HPO over a transformer, the whole sweep on the device.

Ported from ``examples/example_11_transformer_fused.py``. A decoder-only
transformer trains on the synthetic COPY task (the second half of each
sequence is predictable only by attending back across the separator —
``workloads/transformer.py``), and FusedBOHB runs the whole multi-bracket
sweep on the device: KDE proposals (scored by ``csrc/kde_score.cu`` on a
card), every config's full training run, and top-k promotions.

The attention/MLP matmuls run in bfloat16 with float32 accumulation, as
the reference's do.
"""

import argparse
import time

from hpbandster_tpu_torch.device import resolve_device
from hpbandster_tpu_torch.examples.example_1_local_sequential import add_device_arg
from hpbandster_tpu_torch.optimizers import FusedBOHB
from hpbandster_tpu_torch.workloads.transformer import (
    TRANSFORMER_TARGET_VAL_ACCURACY,
    TransformerConfig,
    make_transformer_error_fn,
    transformer_space,
)

#: the CPU-sized model and data (the test-suite config)
TINY = TransformerConfig(vocab=16, prefix_len=7, d_model=32, n_heads=2, n_layers=2,
                         d_ff=128, n_train=128, n_val=64, batch_size=64)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n_iterations", type=int, default=2)
    p.add_argument("--min_budget", type=float, default=9)
    p.add_argument("--max_budget", type=float, default=81)
    p.add_argument("--tiny", action="store_true",
                   help="CPU-sized model/data (the test-suite config)")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = TINY if args.tiny else TransformerConfig()
    cs = transformer_space(seed=0)
    devices = [device]

    opt = FusedBOHB(
        configspace=cs,
        eval_fn=make_transformer_error_fn(cfg, device=device),
        run_id="example11",
        min_budget=args.min_budget,
        max_budget=args.max_budget,
        eta=3,
        seed=0,
        device=device,
        min_points_in_model=5,
    )
    t0 = time.perf_counter()
    res = opt.run(n_iterations=args.n_iterations)
    dt = time.perf_counter() - t0
    opt.shutdown()

    traj = res.get_incumbent_trajectory()
    acc = 1.0 - traj["losses"][-1]
    print(f"devices: {len(devices)} ({devices[0].type})")
    print(f"evaluated {opt.total_evaluated} configs in {dt:.2f}s "
          f"({opt.total_evaluated / dt:.1f} configs/s)")
    print(f"incumbent copied-half val accuracy: {acc:.3f} "
          f"(chance {1.0 / (cfg.vocab):.3f}, documented target "
          f"{TRANSFORMER_TARGET_VAL_ACCURACY} on the default config)")
    return res


if __name__ == "__main__":
    main()
