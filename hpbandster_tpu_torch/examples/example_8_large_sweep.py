"""Example 8: the north-star workload — a large multi-bracket BOHB sweep.

Ported from ``examples/example_8_large_sweep.py``: BOHB, eta=3, budget
ladder 1..81, 27 successive-halving brackets (~1200 config evaluations).
Two execution modes:

* ``--fused`` (default): the ENTIRE sweep — KDE proposals, evaluations,
  top-k promotions, per-budget model refits — runs on the device
  (``ops/sweep.py``); its proposals are scored by ``csrc/kde_score.cu``.
* ``--no-fused``: the per-bracket batched path (``BatchedExecutor`` +
  ``VmapBackend``), where each stage is one batched device computation —
  use this for non-batchable objectives.

For LONG fused sweeps add ``--chunk_brackets K`` (+ optionally
``--checkpoint PATH``): the schedule runs in K-bracket chunks on the
dynamic-count tier — on a card each chunk is one captured CUDA graph,
replayed for every chunk of the same shape, results stream after every
chunk, and a killed run resumes from the last chunk boundary (rebuild the
same optimizer, ``load_checkpoint(PATH)``, call ``run()`` again)
reproducing the uninterrupted run exactly.
"""

import argparse
import time

from hpbandster_tpu_torch.device import resolve_device
from hpbandster_tpu_torch.examples.example_1_local_sequential import add_device_arg
from hpbandster_tpu_torch.optimizers import BOHB, FusedBOHB
from hpbandster_tpu_torch.parallel import BatchedExecutor, VmapBackend
from hpbandster_tpu_torch.workloads.toys import BRANIN_OPT, branin, branin_space


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n_iterations", type=int, default=27)
    p.add_argument("--eta", type=float, default=3)
    p.add_argument("--max_budget", type=float, default=81)
    p.add_argument("--fused", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument(
        "--chunk_brackets", type=int, default=None,
        help="fused mode: run in K-bracket chunks (dynamic-count tier; "
             "graph reuse + streamed results + resumable boundaries)",
    )
    p.add_argument(
        "--checkpoint", default=None,
        help="fused+chunked mode: write a resumable checkpoint after "
             "every chunk",
    )
    add_device_arg(p)
    args = p.parse_args(argv)
    if not args.fused and (
        args.chunk_brackets is not None or args.checkpoint is not None
    ):
        p.error("--chunk_brackets/--checkpoint require the fused mode")
    device = resolve_device(args.device)

    cs = branin_space(seed=0)
    devices = [device]

    if args.fused:
        opt = FusedBOHB(
            configspace=cs, eval_fn=branin, run_id="sweep",
            min_budget=1, max_budget=args.max_budget, eta=args.eta, seed=0,
            device=device,
        )
    else:
        backend = VmapBackend(branin, min_pad=128, device=device)
        opt = BOHB(
            configspace=cs, run_id="sweep",
            executor=BatchedExecutor(backend, cs),
            min_budget=1, max_budget=args.max_budget, eta=args.eta, seed=0,
            device=device,
        )

    t0 = time.perf_counter()
    if args.fused:
        res = opt.run(
            n_iterations=args.n_iterations,
            chunk_brackets=args.chunk_brackets,
            checkpoint_path=args.checkpoint,
        )
    else:
        res = opt.run(n_iterations=args.n_iterations)
    dt = time.perf_counter() - t0
    opt.shutdown()

    runs = res.get_all_runs()
    traj = res.get_incumbent_trajectory()
    mode = "fused whole-sweep" if args.fused else "per-bracket batched"
    if args.chunk_brackets is not None:
        fresh = sum(
            1 for s in opt.run_stats if not s["compile_cache_hit"]
        )
        mode += (
            f", {args.chunk_brackets}-bracket chunks "
            f"({len(opt.run_stats)} chunks, {fresh} fresh compiles)"
        )
    print(f"devices: {len(devices)} ({devices[0].type}); mode: {mode}")
    print(
        f"{len(runs)} evaluations, {args.n_iterations} brackets, {dt:.1f}s "
        f"({len(runs) / dt:.1f} configs/s, incl. compile)"
    )
    print(f"incumbent loss: {traj['losses'][-1]:.4f} (optimum ~{BRANIN_OPT:.4f})")
    print(f"incumbent config: {res.get_id2config_mapping()[res.get_incumbent_id()]['config']}")
    return res


if __name__ == "__main__":
    main()
