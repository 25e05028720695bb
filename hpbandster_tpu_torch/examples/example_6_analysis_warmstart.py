"""Example 6: result logging, offline analysis, and warm-starting.

Ported from ``examples/example_6_analysis_warmstart.py``: stream results
to disk with json_result_logger, reload them with
logged_results_to_HBS_result, continue a previous optimization via
``previous_result=`` (the KDE resumes from old data), and produce the
standard analysis plots (``hpbandster_tpu_torch.viz``).
"""

import argparse
import os
import tempfile

from hpbandster_tpu_torch import BOHB, json_result_logger, logged_results_to_HBS_result
from hpbandster_tpu_torch.device import resolve_device
from hpbandster_tpu_torch.examples.example_1_local_sequential import add_device_arg
from hpbandster_tpu_torch.parallel import BatchedExecutor, VmapBackend
from hpbandster_tpu_torch.workloads.toys import branin, branin_space


def make_opt(cs, run_id, device, **kwargs):
    executor = BatchedExecutor(VmapBackend(branin, device=device), cs)
    return BOHB(
        configspace=cs, run_id=run_id, executor=executor,
        min_budget=1, max_budget=27, eta=3, device=device, **kwargs,
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--plot", action="store_true")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    out = args.out_dir or tempfile.mkdtemp(prefix="hpb_example6_")

    # ---- phase 1: run and stream results to disk
    cs = branin_space(seed=0)
    logger = json_result_logger(out, overwrite=True)
    opt = make_opt(cs, "example6", device, seed=0, result_logger=logger)
    res1 = opt.run(n_iterations=4)
    opt.shutdown()
    print(f"phase 1 incumbent: {res1.get_id2config_mapping()[res1.get_incumbent_id()]['config']}")
    print(f"logs written to {out}: {sorted(os.listdir(out))}")

    # ---- phase 2: reload from disk (works on reference-format logs too)
    reloaded = logged_results_to_HBS_result(out)
    assert len(reloaded.get_all_runs()) == len(res1.get_all_runs())

    # ---- phase 3: warm-start a new optimizer from the previous result
    opt2 = make_opt(branin_space(seed=1), "example6b", device, seed=1,
                    previous_result=reloaded)
    res2 = opt2.run(n_iterations=2)
    opt2.shutdown()
    traj = res2.get_incumbent_trajectory()
    print(f"phase 3 final incumbent loss: {traj['losses'][-1]:.4f}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from hpbandster_tpu_torch.viz import correlation_across_budgets, losses_over_time

        losses_over_time(res2.get_all_runs())
        plt.savefig(os.path.join(out, "losses_over_time.png"))
        correlation_across_budgets(res2)
        plt.savefig(os.path.join(out, "correlation.png"))
        plt.close("all")
        print(f"plots saved to {out}")
    return res2


if __name__ == "__main__":
    main()
