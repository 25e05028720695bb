#!/usr/bin/env python3
"""Times the CUDA-graph captures of one checkout of the port on one CUDA
card, so that two checkouts can be compared on the same card:

    python3 compare_captures.py --root path/to/checkout --label parent

``--root`` is the directory that holds the checkout's
``hpbandster_tpu_torch`` package. Each program below is captured afresh
``--repeats`` times after one run that is reported apart as ``first`` (the
process's first capture of it, with whatever a process does once), the
sweep cache emptied before every run, through ``FusedBOHB.run()`` on the
dynamic-count tier, which every checkout of the port shares:

* ``chunk``: ``chip_smoke.py``'s ``chunked_long`` first chunk (Hartmann-6,
  budgets 1..81, ``eta=3``, 64 samples, seed 0, the moments-kernel fit,
  five brackets in one chunk);
* ``teacher``: ``TeacherConfig()`` (budgets 1..27, ``--brackets``
  brackets in one chunk);
* ``cnn``: ``CNNConfig()`` (budgets 3..81, ``--brackets`` brackets in one
  chunk).

It prints one ``compare {...}`` JSON line per program: per run the
summed ``build_compile_s`` and ``graph_capture_s`` of its chunks and its
wall seconds, and their medians over the repeats; then the card's name and
power limit. Run the checkouts in turns (A, B, B, A) in one session on one
card, with ``HPB_XLA_CACHE_DIR`` shared so that the kernels build once.
Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path


def measure(torch, dev, label, program, make_opt, n_iterations, repeats, env=None):
    """``repeats + 1`` fresh sweeps of one program; prints and returns its
    ``compare`` record."""
    from hpbandster_tpu_torch.optimizers import fused_bohb

    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    runs = []
    try:
        for _ in range(repeats + 1):
            fused_bohb._SWEEP_CACHE.clear()
            opt = make_opt()
            t0 = time.perf_counter()
            opt.run(n_iterations=n_iterations, chunk_brackets=n_iterations,
                    dynamic_counts=True)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            stats = opt.run_stats
            runs.append(dict(
                build_compile_s=sum(s["build_compile_s"] for s in stats),
                graph_capture_s=sum(s.get("graph_capture_s") or 0.0 for s in stats),
                wall_s=wall))
    finally:
        fused_bohb._SWEEP_CACHE.clear()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    kept = runs[1:]
    rec = dict(label=label, program=program, first=runs[0], runs=kept,
               **{f"median_{k}": statistics.median(r[k] for r in kept)
                  for k in ("build_compile_s", "graph_capture_s", "wall_s")})
    print("compare " + json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", required=True,
                        help="the checkout whose hpbandster_tpu_torch is measured")
    parser.add_argument("--label", required=True, help="the name printed on its lines")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--brackets", type=int, default=3,
                        help="brackets of the teacher and CNN sweeps")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("compare_captures: no CUDA device available", file=sys.stderr)
        return 2
    from hpbandster_tpu_torch import FusedBOHB
    from hpbandster_tpu_torch.ops import _build
    from hpbandster_tpu_torch.workloads import (
        CNNConfig,
        TeacherConfig,
        cnn_space,
        make_cnn_error_fn,
        make_teacher_eval_fn,
        teacher_space,
    )
    from hpbandster_tpu_torch.workloads.toys import hartmann6, hartmann6_space

    dev = torch.device("cuda", 0)
    for name in ("kde_score", "kde_moments"):
        _build.load_library(name)

    def opt_of(space, eval_fn, min_b, max_b, **kw):
        return lambda: FusedBOHB(configspace=space, eval_fn=eval_fn, min_budget=min_b,
                                 max_budget=max_b, eta=3, seed=0, device=dev, **kw)

    measure(torch, dev, args.label, "chunk",
            opt_of(hartmann6_space(seed=0), hartmann6, 1.0, 81.0, num_samples=64),
            5, max(args.repeats, 5), env={"HPB_PALLAS_KDE_FIT": "1"})
    measure(torch, dev, args.label, "teacher",
            opt_of(teacher_space(seed=0), make_teacher_eval_fn(TeacherConfig(), device=dev),
                   1.0, 27.0),
            args.brackets, args.repeats)
    measure(torch, dev, args.label, "cnn",
            opt_of(cnn_space(seed=0), make_cnn_error_fn(CNNConfig(), device=dev), 3.0, 81.0),
            args.brackets, args.repeats)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
