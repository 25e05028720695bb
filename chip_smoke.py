#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``hpbandster_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card
    python3 chip_smoke.py --profile  # also profiles one sweep's device time

Phases, each fatal on failure:

1. build every CUDA kernel of the main path from ``hpbandster_tpu_torch/csrc``
   (``nvcc`` for ``sm_90a``) and print the build time and ptxas report;
2. hold each kernel against its plain PyTorch version on the card at scale
   checks: the main path's candidate count against a few hundred
   observations, the scale the TPU kernel was written for, and a mixed-type
   case with partly and fully masked observations;
3. drive the main path, ``FusedBOHB.run()`` on Hartmann-6 and Branin at
   ``max_budget=81, eta=3, num_samples=64, n_iterations=10`` (two HyperBand
   rotations), with the kernel launch counts reset just before and read
   just after, and every launch's inputs recorded; check runs per budget,
   finite losses, that the incumbent is no worse than the first bracket's
   stage 0 re-evaluated at ``max_budget`` and strictly better than the
   median of seeded random searches given the same total budget, that
   model-based picks beat random picks (median stage-0 loss in the brackets
   that had a model), and that the kernels were launched;
4. hold each kernel against its plain version on every input the main path
   gave it, and time both at the largest of those launches;
5. print the kernels' JSON line, the card's name and power limit, and last
   the JSON result line.

Errors are max absolute differences; times are medians of CUDA-event-timed
calls after warm-up.

It imports nothing of jax or the JAX package, exits non-zero without a CUDA
device, and starts no process that outlives it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

#: published peaks of one H100 SXM (dense): float32 outside the tensor
#: cores, and HBM3 bandwidth
H100_F32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12
#: special-function unit (exp, log) results per second: 16 per clock per SM
#: (Hopper architecture) x 132 SMs x the 1.98 GHz boost clock
H100_SFU_PER_S = 16 * 132 * 1.98e9
SCORE_ATOL = 1e-4
#: seeded random searches that the incumbent is held against
RANDOM_SEARCH_REPLICATES = 64


def _median_ms(fn, torch, reps=20, warmup=3):
    """Median device time of ``fn()`` in milliseconds, CUDA events around
    each call after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _score_inputs(torch, dev, seed, s, n_good, n_bad, vartypes, cards,
                  good_live=None, bad_live=None):
    """Candidates and a good/bad KDE pair on the card, made from a numpy
    seed; ``*_live`` rows of each side are masked in (default: all)."""
    from hpbandster_tpu_torch.ops.kde import KDE, normal_reference_bandwidths

    rng = np.random.default_rng(seed)
    d = len(vartypes)
    cards = np.asarray(cards, np.int32)

    def draw(n):
        x = rng.uniform(size=(n, d)).astype(np.float32)
        for j in range(d):
            if cards[j] > 0:
                x[:, j] = rng.integers(cards[j], size=n)
        return torch.from_numpy(x).to(dev)

    cards_t = torch.from_numpy(cards).to(dev)

    def kde(n, live):
        data = draw(n)
        mask = torch.zeros(n, dtype=torch.float32, device=dev)
        mask[: n if live is None else live] = 1.0
        bw = normal_reference_bandwidths(data, mask, cards_t)
        return KDE(data, mask, bw)

    vt = torch.as_tensor(np.asarray(vartypes, np.int32), device=dev)
    return draw(s), kde(n_good, good_live), kde(n_bad, bad_live), vt, cards_t


def kde_score_work(cands, good, bad, vt):
    """What the scorer's function needs on these inputs: bytes moved (each
    input read once, the output written once), float32 operations and
    exponentials. Per masked-in (candidate, observation) pair: 4 float32
    operations per dim (continuous: difference, scale, square, accumulate;
    discrete: difference, square, compare, accumulate), 3 for the
    logsumexp update (max, subtract, add) and one exponential. The per-side
    constants (``log bw``, ``log sqrt(2 pi)``, ``log n_eff``) factor out of
    the logsumexp and are not counted per pair."""
    s, d = cands.shape
    n_rows = good.data.shape[0] + bad.data.shape[0]
    live = int((good.mask > 0).sum()) + int((bad.mask > 0).sum())
    bytes_moved = 4 * (s * d + n_rows * d + n_rows + 2 * d + 2 * d + s)
    pairs = s * live
    return bytes_moved, pairs * (4 * d + 3), pairs


def bound_ms(bytes_moved, flops, exps):
    """Least time for the work: the largest of bytes over HBM bandwidth,
    float32 operations over the float32 peak and exponentials over the
    special-function rate. Returns ``(ms, "bytes" | "operations")``."""
    t_bytes = bytes_moved / H100_HBM_BYTES_PER_S
    t_ops = max(flops / H100_F32_FLOPS, exps / H100_SFU_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def hold_kde_score(torch, label, cands, good, bad, vt, cards, n_proposals, reps=20):
    """The scorer kernel against its plain version on one input: max abs
    error (fatal above ``SCORE_ATOL``), whether each proposal's argmax
    agrees, median times and the bound. Returns the record it prints."""
    from hpbandster_tpu_torch.ops import cuda_kde

    got = cuda_kde.score_candidates(cands, good, bad, vt, cards)
    want = cuda_kde.score_candidates_reference(cands, good, bad, vt, cards)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"kde_score {label}: non-finite scores")
    err = float((got - want).abs().max())
    if not err <= SCORE_ATOL:
        raise AssertionError(f"kde_score {label}: max abs err {err} > {SCORE_ATOL}")
    same_pick = bool(torch.equal(got.reshape(n_proposals, -1).argmax(1),
                                 want.reshape(n_proposals, -1).argmax(1)))
    ms = _median_ms(lambda: cuda_kde.score_candidates(cands, good, bad, vt, cards),
                    torch, reps=reps)
    plain_ms = _median_ms(
        lambda: cuda_kde.score_candidates_reference(cands, good, bad, vt, cards),
        torch, reps=reps)
    b_ms, b_by = bound_ms(*kde_score_work(cands, good, bad, vt))
    rec = dict(shape=label, S=int(cands.shape[0]), d=int(cands.shape[1]),
               n_good=int((good.mask > 0).sum()), n_bad=int((bad.mask > 0).sum()),
               max_abs_err=err, same_argmax=same_pick, ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print("kde_score check " + json.dumps(rec), flush=True)
    return rec


def check_kde_score(torch, dev):
    """Phase 2: the scorer kernel against its plain version at scale checks
    beyond the main path's own launches. Returns one record per shape."""
    cases = [
        # the main path's candidate count (81 proposals x 64 samples, d=6)
        # against the observation counts of a long sweep
        ("scale_5184x(64+320)", 81, dict(s=5184, n_good=64, n_bad=320,
                                         vartypes=[0] * 6, cards=[0] * 6)),
        # the scale the TPU kernel was written for (pallas_kde.py:4-6)
        ("scale_tpu_docstring", 1, dict(s=8192, n_good=256, n_bad=256,
                                        vartypes=[0] * 10 + [1] * 3 + [2] * 3,
                                        cards=[0] * 10 + [3, 4, 5] + [4, 6, 8])),
        # all three kernel types, partly masked good side, all-masked bad side
        ("mixed_masked", 1, dict(s=1000, n_good=40, n_bad=30,
                                 vartypes=[0, 1, 2, 0, 1], cards=[0, 3, 5, 0, 2],
                                 good_live=25, bad_live=0)),
    ]
    return [hold_kde_score(torch, name, *_score_inputs(torch, dev, 100 + i, **kw), n)
            for i, (name, n, kw) in enumerate(cases)]


def check_main_path_launches(torch, recorded, num_samples=64):
    """Phase 4: the scorer kernel against its plain version on every input
    the main path gave it, timed at the largest (most candidate-observation
    pairs). Returns (the largest launch's record, max abs err over all)."""
    def pairs(inputs):
        cands, good, bad = inputs[:3]
        return cands.shape[0] * int((good.mask > 0).sum() + (bad.mask > 0).sum())

    largest = max(range(len(recorded)), key=lambda i: pairs(recorded[i]))
    shapes, max_err, largest_rec = [], 0.0, None
    for i, inputs in enumerate(recorded):
        n = inputs[0].shape[0] // num_samples
        rec = hold_kde_score(torch, f"main_path_launch_{i}", *inputs, n,
                             reps=20 if i == largest else 3)
        max_err = max(max_err, rec["max_abs_err"])
        shapes.append((rec["S"], rec["n_good"], rec["n_bad"], rec["d"]))
        if i == largest:
            largest_rec = rec
    print("main path kde_score launches (S, n_good, n_bad, d): "
          + json.dumps(shapes), flush=True)
    return largest_rec, max_err


def _stage0_medians(iterations):
    """Median stage-0 loss of model-based and of random picks, pooled over
    the brackets that had a model (each compares picks at one budget)."""
    model, rand = [], []
    for it in iterations:
        picks = [d for c, d in it.data.items() if c[1] == 0]
        if not any(d.config_info["model_based_pick"] for d in picks):
            continue
        for d in picks:
            loss = d.results[it.budgets[0]]
            (model if d.config_info["model_based_pick"] else rand).append(loss)
    return float(np.median(model)), float(np.median(rand))


def random_search_median_best(torch, dev, fn, space, n_evals, budget):
    """Median over ``RANDOM_SEARCH_REPLICATES`` seeded random searches of the
    best loss among ``n_evals`` uniform configurations evaluated at
    ``budget``: the baseline a sweep of the same total budget must beat.
    The smoke objectives' spaces are all-float, so a uniform configuration
    is a uniform point of the unit cube."""
    d = len(space.get_hyperparameters())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    v = torch.rand((RANDOM_SEARCH_REPLICATES * n_evals, d), generator=gen, device=dev)
    best = fn(v, budget).reshape(RANDOM_SEARCH_REPLICATES, n_evals).min(dim=1).values
    return float(best.median())


def drive_main_path(torch, dev, max_budget=81.0, n_iterations=10, num_samples=64):
    """Phase 3: FusedBOHB.run() on Hartmann-6 and Branin. Returns per-run
    records; raises on a failed check."""
    from hpbandster_tpu_torch import FusedBOHB
    from hpbandster_tpu_torch.ops import cuda_kde
    from hpbandster_tpu_torch.ops.bracket import hyperband_bracket
    from hpbandster_tpu_torch.workloads.toys import (
        branin,
        branin_space,
        hartmann6,
        hartmann6_space,
    )

    runs = []
    for name, space, fn in (("hartmann6", hartmann6_space, hartmann6),
                            ("branin", branin_space, branin)):
        before = cuda_kde.LAUNCHES["kde_score"]
        t0 = time.perf_counter()
        opt = FusedBOHB(configspace=space(seed=0), eval_fn=fn, min_budget=1,
                        max_budget=max_budget, eta=3, num_samples=num_samples,
                        seed=0, device=dev)
        res = opt.run(n_iterations=n_iterations)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = cuda_kde.LAUNCHES["kde_score"] - before

        want = {}
        for i in range(n_iterations):
            p = hyperband_bracket(i, 1.0, max_budget, 3.0)
            for k, b in zip(p.num_configs, p.budgets):
                want[b] = want.get(b, 0) + k
        total_budget = sum(k * b for b, k in want.items())
        got = {}
        for r in res.get_all_runs():
            got[r.budget] = got.get(r.budget, 0) + 1
        if got != want:
            raise AssertionError(f"{name}: runs per budget {got} != plan {want}")
        losses = np.asarray([r.loss for r in res.get_all_runs()], np.float64)
        if not np.isfinite(losses).all():
            raise AssertionError(f"{name}: non-finite losses")
        inc = res.get_incumbent_id()
        inc_loss = res.get_runs_by_id(inc)[-1].loss
        first = opt.iterations[0]
        stage0 = [c for c in first.data if c[1] == 0]
        vecs = np.stack([opt.configspace.to_vector(first.data[c].config) for c in stage0])
        first_best = float(fn(torch.as_tensor(vecs, dtype=torch.float32, device=dev),
                              max_budget).min())
        if not inc_loss <= first_best:
            raise AssertionError(
                f"{name}: incumbent {inc_loss} is worse than the first "
                f"bracket's stage 0 at budget {max_budget} ({first_best})")
        rs_best = random_search_median_best(torch, dev, fn, opt.configspace,
                                            int(total_budget // max_budget), max_budget)
        if not inc_loss < rs_best:
            raise AssertionError(
                f"{name}: incumbent {inc_loss} is not below the median best "
                f"({rs_best}) of random searches given the same total budget")
        model_med, random_med = _stage0_medians(opt.iterations)
        if not model_med < random_med:
            raise AssertionError(
                f"{name}: model-based picks (median stage-0 loss {model_med}) "
                f"do not beat random picks ({random_med}) in model brackets")
        model_brackets = sum(
            any(d.config_info["model_based_pick"] for d in it.data.values())
            for it in opt.iterations)
        if launches < 1 or launches > n_iterations:
            raise AssertionError(f"{name}: kde_score launched {launches} times")
        rec = dict(objective=name, wall_s=wall, sweep_s=opt.run_stats[-1]["sweep_s"],
                   evaluations=int(len(losses)), incumbent_loss=inc_loss,
                   first_bracket_stage0_best_at_max_budget=first_best,
                   random_search_median_best=rs_best,
                   stage0_median_model=model_med, stage0_median_random=random_med,
                   kde_score_launches=launches, model_based_brackets=model_brackets)
        print("main path " + json.dumps(rec), flush=True)
        runs.append(rec)
    return runs


def profile_sweep(torch, dev):
    """Device time by kernel over one Hartmann-6 sweep (``--profile``)."""
    from torch.profiler import ProfilerActivity, profile

    from hpbandster_tpu_torch import FusedBOHB
    from hpbandster_tpu_torch.workloads.toys import hartmann6, hartmann6_space

    opt = FusedBOHB(configspace=hartmann6_space(seed=0), eval_fn=hartmann6,
                    min_budget=1, max_budget=81, eta=3, num_samples=64,
                    seed=1, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.run(n_iterations=10)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]

    def dev_us(e):
        return float(getattr(e, "self_device_time_total", 0.0) or
                     getattr(e, "self_cuda_time_total", 0.0))

    total_us = sum(dev_us(e) for e in events)
    top = sorted(events, key=dev_us, reverse=True)[:12]
    out = dict(wall_s=wall, device_busy_s=total_us / 1e6,
               device_idle_share=(1.0 - total_us / 1e6 / wall) if total_us else None,
               kernels=[dict(name=e.key[:80], count=int(e.count), device_ms=dev_us(e) / 1e3)
                        for e in top])
    print("profile " + json.dumps(out), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one sweep's device time by kernel")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from hpbandster_tpu_torch.ops import _build, cuda_kde

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # phase 1: build
    t0 = time.perf_counter()
    _build.load_library("kde_score")
    print(f"build kde_score: {time.perf_counter() - t0:.2f} s", flush=True)
    if _build.BUILD_LOG.get("kde_score"):
        print(_build.BUILD_LOG["kde_score"].strip(), flush=True)

    # phase 2: kernel against plain version at scale checks
    checks = check_kde_score(torch, dev)

    # phase 3: main path, counts reset just before and read just after
    cuda_kde.LAUNCHES["kde_score"] = 0
    cuda_kde.RECORD = []
    drive_main_path(torch, dev)
    launches = cuda_kde.LAUNCHES["kde_score"]
    recorded, cuda_kde.RECORD = cuda_kde.RECORD, None
    if launches < 1:
        raise AssertionError("the main path never launched kde_score")

    # phase 4: kernel against plain version on the main path's own inputs
    main_rec, main_err = check_main_path_launches(torch, recorded)

    if args.profile:
        profile_sweep(torch, dev)

    kernels = [dict(
        name="kde_score", route="cuda",
        source="hpbandster_tpu_torch/csrc/kde_score.cu",
        replaces="hpbandster_tpu/ops/pallas_kde.py:65",
        launches=launches,
        max_abs_err=max([main_err] + [c["max_abs_err"] for c in checks]),
        ms=main_rec["ms"], plain_ms=main_rec["plain_ms"],
        bound_ms=main_rec["bound_ms"], bound_by=main_rec["bound_by"],
        library_ms=None,
    )]
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
