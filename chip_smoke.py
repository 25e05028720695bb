#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``hpbandster_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card
    python3 chip_smoke.py --profile  # also profiles device time: a static
                                     # and a chunked sweep, and the moment
                                     # kernel's passes at its scale checks

Phases, each fatal on failure:

1. build every CUDA kernel of the main paths from ``hpbandster_tpu_torch/csrc``
   (``nvcc`` for ``sm_90a``, one compiler per source, all started together)
   and print the build times and ptxas reports;
2. hold each kernel against its plain PyTorch version on the card at scale
   checks: for the scorer, the main path's candidate count against a few
   hundred observations, the scale the TPU kernel was written for, and a
   mixed-type case with partly and fully masked observations; for the
   masked moments, 2^20 rows at d=6, 2^17 mixed rows at d=16 with 30%
   masked in, and an all-masked buffer;
3. drive the static main path, ``FusedBOHB.run()`` on Hartmann-6 and Branin
   at ``max_budget=81, eta=3, num_samples=64, n_iterations=10`` (two
   HyperBand rotations), with the launch counts reset just before and read
   just after, and every launch's inputs recorded; check runs per budget,
   finite losses, that the incumbent is strictly better than the median of
   seeded random searches given the same total budget, that model-based
   picks beat random picks (median stage-0 loss in the brackets that had a
   model), and that the kernels were launched;
4. drive the chunked main path, ``FusedBOHB.run(n_iterations=10,
   chunk_brackets=2)`` on Hartmann-6 at the same widths with
   ``HPB_PALLAS_KDE_FIT=1`` (the dynamic-count tier, whose KDE fit takes its
   bandwidths from the masked-moment kernel), counts reset and read around
   it; the same checks, both kernels launched, and the chunk rows and the
   synchronizing CUDA calls inside each chunk printed (reported, not gated);
5. resume on the card: the same chunked sweep cut after 4 brackets with a
   checkpoint, loaded into a fresh optimizer and run to 10, must equal the
   uninterrupted chunked run exactly (configs, losses, incumbent);
6. hold each kernel against its plain version on every input the main
   paths gave it, and time both at the largest of those launches;
7. print the kernels' JSON line, the card's name and power limit, and last
   the JSON result line.

There is no gate on the first bracket's stage 0: when the incumbent comes
from bracket 0 it cannot fail. The random-search and model-vs-random checks
carry the signal.

Errors are max absolute differences; times are medians of CUDA-event-timed
calls after warm-up.

It imports nothing of jax or the JAX package, exits non-zero without a CUDA
device, and starts no process that outlives it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

#: published peaks of one H100 SXM (dense): float32 outside the tensor
#: cores, and HBM3 bandwidth
H100_F32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12
#: special-function unit (exp, log) results per second: 16 per clock per SM
#: (Hopper architecture) x 132 SMs x the 1.98 GHz boost clock
H100_SFU_PER_S = 16 * 132 * 1.98e9
SCORE_ATOL = 1e-4
#: masked moments: counts exact, sums within this relative tolerance (the
#: kernel and the plain version add float32 in different orders)
MOMENTS_RTOL = 1e-4
MOMENTS_ATOL = 1e-5
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


def kde_moments_work(data, masks):
    """What the masked moments need on these inputs: bytes moved (the data
    and the masks read once, the [S, 3, d] output written once) and float32
    operations (per side, per row and dim: the masked value, its square
    and two additions; per side and row: the count's addition). No
    exponentials."""
    c, d = data.shape
    sides = masks.shape[0]
    bytes_moved = 4 * (c * d + sides * c + sides * 3 * d)
    return bytes_moved, sides * c * (4 * d + 1), 0


def hold_kde_moments(torch, label, data, masks, reps=20):
    """The masked-moment kernel against its plain version on one input:
    counts exact, sums within ``MOMENTS_RTOL`` (fatal otherwise), median
    times and the bound. Returns the record it prints."""
    from hpbandster_tpu_torch.ops import cuda_kde

    got = cuda_kde.masked_moments(data, masks)
    want = cuda_kde.masked_moments_reference(data, masks)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"kde_moments {label}: non-finite moments")
    if not torch.equal(got[:, 2], want[:, 2]):
        raise AssertionError(f"kde_moments {label}: counts differ")
    diff = (got - want).abs()
    if not bool((diff <= MOMENTS_ATOL + MOMENTS_RTOL * want.abs()).all()):
        raise AssertionError(
            f"kde_moments {label}: sums off by up to {float(diff.max())}")
    rel = diff / want.abs().clamp(min=1e-30)
    ms = _median_ms(lambda: cuda_kde.masked_moments(data, masks), torch, reps=reps)
    plain_ms = _median_ms(lambda: cuda_kde.masked_moments_reference(data, masks),
                          torch, reps=reps)
    b_ms, b_by = bound_ms(*kde_moments_work(data, masks))
    rec = dict(shape=label, C=int(data.shape[0]), d=int(data.shape[1]),
               sides=int(masks.shape[0]),
               live=[int(m.sum()) for m in masks], max_abs_err=float(diff.max()),
               max_rel_err=float(rel[want != 0].max()) if bool((want != 0).any()) else 0.0,
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print("kde_moments check " + json.dumps(rec), flush=True)
    return rec


#: the masked-moment scale checks: (label, seed, C, cards per dim, share of
#: rows masked in over both sides; 15% of it on the good side, 85% bad)
MOMENTS_CASES = [
    # the scale the TPU kernel was written for (pallas_kde.py:393)
    ("scale_2^20_d6", 200, 1 << 20, [0] * 6, 1.0),
    ("scale_2^17_d16_mixed_30pct", 201, 1 << 17, [0] * 10 + [3, 4, 5] + [4, 6, 8], 0.3),
    ("all_masked_2^17_d6", 202, 1 << 17, [0] * 6, 0.0),
]


def moments_inputs(torch, dev, seed, c, cards, live_frac):
    """A fit's buffer and its good and bad masks on the card, from a numpy
    seed: ``(data f32[C, d], masks f32[2, C])``."""
    rng = np.random.default_rng(seed)
    d = len(cards)
    x = rng.uniform(size=(c, d)).astype(np.float32)
    for j, k in enumerate(cards):
        if k:
            x[:, j] = rng.integers(k, size=c)
    good = (rng.uniform(size=c) < live_frac * 0.15).astype(np.float32)
    bad = (rng.uniform(size=c) < live_frac * 0.85).astype(np.float32)
    return (torch.from_numpy(x).to(dev),
            torch.from_numpy(np.stack([good, bad])).to(dev))


def check_kde_moments(torch, dev):
    """Phase 2: the masked-moment kernel against its plain version at scale
    checks beyond the main path's own launches. Returns one record per
    shape."""
    return [hold_kde_moments(torch, name, *moments_inputs(torch, dev, seed, c, cards, frac))
            for name, seed, c, cards, frac in MOMENTS_CASES]


def check_recorded_launches(torch, recorded, num_samples=64):
    """Phase 6: each kernel against its plain version on every input the
    main paths gave it (``(path, name, inputs)``), timed at each path's
    largest launch (most rows: the kernels' time follows the buffer, not
    the rows masked in; ties go to the most rows masked in). Returns, per
    kernel, (the record of its largest launch over all paths, max abs err
    over all its launches)."""
    def size(name, inputs):
        if name == "kde_score":
            cands, good, bad = inputs[:3]
            live = int((good.mask > 0).sum() + (bad.mask > 0).sum())
            return (cands.shape[0] * (good.data.shape[0] + bad.data.shape[0]),
                    cands.shape[0] * live)
        data, masks = inputs
        return (data.shape[0] * data.shape[1] * masks.shape[0], int(masks.sum()))

    out = {}
    for kernel in ("kde_score", "kde_moments"):
        mine = [(path, inputs) for path, name, inputs in recorded if name == kernel]
        largest = {}
        for i, (path, inputs) in enumerate(mine):
            if path not in largest or size(kernel, inputs) > size(kernel, mine[largest[path]][1]):
                largest[path] = i
        shapes, max_err, recs = [], 0.0, {}
        for i, (path, inputs) in enumerate(mine):
            reps = 20 if largest[path] == i else 3
            label = f"{path}_path_launch_{i}"
            if kernel == "kde_score":
                n = inputs[0].shape[0] // num_samples
                rec = hold_kde_score(torch, label, *inputs, n, reps=reps)
                shapes.append((path, rec["S"], int(inputs[1].data.shape[0]),
                               rec["n_good"], rec["n_bad"], rec["d"]))
            else:
                rec = hold_kde_moments(torch, label, *inputs, reps=reps)
                shapes.append((path, rec["C"], rec["d"], rec["live"]))
            max_err = max(max_err, rec["max_abs_err"])
            recs[i] = dict(rec, size=list(size(kernel, inputs)))
        print(f"main path {kernel} launches: " + json.dumps(shapes), flush=True)
        per_path = {path: recs[i] for path, i in largest.items()}
        print(f"main path {kernel} largest launch per path: " + json.dumps(per_path),
              flush=True)
        out[kernel] = (max(per_path.values(), key=lambda r: r["size"]), max_err)
    return out


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


def check_sweep(torch, dev, name, opt, res, fn, max_budget, n_iterations):
    """The correctness checks of one sweep: runs per budget equal the
    HyperBand plan, all losses finite, the incumbent strictly below the
    median best of equal-budget random searches, model-based picks better
    than random picks. Returns the numbers it checked."""
    from hpbandster_tpu_torch.ops.bracket import hyperband_bracket

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
    inc_loss = res.get_runs_by_id(res.get_incumbent_id())[-1].loss
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
    return dict(evaluations=int(len(losses)), incumbent_loss=inc_loss,
                random_search_median_best=rs_best,
                stage0_median_model=model_med, stage0_median_random=random_med,
                model_based_brackets=model_brackets)


def drive_static_path(torch, dev, max_budget=81.0, n_iterations=10, num_samples=64):
    """Phase 3: the static tier's FusedBOHB.run() on Hartmann-6 and Branin.
    Returns per-run records; raises on a failed check."""
    from hpbandster_tpu_torch import FusedBOHB
    from hpbandster_tpu_torch.ops import cuda_kde
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
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = cuda_kde.LAUNCHES["kde_score"] - before
        rec = dict(objective=name, wall_s=wall,
                   execute_fetch_s=opt.run_stats[-1]["execute_fetch_s"],
                   **check_sweep(torch, dev, name, opt, res, fn, max_budget,
                                 n_iterations),
                   kde_score_launches=launches)
        if launches < 1 or launches > n_iterations:
            raise AssertionError(f"{name}: kde_score launched {launches} times")
        print("static path " + json.dumps(rec), flush=True)
        runs.append(rec)
    return runs


@contextlib.contextmanager
def moments_fit_flag():
    """``HPB_PALLAS_KDE_FIT=1`` for the chunked runs only."""
    old = os.environ.get("HPB_PALLAS_KDE_FIT")
    os.environ["HPB_PALLAS_KDE_FIT"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["HPB_PALLAS_KDE_FIT"]
        else:
            os.environ["HPB_PALLAS_KDE_FIT"] = old


@contextlib.contextmanager
def sync_counter(torch):
    """Counts the synchronizing CUDA calls inside each chunk's device work
    (``torch.cuda.set_sync_debug_mode("warn")`` around every sweep call the
    optimizer makes; the fetch of a chunk's outputs comes after the call
    and is not counted). Yields ``(per-chunk counts, counts by the source
    line that made the call)``."""
    from hpbandster_tpu_torch.optimizers import fused_bohb

    per_chunk, by_site = [], {}
    build = fused_bohb.make_fused_sweep_fn

    def counting_build(*args, **kwargs):
        sweep = build(*args, **kwargs)

        def counted(*a, **k):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = sweep(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            syncs = [w for w in caught if "synchroniz" in str(w.message)]
            for w in syncs:
                site = f"{Path(w.filename).name}:{w.lineno}"
                by_site[site] = by_site.get(site, 0) + 1
            per_chunk.append(len(syncs))
            return out

        return counted

    fused_bohb.make_fused_sweep_fn = counting_build
    try:
        yield per_chunk, by_site
    finally:
        fused_bohb.make_fused_sweep_fn = build


def chunked_optimizer(dev, max_budget=81.0, num_samples=64):
    from hpbandster_tpu_torch import FusedBOHB
    from hpbandster_tpu_torch.workloads.toys import hartmann6, hartmann6_space

    return FusedBOHB(configspace=hartmann6_space(seed=0), eval_fn=hartmann6,
                     min_budget=1, max_budget=max_budget, eta=3,
                     num_samples=num_samples, seed=0, device=dev)


def drive_chunked_path(torch, dev, max_budget=81.0, n_iterations=10):
    """Phase 4: the chunked FusedBOHB.run() on Hartmann-6, dynamic-count
    tier with the moment-kernel fit. Returns (record, result)."""
    from hpbandster_tpu_torch.ops import cuda_kde
    from hpbandster_tpu_torch.workloads.toys import hartmann6

    with moments_fit_flag(), sync_counter(torch) as (syncs, sync_sites):
        t0 = time.perf_counter()
        opt = chunked_optimizer(dev, max_budget)
        res = opt.run(n_iterations=n_iterations, chunk_brackets=2)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    for row, n_sync in zip(opt.run_stats, syncs):
        print("chunk " + json.dumps(dict(row, syncs_inside_chunk=n_sync)), flush=True)
    rec = dict(objective="hartmann6", chunk_brackets=2, wall_s=wall,
               execute_fetch_s=sum(r["execute_fetch_s"] for r in opt.run_stats),
               **check_sweep(torch, dev, "hartmann6 chunked", opt, res, hartmann6,
                             max_budget, n_iterations),
               kde_score_launches=cuda_kde.LAUNCHES["kde_score"],
               kde_moments_launches=cuda_kde.LAUNCHES["kde_moments"],
               syncs_inside_chunks=syncs,
               sync_sites=dict(sorted(sync_sites.items(), key=lambda kv: -kv[1])))
    if not all(s["dynamic_counts"] for s in opt.run_stats):
        raise AssertionError("the chunked run did not take the dynamic-count tier")
    print("chunked path " + json.dumps(rec), flush=True)
    return rec, res


def check_resume(torch, dev, uninterrupted, n_iterations=10):
    """Phase 5: cut the chunked sweep after 4 brackets with a checkpoint,
    resume in a fresh optimizer, run to the end, and require the result of
    the uninterrupted run exactly."""
    ckpt_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = str(ckpt_dir / "chunked.ckpt")
    with moments_fit_flag():
        chunked_optimizer(dev).run(n_iterations=4, chunk_brackets=2,
                                   checkpoint_path=path)
        resumed = chunked_optimizer(dev)
        resumed.load_checkpoint(path)
        res = resumed.run(n_iterations=n_iterations, chunk_brackets=2)
    os.unlink(path)

    def runs(r):
        return sorted((x.config_id, x.budget, x.loss) for x in r.get_all_runs())

    if runs(res) != runs(uninterrupted):
        raise AssertionError("resumed chunked run differs from the uninterrupted run")
    if res.get_id2config_mapping() != uninterrupted.get_id2config_mapping():
        raise AssertionError("resumed chunked run sampled other configurations")
    if res.get_incumbent_id() != uninterrupted.get_incumbent_id():
        raise AssertionError("resumed chunked run has another incumbent")
    rec = dict(brackets_before_cut=4, evaluations=len(runs(res)),
               incumbent=list(res.get_incumbent_id()), equal=True)
    print("resume " + json.dumps(rec), flush=True)
    return rec


def _device_us(event):
    return float(getattr(event, "self_device_time_total", 0.0) or
                 getattr(event, "self_cuda_time_total", 0.0))


def profile_sweeps(torch, dev):
    """Device time by kernel and the device idle share over one static and
    one chunked Hartmann-6 sweep (``--profile``)."""
    from torch.profiler import ProfilerActivity, profile

    for path in ("static", "chunked"):
        opt = chunked_optimizer(dev)
        with contextlib.ExitStack() as stack:
            if path == "chunked":
                stack.enter_context(moments_fit_flag())
            prof = stack.enter_context(
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            t0 = time.perf_counter()
            opt.run(n_iterations=10, chunk_brackets=2 if path == "chunked" else None)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        total_us = sum(_device_us(e) for e in events)
        top = sorted(events, key=_device_us, reverse=True)[:12]
        out = dict(path=path, wall_s=wall, device_busy_s=total_us / 1e6,
                   device_idle_share=(1.0 - total_us / 1e6 / wall) if total_us else None,
                   kernels=[dict(name=e.key[:80], count=int(e.count),
                                 device_ms=_device_us(e) / 1e3) for e in top])
        print("profile " + json.dumps(out), flush=True)


def profile_moments_device_time(torch, dev, reps=20):
    """Device time per launch of each of the masked-moment kernel's two
    passes at the scale checks (``--profile``; the CUDA events of phase 2
    also hold the wrapper's host work). Measured twice: back to back, where
    inputs under the card's 50 MB L2 stay cached, and with a 128 MB buffer
    rewritten before every launch, so the inputs come from HBM as the bound
    assumes."""
    from torch.profiler import ProfilerActivity, profile

    from hpbandster_tpu_torch.ops import cuda_kde

    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    for name, seed, c, cards, frac in MOMENTS_CASES:
        data, masks = moments_inputs(torch, dev, seed, c, cards, frac)
        cuda_kde.masked_moments(data, masks)
        torch.cuda.synchronize(dev)
        rec = dict(shape=name)
        for l2 in ("warm_l2", "cold_l2"):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    if l2 == "cold_l2":
                        flush.zero_()
                    cuda_kde.masked_moments(data, masks)
                torch.cuda.synchronize(dev)
            per_launch = {e.key[:40]: _device_us(e) / 1e3 / reps
                          for e in prof.key_averages()
                          if e.device_type.name == "CUDA" and "moments" in e.key}
            rec[l2] = dict(per_launch_ms=per_launch, total_ms=sum(per_launch.values()))
        rec["bound_ms"] = bound_ms(*kde_moments_work(data, masks))[0]
        print("kde_moments device time " + json.dumps(rec), flush=True)


def build_kernels():
    """Phase 1: one nvcc per kernel source, all started together."""
    from hpbandster_tpu_torch.ops import _build

    def build(name):
        t0 = time.perf_counter()
        _build.load_library(name)
        return name, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        for name, secs in pool.map(build, KERNELS):
            print(f"build {name}: {secs:.2f} s", flush=True)
            if _build.BUILD_LOG.get(name):
                print(_build.BUILD_LOG[name].strip(), flush=True)


#: kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "kde_score": ("hpbandster_tpu_torch/csrc/kde_score.cu",
                  "hpbandster_tpu/ops/pallas_kde.py:65"),
    "kde_moments": ("hpbandster_tpu_torch/csrc/kde_moments.cu",
                    "hpbandster_tpu/ops/pallas_kde.py:326"),
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile device time by kernel (sweeps, moment kernel)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from hpbandster_tpu_torch.ops import cuda_kde

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    build_kernels()

    # phase 2: kernels against plain versions at scale checks
    checks = {"kde_score": check_kde_score(torch, dev),
              "kde_moments": check_kde_moments(torch, dev)}

    # phases 3 and 4: each main path with the counts reset just before and
    # read just after, every launch's inputs recorded
    launches, recorded = {}, []
    for path, drive in (("static", drive_static_path), ("chunked", drive_chunked_path)):
        for name in cuda_kde.LAUNCHES:
            cuda_kde.LAUNCHES[name] = 0
        cuda_kde.RECORD = []
        out = drive(torch, dev)
        launches[path] = dict(cuda_kde.LAUNCHES)
        recorded += [(path, name, inputs) for name, inputs in cuda_kde.RECORD]
        cuda_kde.RECORD = None
        if path == "chunked":
            chunked_result = out[1]
    print("main path launches " + json.dumps(launches), flush=True)
    if launches["static"]["kde_score"] < 1:
        raise AssertionError("the static path never launched kde_score")
    for name in KERNELS:
        if launches["chunked"][name] < 1:
            raise AssertionError(f"the chunked path never launched {name}")

    # phase 5: resume on the card equals the uninterrupted chunked run
    check_resume(torch, dev, chunked_result)

    # phase 6: kernels against plain versions on the main paths' own inputs
    held = check_recorded_launches(torch, recorded)

    if args.profile:
        profile_sweeps(torch, dev)
        profile_moments_device_time(torch, dev)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        main_rec, main_err = held[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(launches[p][name] for p in launches),
            launches_by_path={p: launches[p][name] for p in launches},
            max_abs_err=max([main_err] + [c["max_abs_err"] for c in checks[name]]),
            ms=main_rec["ms"], plain_ms=main_rec["plain_ms"],
            bound_ms=main_rec["bound_ms"], bound_by=main_rec["bound_by"],
            library_ms=None,
        ))
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
