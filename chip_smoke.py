#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``hpbandster_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card
    python3 chip_smoke.py --profile  # also profiles device time: static,
                                     # chunked and resident Hartmann-6 and
                                     # conditional sweeps, chunked_long
                                     # against its sequential-replay twin,
                                     # the moment kernel at its scale
                                     # checks, and each training
                                     # workload's sweep

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
   then, each with its counts reset and read the same way: the conditional
   path, the reference's conditional space (a categorical and an ordinal
   parent, one forbidden clause) with Branin plus its children as the
   objective, static and chunked, gated as above plus every evaluated
   configuration round-tripping through the host codec, respecting the
   activity pattern and not forbidden; ``FusedH2BO`` on Hartmann-6;
   ``FusedHyperBand`` and ``FusedRandomSearch`` on Branin (runs per budget
   against their plans, no kernel launch); every recorded launch's inputs
   must be finite, and the conditional paths must have scorer launches on
   mixed vartypes and moments launches with discrete cards;
   then the resident tier, each path with its counts reset and read the
   same way and ``HPB_PALLAS_KDE_FIT=1``: ``run(resident=True,
   device_metrics=True)`` on Hartmann-6 at 10 brackets (two rounds of the
   5-bracket rotation, each one replay of a captured CUDA graph), at 12
   (two rounds and a tail of two eager brackets) and at 50 (ten rounds),
   and on the conditional space at 10; ``run_incumbent(n_iterations=10,
   device_metrics=True)`` on Hartmann-6. Each resident run passes the
   sweep gates above, and its decoded device telemetry must agree with a
   recount from its ``Result``: evaluations and promotions per rung as
   planned, no crash, each histogram the binning of that rung's losses,
   each bracket's best final loss the minimum of its final rung, rung
   stamps increasing in execution order; then the sweep cache and the
   chunk pipeline, each path with its counts reset and read the same way
   and ``HPB_PALLAS_KDE_FIT=1`` (the sweep cache is emptied before every
   path, so each captures its own graphs): ``chunked_long``
   (``run(n_iterations=50, chunk_brackets=5)``: every chunk a captured
   program, captures equal to the distinct chunk keys reckoned on the host
   from the plans and the pow2 capacities, the other chunks cache hits
   with a ``build_compile_s`` of 0.0, ``replay_overlap_s`` on every row
   but the first, the sweep gates; each chunk's times printed),
   ``sweep_cache`` (the resident sweep at 10 brackets by two fresh
   optimizers of one seed, the second a hit equal to the first with equal
   telemetry; a third seed on the hit equal to its run on a graph captured
   afresh; ``run_incumbent`` twice, a hit with an equal payload) and
   ``runtime_ledger`` (chunked_long's ``sweep.transfer_bytes.*`` and
   ``sweep.host_syncs`` gauges equal to its warm uploads and the bytes its
   plans fetch; one ``DeviceSampler`` census; a chunked run with
   ``profile_dir`` from a cold cache, its graphs captured under the
   profiler, and again on the cached graphs, each trace naming
   ``kde_score``; the roofline's rows against the capture ledger and the
   card's peaks); then the training workloads at
   the reference's full widths (``bench.py``'s settings), each sweep with
   its counts reset and read the same way: the CNN (``CNNConfig()``,
   budgets 3..81) static for 5 brackets, whose incumbent must reach
   ``CNN_MIN_VAL_ACCURACY``, then one rotation unrolled and resident
   (``HPB_PALLAS_KDE_FIT=1``, device metrics, a telemetry recount); the
   MLP ensemble (a ``StatefulEval``, budgets 1..81) unrolled and resident
   for 10 brackets; the teacher (1..27, 4 brackets), ResNet-18 (3..27, 2)
   and the transformer (3..81, 2), static; each gated on runs per budget,
   error rates in [0, 1], crashes ranked behind every real loss, a finite
   incumbent, and printing wall and execute+fetch seconds, peak memory and
   training FLOP/s against the card's bfloat16 peak; then the Master-driven
   tier (``BatchedExecutor(VmapBackend(...))``, ``bench.py:741``'s
   setting), each path with its counts reset and read the same way:
   ``BOHB`` on Hartmann-6 with ``parallel_brackets=3`` (the sweep gates),
   the same at ``parallel_brackets=1`` fused and stage-batched (the same
   runs, losses within ``FUSION_RTOL``; fusion counts and cache hits), the
   in-trace refit with ``HPB_PALLAS_KDE_FIT=1`` and ``HPB_USE_PALLAS=1``
   (both kernels), ``HyperBand`` and ``RandomSearch`` on Branin (no
   launch), ``H2BO`` on Hartmann-6, a Master checkpoint after 4 brackets
   resumed to 10 (equal to the uninterrupted fused run), and the teacher at
   full width (``bench.py:1054``: runs per budget, crash ranking, the
   incumbent's accuracy reported against ``TARGET_VAL_ACCURACY``); each
   prints wall seconds, finished runs per second and host syncs per
   bracket (the batched paths run on the bucket graphs, the default); then
   the bucketed brackets and the serving tier, each path with its counts
   reset and read the same way: ``batched_bohb_bucketed`` (``BOHB`` on
   Hartmann-6 at the toy setting on its own objective closure: the sweep
   gates, one CUDA graph captured per bucket, every fusable bracket on its
   bucket's graph), ``serve_megabatch`` and ``serve_continuous`` (4 ``BOHB``
   tenants, seeds 0-3, Hartmann-6 at the toy setting, in threads started
   together, through one ``ServePool(pack_window_s=0.05)`` whose scheduler
   quantum covers one bracket, megabatched or with ``continuous=True,
   lane_count=8``: each tenant's runs per budget and its incumbent below
   the random searches' median, the background precompile overlapping the
   tenants' submissions, at least one packed bracket, captures at most the
   buckets times {solo, packed} or the bucket families, each tenant's lane
   incumbents the best final loss of its bucketed brackets) and
   ``serve_teacher`` (3 teacher tenants at full width, ``bench.py:1054``'s
   setting, megabatched at ``pack_width=4``: runs per budget, crash
   ranking, a finite incumbent, its accuracy reported); each prints wall,
   runs per second in total and per tenant, packed and solo brackets,
   every graph's capture, instantiate and replay times, host syncs per
   bracket and peak memory; then the promotion rules and the journal, each
   path with its counts reset and read the same way and an obs journal
   attached (``obs.configure(journal_path=...)``): ``batched_bohb_asha``
   (``BOHB(promotion_rule="asha")`` at the ``batched_bohb`` setting: at
   every rung the union of the journaled promotions contains the sync
   rule's top ``floor(n / eta)`` of the rung's candidates, stage 0 runs as
   planned and later rungs at least as planned; one scorer launch per
   model-based pick, ASHA samples one config at a time),
   ``batched_bohb_pareto`` (every record's mask equals the Pareto mask on
   the card and on the host over its losses and costs, a rung with at
   least 8 runs at its budget ranked on the run-time histogram's p50; with
   ``cost_fn = 1`` the run equals ``batched_bohb`` bit for bit),
   ``batched_bohb_lc_earlystop`` (in-trace refit, both kernels: every
   top-k config it terminated had a prediction above the cut; with
   ``margin = inf`` the run equals ``batched_bohb_in_trace`` bit for bit)
   and ``fused_journal`` (the static and resident ``FusedBOHB.run()`` and
   ``run_incumbent`` journaled, each equal to its earlier run with no sink,
   one ``sweep_chunk`` per chunk, the ``device_telemetry`` record equal to
   the run's ``last_device_telemetry``, a ``sweep_incumbent`` record); on
   every journal ``replay_records`` under each rule is byte-identical
   across two calls and the incumbent's ``config_lineage`` resolves. The
   launch counts of every path are gated
   (``MAIN_PATH_LAUNCHES``; a graph's launches count once per replay; a
   Master-driven path's count is derived from its ``Result``: one scorer
   launch, of at least ``BATCHED_MIN_S`` candidates, per sampling wave with
   a model-based pick (under ASHA one of 64 per model-based pick), and with
   the in-trace moments fit one moments launch beside it);
5. resume on the card: each chunked sweep (Hartmann-6 and conditional) cut
   after 4 brackets with a checkpoint, loaded into a fresh optimizer and run
   to 10, must equal its uninterrupted run exactly (configs, losses,
   incumbent); ``chunked_long`` must equal, bit for bit, its run with a
   checkpoint (replay in turn), its run with the sweep cache cleared
   before each chunk and its run with eager chunks; two threads running
   seeds 0 and 1 at once (resident, then chunks of 2) on the same cached
   sweeps must hit the cache and equal each seed's run alone bit for bit;
   each resident run must equal, bit for bit, a same-seed
   unrolled dynamic-tier run of the same length (every observation vector
   and loss in order, model flags, configurations, runs), and
   ``run_incumbent`` the best final-stage row of the same-seed resident
   run (vector, loss, bracket, per-bracket bests, crashes last) with the
   same decoded telemetry; a ``StatefulEval`` (linear-regression lanes
   continued across rungs) on the resident tier must equal its unrolled
   run bit for bit; the profiler's count of the two kernels over a
   resident sweep must equal the wrapper counts; then the resident tier's
   times: capture, instantiate and per-replay milliseconds, an eager
   round of the unrolled sweep, and wall, device-busy time and idle share
   of the 50-bracket resident run against the unrolled dynamic run; then
   the host and event time of the conditional path's new device work
   (rejection resampling, activity mask, imputation), which must not
   synchronize; the CNN's and the ensemble's resident runs must equal
   their unrolled runs bit for bit (deterministic cuDNN algorithms), the
   CNN's losses on the card those on the CPU from the same data and
   weights (``CNN_CPU_RTOL``), and the ensemble's promoted lanes the
   uninterrupted trainer's (``ENSEMBLE_RTOL``; bit for bit reported);
   the bucketed run must equal the same run with
   ``bucket_brackets=False`` bit for bit, and each serving tenant its own
   seed run alone in a ``ServePool(pack_window_s=0.0)`` on the same
   objective; then ``batched_bohb``'s wall with no sink and with a journal,
   in turns, and the records each journal holds (``obs overhead``, no
   claim); then the cached paths' runs back to back on one sweep cache
   that nothing empties (``cache_memory``: entries, allocated and reserved
   bytes after each, the peaks, the bytes the full cache pins);
6. hold each kernel against its plain version on every input the main
   paths gave it (a launch captured into a CUDA graph holds its latest
   replay's inputs), with the arguments the path passed (for the masked
   moments also the bandwidths the kernel computes, against the plain
   composition), time both at each path's largest launch, and take the
   kernel's device time there from ``torch.profiler`` (the fit's call must
   run the moments kernel once per call and nothing else);
7. time the launch floor (an empty kernel through the same ctypes route),
   print the ``workloads`` JSON line (per workload path; device busy time
   and idle share with ``--profile``, which sweeps each path again under
   the profiler), the kernels' JSON line (event-timed ``ms``, profiled
   ``device_ms``, ``host_ms``, ``launch_floor_ms``, bound, plain and
   launches), the card's name and power limit, and last the JSON result
   line.

There is no gate on the first bracket's stage 0: when the incumbent comes
from bracket 0 it cannot fail. The random-search and model-vs-random checks
carry the signal.

Errors are max absolute differences. ``ms`` is the median of CUDA-event-
timed calls after warm-up (the events bracket the wrapper's host work, so a
small launch reads as its host dispatch); ``device_ms`` is the profiler's
device time per launch; ``host_ms`` the mean host time per call with the
launches queued back to back.

It imports nothing of jax or the JAX package, exits non-zero without a CUDA
device, and starts no process that outlives it.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
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
#: the fit's bandwidth floor (FusedBOHB's default min_bandwidth)
MIN_BANDWIDTH = 1e-3
#: fused bandwidths against the plain composition (plain moments, then the
#: plain epilogue): the one-pass variance s2/n - mean^2 magnifies the sums'
#: relative difference (float32 adds in another order, ~1e-7-1e-6) by up to
#: mean^2/var, so bandwidths agree to rtol 1e-3 while mean^2/var <= 1e3 and
#: the tolerance widens in proportion beyond that
BW_RTOL = 1e-3
BW_MAGNIFICATION = 1e3
#: fused bandwidths against the plain epilogue over the kernel's own
#: moments: the same float32 steps, so a last-bit difference of pow at most
BW_EPILOGUE_RTOL = 1e-6
#: kernel launches of the main paths: two static sweeps with 9 model
#: brackets each; one fit and one scoring per bracket of the chunked sweep;
#: on the conditional space one fit of two moment launches (the split sides
#: are imputed apart) per chunked bracket; H2BO as BOHB; HyperBand and
#: random search no model
MAIN_PATH_LAUNCHES = {"static": {"kde_score": 18, "kde_moments": 0},
                      "chunked": {"kde_score": 10, "kde_moments": 10},
                      "conditional_static": {"kde_score": 9, "kde_moments": 0},
                      "conditional_chunked": {"kde_score": 10, "kde_moments": 20},
                      "h2bo": {"kde_score": 9, "kde_moments": 0},
                      "hyperband": {"kde_score": 0, "kde_moments": 0},
                      "random_search": {"kde_score": 0, "kde_moments": 0},
                      # the resident tier fits and scores every bracket, as
                      # the chunked tier does: 5 + 5 captured per round
                      # (conditional 5 + 10), times the replays, plus the tail
                      "resident": {"kde_score": 10, "kde_moments": 10},
                      "resident_tail": {"kde_score": 12, "kde_moments": 12},
                      "resident_long": {"kde_score": 50, "kde_moments": 50},
                      "conditional_resident": {"kde_score": 10, "kde_moments": 20},
                      "incumbent": {"kde_score": 10, "kde_moments": 10},
                      # the sweep cache and the chunk pipeline: 50 chunked
                      # brackets; four resident runs of 10 and two
                      # run_incumbent(10); two chunked runs of 10 (one
                      # profiled)
                      "chunked_long": {"kde_score": 50, "kde_moments": 50},
                      "sweep_cache": {"kde_score": 60, "kde_moments": 60},
                      "runtime_ledger": {"kde_score": 20, "kde_moments": 20},
                      # the training workloads: static sweeps score every
                      # bracket after the first; the dynamic tiers (the CNN
                      # with the moment-kernel fit, the ensemble without it)
                      # fit and score every bracket
                      "cnn": {"kde_score": 4, "kde_moments": 0},
                      "cnn_unrolled": {"kde_score": 4, "kde_moments": 4},
                      "cnn_resident": {"kde_score": 4, "kde_moments": 4},
                      "ensemble_unrolled": {"kde_score": 10, "kde_moments": 0},
                      "ensemble_resident": {"kde_score": 10, "kde_moments": 0},
                      "teacher": {"kde_score": 3, "kde_moments": 0},
                      "resnet": {"kde_score": 1, "kde_moments": 0},
                      "transformer": {"kde_score": 1, "kde_moments": 0}}
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


def _host_ms(fn, torch, reps=200, warmup=5):
    """Mean host time of one ``fn()`` call in milliseconds: the wrapper's
    checks, conversions and launch, without waiting for the device (the
    launches queue up behind each other; one synchronize at the end)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


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
    recs = []
    for i, (name, n, kw) in enumerate(cases):
        inputs = _score_inputs(torch, dev, 100 + i, **kw)
        rec = hold_kde_score(torch, name, *inputs, n)
        rec.update(launch_device_time(torch, "kde_score", inputs))
        print(f"kde_score {name} device and host time " + json.dumps(
            dict(device_ms=rec["device_ms"], host_ms=rec["host_ms"])), flush=True)
        recs.append(rec)
    return recs


def kde_moments_work(data, masks):
    """What the fit's moments and bandwidths need on these inputs: bytes
    moved (the data, the masks and the cards read once, the [S, 3, d]
    moments and the [S, d] bandwidths written once) and float32 operations
    (per side, per row and dim: the masked value, its square and two
    additions; per side and row: the count's addition; the bandwidths' few
    per (side, dim) are not counted). No exponentials."""
    c, d = data.shape
    sides = masks.shape[0]
    bytes_moved = 4 * (c * d + sides * c + d + sides * 3 * d + sides * d)
    return bytes_moved, sides * c * (4 * d + 1), 0


def _fit_cards(torch, data, cards):
    """The fit's cards as a float32 tensor on the data's device (None: all
    continuous, as a plain-moments launch treats them)."""
    d = data.shape[1]
    return torch.as_tensor(np.zeros(d) if cards is None else cards,
                           dtype=torch.float32, device=data.device)


def hold_fused_bandwidths(torch, label, data, masks, mom, want, cards, min_bw):
    """The kernel's bandwidths (``moment_bandwidths`` on the card) against
    the plain epilogue over the kernel's own moments ``mom``
    (``BW_EPILOGUE_RTOL``) and against the plain composition over the plain
    moments ``want`` (``BW_RTOL``, widened by mean^2/var beyond
    ``BW_MAGNIFICATION``). Fatal outside either. Returns the errors."""
    from hpbandster_tpu_torch.ops import cuda_kde

    fused = cuda_kde.moment_bandwidths(data, masks, cards, min_bw)
    epilogue = cuda_kde.bandwidths_from_moments(mom, cards, min_bw)
    plain = cuda_kde.bandwidths_from_moments(want, cards, min_bw)
    if not bool(torch.isfinite(fused).all()):
        raise AssertionError(f"kde_moments {label}: non-finite bandwidths")
    epi_rel = float(((fused - epilogue).abs() / epilogue.abs()).max())
    if not epi_rel <= BW_EPILOGUE_RTOL:
        raise AssertionError(
            f"kde_moments {label}: fused bandwidths off the epilogue by {epi_rel}")
    n = want[:, 2].clamp(min=1.0)
    mean = want[:, 0] / n
    var = (want[:, 1] / n - mean * mean).clamp(min=1e-30)
    magnification = (mean * mean / var).double()
    allowed = BW_RTOL * torch.clamp(magnification / BW_MAGNIFICATION, min=1.0)
    rel = ((fused - plain).abs() / plain.abs()).double()
    if not bool((rel <= allowed).all()):
        raise AssertionError(
            f"kde_moments {label}: fused bandwidths off the plain composition "
            f"by {float(rel.max())} (allowed {allowed.tolist()})")
    return dict(bw_rel_err=float(rel.max()), bw_epilogue_rel_err=epi_rel,
                bw_widened=int((magnification > BW_MAGNIFICATION).sum()))


def hold_kde_moments(torch, label, data, masks, cards=None, min_bw=MIN_BANDWIDTH,
                     reps=20):
    """The masked-moment kernel against its plain version on one fit's
    arguments: counts exact, sums within ``MOMENTS_RTOL``, the bandwidths as
    :func:`hold_fused_bandwidths` says (fatal otherwise), median times of
    the fit's call (``moment_bandwidths``) and of its plain composition, and
    the bound. Returns the record it prints."""
    from hpbandster_tpu_torch.ops import cuda_kde

    cards = _fit_cards(torch, data, cards)
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
    bw = hold_fused_bandwidths(torch, label, data, masks, got, want, cards, min_bw)
    ms = _median_ms(lambda: cuda_kde.moment_bandwidths(data, masks, cards, min_bw),
                    torch, reps=reps)
    plain_ms = _median_ms(lambda: cuda_kde.bandwidths_from_moments(
        cuda_kde.masked_moments_reference(data, masks), cards, min_bw), torch, reps=reps)
    b_ms, b_by = bound_ms(*kde_moments_work(data, masks))
    rec = dict(shape=label, C=int(data.shape[0]), d=int(data.shape[1]),
               sides=int(masks.shape[0]),
               live=[int(m.sum()) for m in masks], max_abs_err=float(diff.max()),
               max_rel_err=float(rel[want != 0].max()) if bool((want != 0).any()) else 0.0,
               **bw, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
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
    recs = []
    for name, seed, c, cards, frac in MOMENTS_CASES:
        inputs = moments_inputs(torch, dev, seed, c, cards, frac) + (
            cards, MIN_BANDWIDTH)
        rec = hold_kde_moments(torch, name, *inputs)
        rec.update(launch_device_time(torch, "kde_moments", inputs))
        print(f"kde_moments {name} device (warm L2) and host time " + json.dumps(
            dict(device_ms=rec["device_ms"], host_ms=rec["host_ms"])), flush=True)
        recs.append(rec)
    return recs


def check_recorded_launches(torch, recorded, num_samples=64):
    """Phase 6: each kernel against its plain version on every input the
    main paths gave it (``(path, name, inputs)``), timed (events and
    profiler) at each path's largest launch (most buffer rows; ties go to
    the most rows masked in). Returns, per kernel, (the record of each
    path's largest launch, max abs err over all its launches)."""
    def size(name, inputs):
        if name == "kde_score":
            cands, good, bad = inputs[:3]
            live = int((good.mask > 0).sum() + (bad.mask > 0).sum())
            return (cands.shape[0] * (good.data.shape[0] + bad.data.shape[0]),
                    cands.shape[0] * live)
        data, masks = inputs[:2]
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
            is_largest = largest[path] == i
            reps = 20 if is_largest else 3
            label = f"{path}_path_launch_{i}"
            if kernel == "kde_score":
                n = inputs[0].shape[0] // num_samples
                rec = hold_kde_score(torch, label, *inputs, n, reps=reps)
                shapes.append((path, rec["S"], int(inputs[1].data.shape[0]),
                               rec["n_good"], rec["n_bad"], rec["d"]))
            else:
                rec = hold_kde_moments(torch, label, *inputs, reps=reps)
                shapes.append((path, rec["C"], rec["d"], rec["live"]))
            if is_largest:
                rec.update(launch_device_time(torch, kernel, inputs))
                print(f"{kernel} {label} device time " + json.dumps(
                    {k: rec[k] for k in rec if k.startswith("device")}), flush=True)
            max_err = max(max_err, rec["max_abs_err"])
            recs[i] = dict(rec, size=list(size(kernel, inputs)))
        print(f"main path {kernel} launches: " + json.dumps(shapes), flush=True)
        per_path = {path: recs[i] for path, i in largest.items()}
        print(f"main path {kernel} largest launch per path: " + json.dumps(per_path),
              flush=True)
        out[kernel] = (per_path, max_err)
    return out


def profiled_device_ms(torch, fn, reps=20):
    """Device time of ``fn`` by kernel name: ``torch.profiler`` with CUDA
    activity only over ``reps`` calls after one warm-up call. Returns
    ``{kernel name: (ms per launch, launches per call)}``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the profiler now and then catches no device event in a window; such a
    # window is measured again, up to twice
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        if events:
            break
    # per launch over the launches the profiler caught (it may miss one)
    return {e.key[:80]: (_device_us(e) / 1e3 / max(e.count, 1), e.count / reps)
            for e in events}


def launch_device_time(torch, kernel, inputs, reps=20):
    """Device time per launch of ``kernel`` on one input's arguments, from
    the profiler, and the wrapper's host time per call. For ``kde_moments``
    the call is the fit's ``moment_bandwidths``, which must run one moments
    kernel per call and nothing else (fatal otherwise)."""
    from hpbandster_tpu_torch.ops import cuda_kde

    if kernel == "kde_score":
        call = lambda: cuda_kde.score_candidates(*inputs)  # noqa: E731
        by_name = profiled_device_ms(torch, call, reps)
        return dict(device_ms=sum(ms for k, (ms, _) in by_name.items()
                                  if "kde_score_kernel" in k),
                    host_ms=_host_ms(call, torch))
    data, masks, cards, min_bw = inputs
    cards = _fit_cards(torch, data, cards)
    call = lambda: cuda_kde.moment_bandwidths(data, masks, cards, min_bw)  # noqa: E731
    by_name = profiled_device_ms(torch, call, reps)
    # the profiler can miss a launch at the start of its window, so "one
    # per call" reads as: nothing but the moments kernel, at most once per
    # call
    if list(by_name) == [] or any("moments_kernel" not in k or n > 1
                                  for k, (_, n) in by_name.items()):
        raise AssertionError(
            "moment_bandwidths ran other device work than one moments kernel "
            "per call: " + json.dumps(by_name))
    return dict(device_ms=sum(ms for ms, _ in by_name.values()),
                host_ms=_host_ms(call, torch),
                device_kernels_per_call={k[:40]: n for k, (_, n) in by_name.items()})


def launch_floor(torch, dev, reps=20):
    """The least a launch costs on this card: the scorer library's empty
    kernel through the same ctypes route, event-timed, profiled and its
    host time per call."""
    from hpbandster_tpu_torch.ops import cuda_kde

    call = lambda: cuda_kde.noop_launch(dev)  # noqa: E731
    ms = _median_ms(call, torch, reps=reps)
    by_name = profiled_device_ms(torch, call, reps)
    rec = dict(launch_floor_ms=ms,
               launch_floor_device_ms=sum(v for v, _ in by_name.values()),
               launch_floor_host_ms=_host_ms(call, torch))
    print("launch floor " + json.dumps(rec), flush=True)
    return rec


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


#: forbidden redraws the random-search baseline may need
RANDOM_SEARCH_MAX_REDRAWS = 64


def random_search_median_best(torch, dev, fn, opt, n_evals, budget):
    """Median over ``RANDOM_SEARCH_REPLICATES`` seeded random searches of the
    best loss among ``n_evals`` uniform configurations evaluated at
    ``budget``: the baseline a sweep of the same total budget must beat.
    Configurations come through ``opt``'s space: the port's uniform draw
    and quantization, forbidden rows redrawn until none is left, inactive
    dims 0 as the sweep evaluates them. On an all-float space the draw is
    a uniform point of the unit cube, the same points as a plain
    ``torch.rand`` from the same seed."""
    from hpbandster_tpu_torch.ops.sweep import quantize_unit, random_unit

    tables = opt.codec_tables
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n = RANDOM_SEARCH_REPLICATES * n_evals

    def draw():
        return quantize_unit(tables, random_unit(tables, gen, n))

    def active(v):
        if opt.active_mask_fn is None:
            return torch.ones_like(v, dtype=torch.bool)
        return opt.active_mask_fn(v)

    v = draw()
    if opt.forbidden_fn is not None:
        for _ in range(RANDOM_SEARCH_MAX_REDRAWS):
            bad = opt.forbidden_fn(v, active(v))
            if not bool(bad.any()):
                break
            v = torch.where(bad[:, None], draw(), v)
        else:
            raise AssertionError("random-search baseline: forbidden rows remain")
    v = torch.where(active(v), v, torch.zeros_like(v))
    best = fn(v, budget).reshape(RANDOM_SEARCH_REPLICATES, n_evals).min(dim=1).values
    return float(best.median())


def plan_runs_per_budget(max_budget, n_iterations, stage0_only=False, min_budget=1.0):
    """Runs per budget of the first ``n_iterations`` HyperBand brackets at
    ``eta = 3``, budgets ``min_budget``..``max_budget``, computed here and not
    taken from the optimizer under test. ``stage0_only``: random search's
    plan, each bracket's first stage, all at ``max_budget``."""
    from hpbandster_tpu_torch.ops.bracket import hyperband_bracket

    want = {}
    for i in range(n_iterations):
        p = hyperband_bracket(i, min_budget, max_budget, 3.0)
        stages = ([(p.num_configs[0], max_budget)] if stage0_only
                  else zip(p.num_configs, p.budgets))
        for k, b in stages:
            want[float(b)] = want.get(float(b), 0) + k
    return want


def check_runs_per_budget(name, res, max_budget, n_iterations, stage0_only=False):
    """Runs per budget equal the HyperBand plan (:func:`plan_runs_per_budget`)
    and every loss is finite; returns the plan."""
    want = plan_runs_per_budget(max_budget, n_iterations, stage0_only)
    got = {}
    for r in res.get_all_runs():
        got[r.budget] = got.get(r.budget, 0) + 1
    if got != want:
        raise AssertionError(f"{name}: runs per budget {got} != plan {want}")
    losses = np.asarray([r.loss for r in res.get_all_runs()], np.float64)
    if not np.isfinite(losses).all():
        raise AssertionError(f"{name}: non-finite losses")
    return want


def check_sweep(torch, dev, name, opt, res, fn, max_budget, n_iterations, want=None):
    """The correctness checks of one sweep: runs per budget equal the
    HyperBand plan, all losses finite, the incumbent strictly below the
    median best of equal-budget random searches, model-based picks better
    than random picks. ``want``: runs per budget the caller checked itself
    (a rule that does not run the plan), the random searches' budget.
    Returns the numbers it checked."""
    if want is None:
        want = check_runs_per_budget(name, res, max_budget, n_iterations)
    total_budget = sum(k * b for b, k in want.items())
    losses = [r.loss for r in res.get_all_runs()]
    inc_loss = res.get_runs_by_id(res.get_incumbent_id())[-1].loss
    rs_best = random_search_median_best(torch, dev, fn, opt,
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
        STATIC_RUNS[name] = (opt, res, rec)
    return runs


#: the static path's runs by objective: (optimizer, result, record)
STATIC_RUNS = {}


@contextlib.contextmanager
def env_flags(**env):
    """Environment flags for one path only."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def moments_fit_flag():
    """``HPB_PALLAS_KDE_FIT=1`` for the chunked runs only."""
    return env_flags(HPB_PALLAS_KDE_FIT="1")


def _syncs_of(torch, fn, *args, **kwargs):
    """``(fn(...), the synchronizing CUDA calls it made)``, caught with
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [w for w in caught if "synchroniz" in str(w.message)]


class CountedSweep:
    """A built sweep whose calls count their synchronizing CUDA calls, its
    build's with the first call's. A class rather than a closure, so that
    a cached one holds no reference cycle and frees its graph as soon as
    the cache drops it."""

    def __init__(self, torch, sweep, build_syncs, per_chunk, note):
        self._torch, self._sweep, self._build_syncs = torch, sweep, build_syncs
        self._per_chunk, self._note = per_chunk, note

    @property
    def graph(self):
        """The dynamic tiers' CUDA graph."""
        return self._sweep.graph

    def prepare(self):
        _, syncs = _syncs_of(self._torch, self._sweep.prepare)
        self._build_syncs.extend(syncs)

    def __call__(self, *a, **k):
        out, syncs = _syncs_of(self._torch, self._sweep, *a, **k)
        self._note(self._build_syncs + syncs)
        self._per_chunk.append(len(self._build_syncs) + len(syncs))
        self._build_syncs.clear()
        return out


@contextlib.contextmanager
def sync_counter(torch):
    """Counts the synchronizing CUDA calls of each chunk's sweep: its build
    (``make_fused_sweep_fn`` and the graph's capture, charged to the chunk
    that built the sweep; a chunk served from the sweep cache builds
    nothing) and its device work, one window per chunk. The fetch of a
    chunk's outputs comes after the call and is not counted. Yields
    ``(per-chunk counts, counts by the source line that made the call)``."""
    from hpbandster_tpu_torch.optimizers import fused_bohb

    per_chunk, by_site = [], {}
    build = fused_bohb.make_fused_sweep_fn

    def note(syncs):
        for w in syncs:
            site = f"{Path(w.filename).name}:{w.lineno}"
            by_site[site] = by_site.get(site, 0) + 1

    def counting_build(*args, **kwargs):
        sweep, build_syncs = _syncs_of(torch, build, *args, **kwargs)
        return CountedSweep(torch, sweep, build_syncs, per_chunk, note)

    fused_bohb.make_fused_sweep_fn = counting_build
    try:
        yield per_chunk, by_site
    finally:
        fused_bohb.make_fused_sweep_fn = build


def chunked_optimizer(dev, max_budget=81.0, num_samples=64, seed=0):
    from hpbandster_tpu_torch import FusedBOHB
    from hpbandster_tpu_torch.workloads.toys import hartmann6, hartmann6_space

    return FusedBOHB(configspace=hartmann6_space(seed=0), eval_fn=hartmann6,
                     min_budget=1, max_budget=max_budget, eta=3,
                     num_samples=num_samples, seed=seed, device=dev)


def run_chunked(torch, dev, label, make_opt, fn, max_budget=81.0, n_iterations=10):
    """A chunked FusedBOHB.run() (two brackets a chunk, dynamic-count tier,
    moment-kernel fit) with its synchronizing calls counted: per chunk,
    and once for the optimizer's construction (the codec's constants, the
    fallback configuration and the objective's probe). Returns
    (record, result)."""
    from hpbandster_tpu_torch.ops import cuda_kde

    with moments_fit_flag(), sync_counter(torch) as (syncs, sync_sites):
        t0 = time.perf_counter()
        opt, build_syncs = _syncs_of(torch, make_opt, dev)
        res = opt.run(n_iterations=n_iterations, chunk_brackets=2)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    for row, n_sync in zip(opt.run_stats, syncs):
        print(f"{label} chunk " + json.dumps(dict(row, syncs_inside_chunk=n_sync)),
              flush=True)
    rec = dict(chunk_brackets=2, wall_s=wall,
               execute_fetch_s=sum(r["execute_fetch_s"] for r in opt.run_stats),
               **check_sweep(torch, dev, label, opt, res, fn, max_budget, n_iterations),
               kde_score_launches=cuda_kde.LAUNCHES["kde_score"],
               kde_moments_launches=cuda_kde.LAUNCHES["kde_moments"],
               syncs_inside_chunks=syncs,
               syncs_in_constructor=len(build_syncs),
               sync_sites=dict(sorted(sync_sites.items(), key=lambda kv: -kv[1])))
    if not all(s["dynamic_counts"] for s in opt.run_stats):
        raise AssertionError(f"{label}: the chunked run did not take the dynamic-count tier")
    return rec, opt, res


def drive_chunked_path(torch, dev):
    """Phase 4: the chunked FusedBOHB.run() on Hartmann-6, dynamic-count
    tier with the moment-kernel fit. Returns the result."""
    from hpbandster_tpu_torch.workloads.toys import hartmann6

    rec, _, res = run_chunked(torch, dev, "hartmann6 chunked", chunked_optimizer, hartmann6)
    print("chunked path " + json.dumps(dict(objective="hartmann6", **rec)), flush=True)
    return res


def check_resume(torch, dev, label, uninterrupted, make_opt, n_iterations=10):
    """Phase 5: cut a chunked sweep after 4 brackets with a checkpoint,
    resume in a fresh optimizer, run to the end, and require the result of
    the uninterrupted run exactly."""
    ckpt_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = str(ckpt_dir / f"{label}.ckpt")
    with moments_fit_flag():
        make_opt(dev).run(n_iterations=4, chunk_brackets=2, checkpoint_path=path)
        resumed = make_opt(dev)
        resumed.load_checkpoint(path)
        res = resumed.run(n_iterations=n_iterations, chunk_brackets=2)
    os.unlink(path)

    def runs(r):
        return sorted((x.config_id, x.budget, x.loss) for x in r.get_all_runs())

    if runs(res) != runs(uninterrupted):
        raise AssertionError(f"{label}: resumed chunked run differs from the uninterrupted run")
    if res.get_id2config_mapping() != uninterrupted.get_id2config_mapping():
        raise AssertionError(f"{label}: resumed chunked run sampled other configurations")
    if res.get_incumbent_id() != uninterrupted.get_incumbent_id():
        raise AssertionError(f"{label}: resumed chunked run has another incumbent")
    rec = dict(path=label, brackets_before_cut=4, evaluations=len(runs(res)),
               incumbent=list(res.get_incumbent_id()), equal=True)
    print("resume " + json.dumps(rec), flush=True)
    return rec


# ------------------------------------------------------- conditional paths
def cond_space(seed=0):
    """The conditional space of the reference's fused conditional test
    (``tests/test_sweep.py``): Branin's ``x`` and ``y``; ``opt`` in {sgd,
    adam}; ``momentum`` active when ``opt == sgd``; ``depth`` in [1, 2, 4,
    8]; ``extra`` active when ``depth > 2``; and ``opt == adam`` with
    ``depth == 8`` forbidden."""
    from hpbandster_tpu_torch import space as S

    cs = S.ConfigurationSpace(seed=seed)
    x = S.UniformFloatHyperparameter("x", -5.0, 10.0)
    y = S.UniformFloatHyperparameter("y", 0.0, 15.0)
    opt = S.CategoricalHyperparameter("opt", ["sgd", "adam"])
    mom = S.UniformFloatHyperparameter("momentum", 0.0, 0.99)
    depth = S.OrdinalHyperparameter("depth", [1, 2, 4, 8])
    extra = S.UniformFloatHyperparameter("extra", 0.0, 1.0)
    cs.add_hyperparameters([x, y, opt, mom, depth, extra])
    cs.add_condition(S.EqualsCondition(mom, opt, "sgd"))
    cs.add_condition(S.GreaterThanCondition(extra, depth, 2))
    cs.add_forbidden_clause(S.ForbiddenAndConjunction(
        S.ForbiddenEqualsClause(opt, "adam"), S.ForbiddenEqualsClause(depth, 8)))
    return cs


def cond_objective(v, budget):
    """``branin(x, y, budget) + 0.1 momentum + 0.05 extra``; inactive dims
    arrive as 0."""
    from hpbandster_tpu_torch.workloads.toys import branin

    return branin(v[:, :2], budget) + 0.1 * v[:, 3] + 0.05 * v[:, 5]


def cond_optimizer(dev, max_budget=81.0, num_samples=64):
    from hpbandster_tpu_torch import FusedBOHB

    return FusedBOHB(configspace=cond_space(seed=0), eval_fn=cond_objective,
                     min_budget=1, max_budget=max_budget, eta=3,
                     num_samples=num_samples, seed=0, device=dev)


def check_conditional_configs(torch, label, opt, res):
    """Every evaluated configuration round-trips through the host codec,
    respects the activity pattern (and the device mask agrees with the
    host's NaN pattern) and is not forbidden."""
    cs = opt.configspace
    host = []
    for entry in res.get_id2config_mapping().values():
        cfg = entry["config"]
        vec = cs.to_vector(cfg)
        if dict(cs.from_vector(vec)) != cfg:
            raise AssertionError(f"{label}: {cfg} does not round-trip through the codec")
        if (("momentum" in cfg) != (cfg["opt"] == "sgd")
                or ("extra" in cfg) != (cfg["depth"] > 2)):
            raise AssertionError(f"{label}: {cfg} breaks the activity pattern")
        if cs.is_forbidden(cfg):
            raise AssertionError(f"{label}: {cfg} is forbidden")
        host.append(vec)
    host = np.stack(host)
    q = torch.as_tensor(np.nan_to_num(host, nan=0.0), dtype=torch.float32, device=opt.device)
    if not np.array_equal(opt.active_mask_fn(q).cpu().numpy(), ~np.isnan(host)):
        raise AssertionError(f"{label}: device activity mask differs from the host's")
    return dict(configs=len(host), inactive_share=float(np.isnan(host).mean()))


def drive_conditional_static(torch, dev, max_budget=81.0, n_iterations=10):
    """The static tier's FusedBOHB.run() on the conditional space."""
    from hpbandster_tpu_torch.ops import cuda_kde

    t0 = time.perf_counter()
    opt = cond_optimizer(dev, max_budget)
    res = opt.run(n_iterations=n_iterations)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    rec = dict(objective="branin_conditional", wall_s=wall,
               execute_fetch_s=opt.run_stats[-1]["execute_fetch_s"],
               **check_sweep(torch, dev, "conditional static", opt, res, cond_objective,
                             max_budget, n_iterations),
               **check_conditional_configs(torch, "conditional static", opt, res),
               kde_score_launches=cuda_kde.LAUNCHES["kde_score"])
    print("conditional static path " + json.dumps(rec), flush=True)
    return res


def drive_conditional_chunked(torch, dev):
    """The chunked FusedBOHB.run() on the conditional space (dynamic-count
    tier, moment-kernel fit on imputed data, one launch per split side)."""
    rec, opt, res = run_chunked(torch, dev, "conditional chunked", cond_optimizer,
                                cond_objective)
    rec.update(check_conditional_configs(torch, "conditional chunked", opt, res))
    print("conditional chunked path " + json.dumps(dict(objective="branin_conditional", **rec)),
          flush=True)
    return res


def drive_h2bo(torch, dev, max_budget=81.0, n_iterations=10):
    """FusedH2BO.run() on Hartmann-6 (static): promotions by the power-law
    extrapolation."""
    from hpbandster_tpu_torch import FusedH2BO
    from hpbandster_tpu_torch.ops import cuda_kde
    from hpbandster_tpu_torch.workloads.toys import hartmann6, hartmann6_space

    t0 = time.perf_counter()
    opt = FusedH2BO(configspace=hartmann6_space(seed=0), eval_fn=hartmann6, min_budget=1,
                    max_budget=max_budget, eta=3, num_samples=64, seed=0, device=dev)
    res = opt.run(n_iterations=n_iterations)
    torch.cuda.synchronize(dev)
    rec = dict(objective="hartmann6", wall_s=time.perf_counter() - t0,
               runs_per_budget=check_runs_per_budget("h2bo", res, max_budget, n_iterations),
               incumbent_loss=res.get_runs_by_id(res.get_incumbent_id())[-1].loss,
               kde_score_launches=cuda_kde.LAUNCHES["kde_score"])
    print("h2bo path " + json.dumps(rec), flush=True)
    return res


def drive_model_free(torch, dev, cls_name, max_budget=81.0, n_iterations=10):
    """FusedHyperBand or FusedRandomSearch .run() on Branin (static)."""
    import hpbandster_tpu_torch
    from hpbandster_tpu_torch.workloads.toys import branin, branin_space

    t0 = time.perf_counter()
    opt = getattr(hpbandster_tpu_torch, cls_name)(
        configspace=branin_space(seed=0), eval_fn=branin, min_budget=1,
        max_budget=max_budget, eta=3, num_samples=64, seed=0, device=dev)
    res = opt.run(n_iterations=n_iterations)
    torch.cuda.synchronize(dev)
    want = check_runs_per_budget(cls_name, res, max_budget, n_iterations,
                                 stage0_only=cls_name == "FusedRandomSearch")
    rec = dict(objective="branin", optimizer=cls_name, wall_s=time.perf_counter() - t0,
               runs_per_budget=want,
               incumbent_loss=res.get_runs_by_id(res.get_incumbent_id())[-1].loss)
    print(f"{cls_name} path " + json.dumps(rec), flush=True)
    return res


# ------------------------------------------------------------- batched tier
#: the Master-driven paths' expected launches, derived from each run's
#: Result: one scorer launch for each stage-0 wave that had a model-based
#: pick, and with the in-trace moments fit one moments launch beside it
BATCHED_EXPECTED = {}
#: path -> (optimizer, result, record), for the resume check and PERF.md
BATCHED_RUNS = {}
#: the smallest scorer launch of a model wave: proposal_batch_size (128)
#: proposals of num_samples (64) candidates
BATCHED_MIN_S = 128 * 64
#: the fused and the stage-batched runs of one setting agree within this
#: relative tolerance (the reference's own check, tests/test_fused.py:98)
FUSION_RTOL = 1e-5


def model_waves(iterations, per_config=False):
    """Sampling waves (the configs an iteration sampled at one stage) that
    had a model-based pick: each ran one scorer launch. ``per_config``: a
    rule that samples one config at a time (ASHA) ran one per model-based
    pick."""
    if per_config:
        return sum(bool(d.config_info.get("model_based_pick"))
                   for it in iterations for d in it.data.values())
    return sum(
        len({c[1] for c, d in it.data.items() if d.config_info.get("model_based_pick")})
        for it in iterations)


def batched_optimizer(dev, cls_name, objective="hartmann6", max_budget=81.0,
                      parallel_brackets=3, fuse_brackets=True, seed=0, objective_fn=None,
                      bucket_brackets=True, **kw):
    """A Master-driven optimizer of the port on ``BatchedExecutor(
    VmapBackend(objective))``, eta 3, budgets 1..``max_budget``: the
    reference's ``bench.py:741`` ``bench_batched`` setting. ``objective_fn``
    evaluates in place of the named toy (on its space)."""
    import hpbandster_tpu_torch as h
    from hpbandster_tpu_torch.workloads import toys

    cs = getattr(toys, f"{objective}_space")(seed=seed)
    fn = objective_fn or getattr(toys, objective)
    ex = h.BatchedExecutor(h.VmapBackend(fn, device=dev), cs, fuse_brackets=fuse_brackets,
                           parallel_brackets=parallel_brackets,
                           bucket_brackets=bucket_brackets)
    if cls_name in ("BOHB", "H2BO"):
        kw = dict(num_samples=64, device=dev, **kw)
    return getattr(h, cls_name)(configspace=cs, run_id=f"smoke-{cls_name}", executor=ex,
                                min_budget=1, max_budget=max_budget, eta=3, seed=seed, **kw)


def run_batched(torch, dev, opt, n_iterations, **run_kw):
    """``opt.run()`` with its synchronizing CUDA calls counted; returns
    ``(result, record)``: wall seconds, finished runs per second (the
    reference's ``bench_batched`` measure), host syncs per bracket and by
    source line, model waves, and the executor's fusion counts."""
    t0 = time.perf_counter()
    res, syncs = _syncs_of(torch, opt.run, n_iterations=n_iterations, **run_kw)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    opt.shutdown()
    sites = {}
    for w in syncs:
        site = f"{Path(w.filename).name}:{w.lineno}"
        sites[site] = sites.get(site, 0) + 1
    finished = sum(r.loss is not None for r in res.get_all_runs())
    ex = opt.executor
    return res, dict(
        n_iterations=n_iterations, wall_s=wall, finished_runs=finished,
        runs_per_s=finished / wall, host_syncs=len(syncs),
        host_syncs_per_bracket=len(syncs) / n_iterations,
        sync_sites=dict(sorted(sites.items(), key=lambda kv: -kv[1])),
        model_waves=model_waves(opt.iterations),
        fused_brackets_run=ex.fused_brackets_run, fused_cache_hits=ex.fused_cache_hits,
        fused_cache_misses=ex.fused_cache_misses)


def batched_sweep_checks(torch, dev, label, opt, res, max_budget, n_iterations, want=None):
    """:func:`check_sweep` on a Master-driven run: runs per budget, finite
    losses, the incumbent below the random searches' median best, model
    picks beating random picks. The random searches draw through the
    space's codec, as for the fused paths."""
    import types

    from hpbandster_tpu_torch.ops.sweep import build_space_codec, codec_tables
    from hpbandster_tpu_torch.workloads import toys

    view = types.SimpleNamespace(
        codec_tables=codec_tables(build_space_codec(opt.configspace), dev),
        active_mask_fn=None, forbidden_fn=None, iterations=opt.iterations)
    fn = toys.hartmann6 if opt.configspace.dim == 6 else toys.branin
    return check_sweep(torch, dev, label, view, res, fn, max_budget, n_iterations, want)


def check_wave_launches(label, iterations, moments=False, per_config=False):
    """The path's expected launches from its iterations (one scorer launch
    per model wave, or per model-based pick with ``per_config``), no pick
    that fell back from a failed model, and every scorer launch recorded in
    the path scoring at least ``BATCHED_MIN_S`` candidates (one proposal's
    64 with ``per_config``)."""
    from hpbandster_tpu_torch.ops import cuda_kde

    waves = model_waves(iterations, per_config)
    if waves < 1:
        raise AssertionError(f"{label}: no sampling wave had a model-based pick")
    if any(d.config_info.get("sample_reason") == "model_failure"
           for it in iterations for d in it.data.values()):
        raise AssertionError(f"{label}: a model-based proposal fell back to random")
    min_s = 64 if per_config else BATCHED_MIN_S
    small = [inputs[0].shape[0] for name, inputs in cuda_kde.RECORD
             if name == "kde_score" and inputs[0].shape[0] < min_s]
    if small:
        raise AssertionError(f"{label}: scorer launches below S = {min_s}: {small}")
    BATCHED_EXPECTED[label] = {"kde_score": waves, "kde_moments": waves if moments else 0}


def drive_batched_bohb(torch, dev, max_budget=81.0, n_iterations=10):
    """``BOHB`` + ``BatchedExecutor(VmapBackend(hartmann6),
    parallel_brackets=3)``, the toy setting: the sweep gates and one scorer
    launch per model wave."""
    opt = batched_optimizer(dev, "BOHB")
    res, rec = run_batched(torch, dev, opt, n_iterations)
    rec.update(batched_sweep_checks(torch, dev, "batched_bohb", opt, res, max_budget,
                                    n_iterations))
    check_wave_launches("batched_bohb", opt.iterations)
    print("batched_bohb path " + json.dumps(rec), flush=True)
    BATCHED_RUNS["batched_bohb"] = (opt, res, rec)
    return res


def _runs(res):
    id2c = res.get_id2config_mapping()
    return {(r.config_id, r.budget): (r.loss, id2c[r.config_id]["config"])
            for r in res.get_all_runs()}


def drive_batched_fusion(torch, dev, n_iterations=10):
    """The ``batched_bohb`` setting at ``parallel_brackets=1``, with and
    without bracket fusion: the same ``(config_id, budget)`` set and
    losses within ``FUSION_RTOL``."""
    runs, iterations = {}, []
    for fuse in (True, False):
        opt = batched_optimizer(dev, "BOHB", parallel_brackets=1, fuse_brackets=fuse)
        res, rec = run_batched(torch, dev, opt, n_iterations)
        rec.update(batched_sweep_checks(torch, dev, f"batched_bohb_fusion_{fuse}", opt, res,
                                        81.0, n_iterations))
        if (rec["fused_brackets_run"] > 0) != fuse or (fuse and rec["fused_cache_hits"] < 1):
            raise AssertionError(f"batched_bohb_fusion fuse={fuse}: fused "
                                 f"{rec['fused_brackets_run']}, cache hits "
                                 f"{rec['fused_cache_hits']}")
        print(f"batched_bohb_fusion fuse={fuse} " + json.dumps(rec), flush=True)
        runs[fuse] = _runs(res)
        iterations += opt.iterations
        BATCHED_RUNS[f"batched_bohb_fusion_{fuse}"] = (opt, res, rec)
    if set(runs[True]) != set(runs[False]):
        raise AssertionError("batched_bohb_fusion: fused and stage-batched runs differ "
                             "in their (config_id, budget) set")
    worst = max(abs(runs[True][k][0] - runs[False][k][0]) / max(abs(runs[False][k][0]), 1e-30)
                for k in runs[True])
    if not worst <= FUSION_RTOL:
        raise AssertionError(f"batched_bohb_fusion: losses differ by rel {worst}")
    print("batched_bohb_fusion compare " + json.dumps(
        dict(runs=len(runs[True]), max_rel_loss_diff=worst)), flush=True)
    check_wave_launches("batched_bohb_fusion", iterations)
    return runs


def drive_batched_in_trace(torch, dev, max_budget=81.0, n_iterations=10):
    """``BOHB(in_trace_refit=True)`` with ``HPB_PALLAS_KDE_FIT=1`` and
    ``HPB_USE_PALLAS=1``: each model wave fits on the card (one moments
    launch for both sides) and proposes in the flat layout (one scorer
    launch)."""
    with env_flags(HPB_PALLAS_KDE_FIT="1", HPB_USE_PALLAS="1"):
        opt = batched_optimizer(dev, "BOHB", in_trace_refit=True)
        if not opt.config_generator.use_pallas:
            raise AssertionError("batched_bohb_in_trace: use_pallas did not resolve on")
        res, rec = run_batched(torch, dev, opt, n_iterations)
    rec.update(batched_sweep_checks(torch, dev, "batched_bohb_in_trace", opt, res,
                                    max_budget, n_iterations))
    check_wave_launches("batched_bohb_in_trace", opt.iterations, moments=True)
    print("batched_bohb_in_trace path " + json.dumps(rec), flush=True)
    BATCHED_RUNS["batched_bohb_in_trace"] = (opt, res, rec)
    return res


def drive_batched_model_free(torch, dev, cls_name, max_budget=81.0, n_iterations=10):
    """``HyperBand`` or ``RandomSearch`` on Branin: runs per budget, no
    kernel launch."""
    opt = batched_optimizer(dev, cls_name, objective="branin")
    res, rec = run_batched(torch, dev, opt, n_iterations)
    rec["runs_per_budget"] = check_runs_per_budget(
        cls_name, res, max_budget, n_iterations, stage0_only=cls_name == "RandomSearch")
    label = "batched_hyperband" if cls_name == "HyperBand" else "batched_random_search"
    BATCHED_EXPECTED[label] = {"kde_score": 0, "kde_moments": 0}
    print(f"{label} path " + json.dumps(rec), flush=True)
    return res


def drive_batched_h2bo(torch, dev, max_budget=81.0, n_iterations=10):
    """``H2BO`` on Hartmann-6: learning-curve promotions on the host, the
    proposals as BOHB's."""
    opt = batched_optimizer(dev, "H2BO")
    res, rec = run_batched(torch, dev, opt, n_iterations)
    rec.update(batched_sweep_checks(torch, dev, "batched_h2bo", opt, res, max_budget,
                                    n_iterations))
    check_wave_launches("batched_h2bo", opt.iterations)
    print("batched_h2bo path " + json.dumps(rec), flush=True)
    return res


def drive_batched_resume(torch, dev, cut=4, n_iterations=10):
    """A Master checkpoint taken on the card after ``cut`` brackets of the
    fused ``parallel_brackets=1`` run, loaded into a fresh optimizer and
    run to ``n_iterations``: every run equals the uninterrupted run's
    (``batched_bohb_fusion``, fused) exactly."""
    import tempfile

    victim = batched_optimizer(dev, "BOHB", parallel_brackets=1)
    victim.run(n_iterations=cut)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "master.pkl")
        victim.save_checkpoint(path)
        resumed = batched_optimizer(dev, "BOHB", parallel_brackets=1)
        resumed.load_checkpoint(path)
    res, rec = run_batched(torch, dev, resumed, n_iterations)
    want = _runs(BATCHED_RUNS["batched_bohb_fusion_True"][1])
    got = _runs(res)
    if got != want:
        diff = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
        raise AssertionError(f"batched_resume: {len(diff)} runs differ from the "
                             f"uninterrupted run, first {diff[:3]}")
    check_wave_launches("batched_resume", resumed.iterations)
    rec.update(cut=cut, runs=len(got), equal_to_uninterrupted=True)
    print("batched_resume path " + json.dumps(rec), flush=True)
    return res


_TEACHER_EVAL_FNS = {}


def teacher_eval_fn(dev):
    """The teacher's objective at full width (``TeacherConfig()``), one per
    device in the process: the batched and the serving teacher paths share
    it, so its solo bucket graphs (keyed by objective) are captured once."""
    from hpbandster_tpu_torch.workloads import TeacherConfig, make_teacher_eval_fn

    if dev not in _TEACHER_EVAL_FNS:
        _TEACHER_EVAL_FNS[dev] = make_teacher_eval_fn(TeacherConfig(), device=dev)
    return _TEACHER_EVAL_FNS[dev]


def drive_batched_teacher(torch, dev, n_iterations=4):
    """The teacher at full width on the batched path, ``bench.py:1054``
    ``bench_teacher``'s setting: ``TeacherConfig()``, budgets 1..27, eta 3,
    ``min_points_in_model=5``, seed 0. Gated on runs per budget and crash
    ranking; the incumbent's validation accuracy is reported against
    ``TARGET_VAL_ACCURACY``, not gated."""
    import hpbandster_tpu_torch as h
    from hpbandster_tpu_torch.workloads import TARGET_VAL_ACCURACY, teacher_space

    cs = teacher_space(seed=0)
    ex = h.BatchedExecutor(h.VmapBackend(teacher_eval_fn(dev), device=dev), cs)
    opt = h.BOHB(configspace=cs, run_id="smoke-teacher", executor=ex, min_budget=1,
                 max_budget=27, eta=3, seed=0, min_points_in_model=5, device=dev)
    res, rec = run_batched(torch, dev, opt, n_iterations)
    rec.update(check_workload_sweep("batched_teacher", res, 1.0, 27.0, n_iterations, True))
    rec.update(incumbent_val_accuracy=1.0 - rec["incumbent_loss"],
               target_val_accuracy=TARGET_VAL_ACCURACY)
    check_wave_launches("batched_teacher", opt.iterations)
    print("batched_teacher path " + json.dumps(rec), flush=True)
    BATCHED_RUNS["batched_teacher"] = (opt, res, rec)
    return res


# ------------------------------------------ promotion rules and the journal
#: the directory the journaled paths write into (made in main, removed at
#: its end); path -> the records its journal holds
JOURNAL_DIR = None
JOURNAL_RECORDS = {}
#: the rules the replay harness re-scores every journal under
REPLAY_RULES = ("successive_halving", "asha", "pareto", "lc_earlystop")


@contextlib.contextmanager
def journal(label):
    """The obs journal attached for one run: yields nothing, then keeps the
    journal's records under ``label``."""
    from hpbandster_tpu_torch import obs

    path = os.path.join(JOURNAL_DIR, f"{label}.jsonl")
    with obs.configure(journal_path=path):
        yield
    JOURNAL_RECORDS[label] = obs.read_journal(path)


def check_journal(label, records, res):
    """Every journal: ``replay_records`` under each rule byte-identical
    across two calls, and ``config_lineage`` of the run's incumbent
    resolving to its final result. Returns the record counts."""
    from hpbandster_tpu_torch import obs
    from hpbandster_tpu_torch.promote.replay import format_replay, replay_records

    for rule in REPLAY_RULES:
        a, b = replay_records(records, rule), replay_records(records, rule)
        if (json.dumps(a, sort_keys=True) != json.dumps(b, sort_keys=True)
                or format_replay(a) != format_replay(b)):
            raise AssertionError(f"{label}: replay under {rule} is not byte-identical")
    inc = res.get_incumbent_id()
    lineage = obs.config_lineage(records).get(tuple(inc))
    final = res.get_runs_by_id(inc)[-1]
    if lineage is None or lineage["results"].get(float(final.budget)) != final.loss:
        raise AssertionError(f"{label}: the incumbent {inc}'s lineage does not resolve")
    counts = {}
    for r in records:
        counts[r["event"]] = counts.get(r["event"], 0) + 1
    return dict(records=len(records), decisions=counts.get("promotion_decision", 0),
                incumbent_rungs=len(lineage["rungs"]))


def decisions(records, rule):
    """The journal's promotion records, each decided by ``rule``."""
    out = [r for r in records if r["event"] == "promotion_decision"]
    if not out or any(r["rule"] != rule for r in out):
        raise AssertionError(f"no or foreign promotion records under {rule}: "
                             f"{sorted({r['rule'] for r in out})}")
    return out


def _nan(values):
    return np.array([np.nan if v is None else v for v in values], np.float64)


def check_asha(label, opt, records):
    """ASHA: at every rung the union of the promoted masks over its records
    contains the sync rule's top ``floor(n / eta)`` of the rung's full
    candidate losses; stage 0 runs as planned and every later rung at least
    as planned (an early promotion keeps its slot)."""
    from hpbandster_tpu_torch.ops.bracket import sh_promotion_mask_np

    promoted = {}
    for r in decisions(records, "asha"):
        got = promoted.setdefault((r["iteration"], r["rung"]), set())
        got.update(tuple(c) for c, p in zip(r["config_ids"], r["promoted"]) if p)
    want, over = {}, 0
    for it in opt.iterations:
        for rung, budget in enumerate(it.budgets):
            ids = [c for c, d in it.data.items() if budget in d.results]
            n_plan = it.num_configs[rung]
            if len(ids) != n_plan if rung == 0 else len(ids) < n_plan:
                raise AssertionError(f"{label}: bracket {it.HPB_iter} ran {len(ids)} "
                                     f"configs at rung {rung}, plan {n_plan}")
            over += len(ids) - n_plan
            want[budget] = want.get(budget, 0) + len(ids)
            if rung == len(it.budgets) - 1:
                continue
            losses = _nan([it.data[c].results[budget] for c in ids])
            top = sh_promotion_mask_np(losses, int(len(ids) // opt.eta)) & ~np.isnan(losses)
            missing = {ids[i] for i in np.flatnonzero(top)} - promoted.get(
                (it.HPB_iter, rung), set())
            if missing:
                raise AssertionError(f"{label}: bracket {it.HPB_iter} rung {rung}: the sync "
                                     f"top-k {sorted(missing)} was never promoted")
    return want, over


def run_cost_histogram(records, budget):
    """The ``master.job_run_s.b<budget>`` histogram as it stood, rebuilt
    from the journal's ``job_finished`` run times (a fresh registry)."""
    from hpbandster_tpu_torch import obs

    hist = obs.MetricsRegistry().histogram("h")
    for r in records:
        if r["event"] == "job_finished" and r["budget"] == budget and r.get("run_s") is not None:
            hist.observe(r["run_s"])
    return hist


def check_pareto(torch, dev, label, opt, records):
    """Pareto: every record's mask equals ``pareto_promotion_mask`` on the
    card and ``pareto_promotion_mask_np`` over the record's (losses, costs)
    at the rung's plan, its ranks ``pareto_rank_np``; a rung with at least
    ``COST_FEED_MIN_COUNT`` runs at its budget before it ranked on the
    run-time histogram's p50 (rebuilt from the journal), uniform."""
    from hpbandster_tpu_torch.obs.device_metrics import COST_FEED_MIN_COUNT
    from hpbandster_tpu_torch.ops.bracket import (
        pareto_promotion_mask,
        pareto_promotion_mask_np,
        pareto_rank_np,
    )

    fed = spans = 0
    for i, r in enumerate(records):
        if r["event"] != "promotion_decision":
            continue
        if r["rule"] != "pareto":
            raise AssertionError(f"{label}: a record of rule {r['rule']}")
        k = opt.iterations[r["iteration"]].num_configs[r["rung"] + 1]
        obj = np.stack([_nan(r["losses"]), _nan(r["costs"])], axis=1)
        mask = np.asarray(r["promoted"])
        host = pareto_promotion_mask_np(obj, k)
        card = pareto_promotion_mask(torch.as_tensor(obj.astype(np.float32), device=dev),
                                     k).cpu().numpy()
        ranks = [None if np.isnan(l) else int(x) for x, l in zip(pareto_rank_np(obj), obj[:, 0])]
        if not (np.array_equal(host, mask) and np.array_equal(card, mask)
                and ranks == r["pareto_rank"]):
            raise AssertionError(f"{label}: record {r['iteration']}/{r['rung']}: mask "
                                 f"{mask.tolist()}, host {host.tolist()}, card "
                                 f"{card.tolist()}, ranks {r['pareto_rank']} vs {ranks}")
        hist = run_cost_histogram(records[:i], r["budget"])
        if hist.count >= COST_FEED_MIN_COUNT:
            if set(r["costs"]) != {hist.quantile(0.5)}:
                raise AssertionError(f"{label}: record {r['iteration']}/{r['rung']} costs "
                                     f"{r['costs']}, feed p50 {hist.quantile(0.5)}")
            fed += 1
        else:
            spans += 1
    return dict(decisions_on_feed=fed, decisions_on_spans=spans)


def check_lc_earlystop(label, opt, records, margin=0.0):
    """Learning-curve early stop: every config of a rung's top-k that it
    terminated had a prediction above the cut (the best final-budget loss
    journaled before the decision, plus ``margin``)."""
    from hpbandster_tpu_torch.ops.bracket import sh_promotion_mask_np

    target = opt.max_budget
    best, stopped = None, 0
    for r in records:
        if r["event"] == "job_finished" and r["budget"] == target and r["loss"] is not None:
            best = r["loss"] if best is None else min(best, r["loss"])
        if r["event"] != "promotion_decision":
            continue
        if r["rule"] != "lc_earlystop":
            raise AssertionError(f"{label}: a record of rule {r['rule']}")
        k = opt.iterations[r["iteration"]].num_configs[r["rung"] + 1]
        top = sh_promotion_mask_np(_nan(r["losses"]), k)
        for i in np.flatnonzero(top & ~np.asarray(r["promoted"])):
            pred = r["scores"][i]
            if best is None or pred is None or not pred > best + margin:
                raise AssertionError(f"{label}: {r['config_ids'][i]} terminated with "
                                     f"prediction {pred} against the cut {best}")
            stopped += 1
    return dict(terminated_top_k=stopped)


def same_runs(label, res, want):
    """A run equal to another bit for bit: every (config, budget)'s loss and
    configuration."""
    got = _runs(res)
    if got != want:
        diff = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
        raise AssertionError(f"{label}: {len(diff)} runs differ, first {diff[:3]}")
    return len(got)


def drive_batched_rule(torch, dev, rule, n_iterations=10):
    """``BOHB(promotion_rule=rule)`` at the ``batched_bohb`` setting with a
    journal: the sweep gates, the rule's gates, the journal's replay and
    lineage, one scorer launch per model wave (per model-based pick under
    ASHA); then the rule's degenerate twin bit for bit against the
    barrier run it reduces to: Pareto with ``cost_fn = 1`` against
    ``batched_bohb``, early stop with ``margin = inf`` against
    ``batched_bohb_in_trace``."""
    from hpbandster_tpu_torch import obs

    label = f"batched_bohb_{rule}"
    in_trace = rule == "lc_earlystop"
    flags = (env_flags(HPB_PALLAS_KDE_FIT="1", HPB_USE_PALLAS="1") if in_trace
             else contextlib.nullcontext())
    with flags:
        # Pareto's cost feed holds this run's run times only
        obs.get_metrics().reset()
        opt = batched_optimizer(dev, "BOHB", promotion_rule=rule, in_trace_refit=in_trace)
        with journal(label):
            res, rec = run_batched(torch, dev, opt, n_iterations)
        records = JOURNAL_RECORDS[label]
        want = None
        if rule == "asha":
            want, rec["over_promoted"] = check_asha(label, opt, records)
        elif rule == "pareto":
            rec.update(check_pareto(torch, dev, label, opt, records))
        else:
            rec.update(check_lc_earlystop(label, opt, records))
        rec.update(batched_sweep_checks(torch, dev, label, opt, res, 81.0, n_iterations,
                                        want=want))
        rec.update(check_journal(label, records, res))
        iterations = list(opt.iterations)
        if rule != "asha":
            twin, base, kw = (("pareto_unit_cost", "batched_bohb", {"cost_fn": lambda d, b: 1.0})
                              if rule == "pareto" else
                              ("lc_infinite_margin", "batched_bohb_in_trace",
                               {"margin": float("inf")}))
            opt2 = batched_optimizer(dev, "BOHB", promotion_rule=rule, in_trace_refit=in_trace)
            with journal(f"{label}_{twin}"):
                res2, _ = run_batched(torch, dev, opt2, n_iterations, iteration_kwargs=kw)
            rec[f"{twin}_equal_runs"] = same_runs(f"{label} {twin}", res2,
                                                  _runs(BATCHED_RUNS[base][1]))
            iterations += opt2.iterations
    check_wave_launches(label, iterations, moments=in_trace, per_config=rule == "asha")
    print(f"{label} path " + json.dumps(rec), flush=True)
    BATCHED_RUNS[label] = (opt, res, rec)
    return res


def check_telemetry_record(label, records, opt, plain):
    """The journal's one ``device_telemetry`` record equals the run's
    ``last_device_telemetry`` and, without the measured-time keys, the
    same run's with no sink."""
    tele = [r for r in records if r["event"] == "device_telemetry"]
    if len(tele) != 1:
        raise AssertionError(f"{label}: {len(tele)} device_telemetry records")
    rec = {k: v for k, v in tele[0].items()
           if k not in ("event", "trace_id", "t_wall", "t_mono")}
    if rec != json.loads(json.dumps(opt.last_device_telemetry)):
        raise AssertionError(f"{label}: the journaled telemetry is not the run's")
    if _timing_free(rec) != _timing_free(json.loads(json.dumps(plain))):
        raise AssertionError(f"{label}: the telemetry differs from the run with no sink")


def drive_fused_journal(torch, dev, n_iterations=10):
    """``FusedBOHB`` with a journal, each run against the same run with no
    sink from its earlier path, bit for bit: the static Hartmann-6 sweep
    (``static``), the resident sweep (``resident``) and ``run_incumbent``
    (``incumbent``). One ``sweep_chunk`` per chunk, the device telemetry
    journaled as decoded, the incumbent journaled, the replays and the
    lineage of the static run's incumbent."""
    from hpbandster_tpu_torch import FusedBOHB
    from hpbandster_tpu_torch.workloads.toys import hartmann6, hartmann6_space

    out = {}
    opt = FusedBOHB(configspace=hartmann6_space(seed=0), eval_fn=hartmann6, min_budget=1,
                    max_budget=81, eta=3, num_samples=64, seed=0, device=dev)
    with journal("fused_journal_static"):
        res = opt.run(n_iterations=n_iterations)
    static_opt, static_res, static_rec = STATIC_RUNS["hartmann6"]
    out["static_equal_runs"] = same_runs("fused_journal static", res, _runs(static_res))
    records = JOURNAL_RECORDS["fused_journal_static"]
    out["static"] = check_journal("fused_journal static", records, res)
    with moments_fit_flag():
        opt_r = chunked_optimizer(dev)
        with journal("fused_journal_resident"):
            res_r = opt_r.run(n_iterations=n_iterations, resident=True, device_metrics=True)
        opt_i = chunked_optimizer(dev)
        with journal("fused_journal_incumbent"):
            inc = opt_i.run_incumbent(n_iterations=n_iterations, device_metrics=True)
    plain_r, plain_res_r, _ = RESIDENT_RUNS["resident"]
    compare_sweeps("fused_journal resident", n_iterations, opt_r, res_r, plain_r, plain_res_r)
    check_telemetry_record("fused_journal resident", JOURNAL_RECORDS["fused_journal_resident"],
                           opt_r, plain_r.last_device_telemetry)
    out["resident"] = check_journal("fused_journal resident",
                                    JOURNAL_RECORDS["fused_journal_resident"], res_r)
    plain_i, plain_out, _ = RESIDENT_RUNS["incumbent"]
    if inc["incumbent"] != plain_out["incumbent"]:
        raise AssertionError(f"fused_journal incumbent: {inc['incumbent']} != "
                             f"{plain_out['incumbent']}")
    inc_records = JOURNAL_RECORDS["fused_journal_incumbent"]
    check_telemetry_record("fused_journal incumbent", inc_records, opt_i,
                           plain_out["device_telemetry"])
    (payload,) = [r for r in inc_records if r["event"] == "sweep_incumbent"]
    if (payload["loss"] != inc["incumbent"]["loss"]
            or payload["vector"] != inc["incumbent"]["vector"]):
        raise AssertionError(f"fused_journal incumbent: journaled {payload}")
    for name, recs, chunks in (("static", records, len(opt.run_stats)),
                               ("resident", JOURNAL_RECORDS["fused_journal_resident"],
                                len(opt_r.run_stats)),
                               ("incumbent", inc_records, 1)):
        got = sum(r["event"] == "sweep_chunk" for r in recs)
        if got != chunks:
            raise AssertionError(f"fused_journal {name}: {got} sweep_chunk records for "
                                 f"{chunks} chunks")
    out["incumbent_records"] = len(inc_records)
    BATCHED_EXPECTED["fused_journal"] = {
        "kde_score": static_rec["kde_score_launches"] + 2 * n_iterations,
        "kde_moments": 2 * n_iterations}
    print("fused_journal path " + json.dumps(out), flush=True)
    return res


def measure_obs_overhead(torch, dev, n_iterations=10):
    """``batched_bohb``'s run with no sink and with a journal, in turns
    (none, journal, journal, none), walls printed; no claim. Also the
    records each journaled path wrote."""
    walls = {"none": [], "journal": []}
    for i, sink in enumerate(("none", "journal", "journal", "none")):
        opt = batched_optimizer(dev, "BOHB")
        ctx = journal(f"obs_overhead_{i}") if sink == "journal" else contextlib.nullcontext()
        with ctx:
            _, rec = run_batched(torch, dev, opt, n_iterations)
        walls[sink].append(rec["wall_s"])
    print("obs overhead " + json.dumps(dict(
        batched_bohb_wall_s=walls,
        records_per_journal={k: len(v) for k, v in JOURNAL_RECORDS.items()})), flush=True)


# ------------------------------------------------------------- serving tier
#: serving paths by label: (pool, optimizers by tenant, results by tenant,
#: record), for the solo parity checks of phase 5
SERVE_RUNS = {}
#: the toy serving paths' tenants: one BOHB each, seeds 0-3
SERVE_SEEDS = (0, 1, 2, 3)
#: a tenant thread that has not finished by then fails its path
SERVE_JOIN_S = 600


def fresh_objective(fn):
    """A new closure over ``fn``: the bucket, megabatch and lane runners
    are cached per objective, so a path on its own closure captures its own
    graphs, and counts them."""
    def objective(vectors, budget):
        return fn(vectors, budget)

    return objective


def capture_counts():
    from hpbandster_tpu_torch.ops import graphs

    return {k: graphs.CAPTURES[k] for k in
            ("fused_bucket", "megabatch_bracket", "continuous_bracket")}


def program_stats(runners):
    """Each program's build, capture and instantiate seconds (host clock)
    and its replays' device milliseconds (CUDA events)."""
    out = []
    for r in runners:
        rec = dict(name=r.program.name, widths=list(r.bucket.widths),
                   build_s=r.program.build_s)
        for attr in ("pack_width", "lane_count"):
            if hasattr(r, attr):
                rec[attr] = getattr(r, attr)
        g = r.program.graph
        if g is not None:
            ms = g.replay_ms()
            rec.update(capture_s=g.capture_s, instantiate_s=g.instantiate_s,
                       replays=len(ms), replay_device_ms_total=float(sum(ms)),
                       replay_device_ms_median=float(np.median(ms)) if ms else None)
        out.append(rec)
    return out


def drive_batched_bucketed(torch, dev, max_budget=81.0, n_iterations=10):
    """``BOHB`` + ``BatchedExecutor(VmapBackend(hartmann6))``, the toy
    setting, with the bucketed brackets (the default): the batched sweep
    gates, one scorer launch per model wave, one CUDA graph captured per
    bucket, every fusable bracket on its bucket's graph, and runs equal to
    the same run with ``bucket_brackets=False`` bit for bit (the
    comparison run comes after the path, in phase 5)."""
    from hpbandster_tpu_torch.ops.bracket import hyperband_bracket
    from hpbandster_tpu_torch.workloads import toys

    objective = fresh_objective(toys.hartmann6)
    before = capture_counts()
    opt = batched_optimizer(dev, "BOHB", objective_fn=objective)
    res, rec = run_batched(torch, dev, opt, n_iterations)
    ex = opt.executor
    captured = capture_counts()["fused_bucket"] - before["fused_bucket"]
    fusable = sum(len(hyperband_bracket(i, 1.0, max_budget, 3.0).num_configs) >= 2
                  for i in range(n_iterations))
    if not ex._bucket_precompile.wait(60) or ex._bucket_precompile.errors:
        raise AssertionError(f"batched_bohb_bucketed: precompile {ex._bucket_precompile.errors}")
    if captured != len(ex._bucket_set.buckets):
        raise AssertionError(f"batched_bohb_bucketed: {captured} graphs captured for "
                             f"{len(ex._bucket_set.buckets)} buckets")
    if ex.bucketed_brackets_run != fusable or ex.fused_brackets_run != fusable:
        raise AssertionError(f"batched_bohb_bucketed: {ex.bucketed_brackets_run} bucketed, "
                             f"{ex.fused_brackets_run} fused of {fusable} fusable brackets")
    rec.update(batched_sweep_checks(torch, dev, "batched_bohb_bucketed", opt, res, max_budget,
                                    n_iterations))
    check_wave_launches("batched_bohb_bucketed", opt.iterations)
    rec.update(buckets=[list(b.widths) for b in ex._bucket_set.buckets],
               graphs_captured=captured, bucketed_brackets_run=ex.bucketed_brackets_run,
               programs=program_stats(make_runners(ex, objective)))
    print("batched_bohb_bucketed path " + json.dumps(rec), flush=True)
    BATCHED_RUNS["batched_bohb_bucketed"] = (opt, res, rec)
    return res


def make_runners(ex, objective):
    from hpbandster_tpu_torch.ops.buckets import make_bucketed_bracket_fn

    return [make_bucketed_bracket_fn(objective, b, device=ex.device)
            for b in ex._bucket_set.buckets]


def check_bucketed_parity(torch, dev, n_iterations=10):
    """Phase 5: the bucketed run equals the same seed with
    ``bucket_brackets=False`` (per-shape programs) bit for bit: every run's
    loss and configuration."""
    opt_b, res_b, _ = BATCHED_RUNS["batched_bohb_bucketed"]
    opt = batched_optimizer(dev, "BOHB", objective_fn=opt_b.executor.backend.eval_fn,
                            bucket_brackets=False)
    res, rec = run_batched(torch, dev, opt, n_iterations)
    if opt.executor.bucketed_brackets_run:
        raise AssertionError("batched_bohb_unbucketed: a bracket rode a bucket program")
    want, got = _runs(res), _runs(res_b)
    if got != want:
        diff = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
        raise AssertionError(f"batched_bohb_bucketed: {len(diff)} runs differ from the "
                             f"unbucketed run, first {diff[:3]}")
    rec.update(runs=len(got), equal_bitwise=True)
    print("batched_bohb_bucketed compare " + json.dumps(rec), flush=True)


def serve_pool(dev, objective, space, **kw):
    import hpbandster_tpu_torch as h

    return h.ServePool(h.VmapBackend(objective, device=dev), space, **kw)


def bracket_quantum(max_budget, n_iterations):
    """A deficit-fair scheduler whose quantum covers the costliest bracket
    of the schedule (configs x budget), so that every backlogged tenant can
    dispatch one bracket a round and co-arriving brackets pack. With the
    default quantum (64) a 1..81 bracket (cost up to 405) could only be
    force-served alone, one a round."""
    from hpbandster_tpu_torch.ops.bracket import hyperband_bracket
    from hpbandster_tpu_torch.serve import DeficitFairScheduler, work_cost

    return DeficitFairScheduler(quantum=max(
        work_cost(p.num_configs, p.budgets)
        for p in (hyperband_bracket(i, 1.0, max_budget, 3.0) for i in range(n_iterations))))


def serve_tenants(torch, dev, label, pool, make_opt, seeds, n_iterations, shutdown=True):
    """One optimizer per seed, each driven in its own thread, all started
    together behind a barrier, with the synchronizing CUDA calls counted.
    Returns ``(optimizers, results, record)``: wall seconds, finished runs
    per second in total and per tenant, packed and solo brackets, the
    programs' capture, instantiate and replay times, host syncs per
    bracket, peak memory, and how many tenant jobs were submitted while the
    background precompile ran."""
    opts = {f"t{s}": make_opt(pool, f"t{s}", s) for s in seeds}
    results, errors, walls = {}, {}, {}
    barrier = threading.Barrier(len(opts))

    def tenant(name, opt):
        try:
            barrier.wait(timeout=SERVE_JOIN_S)
            t0 = time.perf_counter()
            results[name] = opt.run(n_iterations=n_iterations)
            walls[name] = time.perf_counter() - t0
            if shutdown:
                opt.shutdown()
        except BaseException as e:  # reported by the driving thread
            errors[name] = e

    def drive():
        threads = [threading.Thread(target=tenant, args=item, daemon=True, name=item[0])
                   for item in opts.items()]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=SERVE_JOIN_S)
            if th.is_alive():
                raise AssertionError(f"{label}: tenant {th.name} did not finish in "
                                     f"{SERVE_JOIN_S} s")

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    _, syncs = _syncs_of(torch, drive)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if errors:
        name, err = next(iter(errors.items()))
        raise AssertionError(f"{label}: tenant {name} failed: {err!r}") from err
    pre = pool.precompile
    if pre is None or not pre.wait(60) or pre.errors:
        raise AssertionError(f"{label}: background precompile {getattr(pre, 'errors', None)}")
    overlapped = sum(pre.started_mono <= j.mono["submitted"] <= pre.finished_mono
                     for opt in opts.values() for j in opt.jobs)
    finished = {t: sum(r.loss is not None for r in res.get_all_runs())
                for t, res in results.items()}
    brackets = len(opts) * n_iterations
    snap = pool.snapshot()
    rec = dict(tenants=len(opts), n_iterations=n_iterations, wall_s=wall,
               finished_runs=sum(finished.values()),
               runs_per_s=sum(finished.values()) / wall,
               runs_per_s_by_tenant={t: finished[t] / walls[t] for t in finished},
               wall_s_by_tenant=walls, buckets=snap["buckets"], rounds=snap["rounds"],
               dispatches=snap["dispatches"], host_syncs=len(syncs),
               host_syncs_per_bracket=len(syncs) / brackets,
               peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               precompile_s=pre.finished_mono - pre.started_mono,
               jobs_submitted_during_precompile=int(overlapped),
               programs=program_stats(pool.programs()))
    return opts, results, rec


def serve_bohb_factory(dev, space_fn, max_budget=81.0, **kw):
    import hpbandster_tpu_torch as h

    def make(pool, tenant, seed):
        return h.BOHB(configspace=space_fn(seed=seed), run_id=f"smoke-serve-{tenant}",
                      tenant_id=tenant, executor=pool.executor_for(tenant), min_budget=1,
                      max_budget=max_budget, eta=3, seed=seed, device=dev, **kw)

    return make


def serve_tenant_checks(torch, dev, label, opts, results, max_budget, n_iterations):
    """Each tenant's runs per budget as planned, finite losses, and its
    incumbent below the median best of equal-budget random searches; the
    model-vs-random medians are reported."""
    import types

    from hpbandster_tpu_torch.ops.sweep import build_space_codec, codec_tables
    from hpbandster_tpu_torch.workloads import toys

    out = {}
    for t, opt in opts.items():
        res = results[t]
        want = check_runs_per_budget(f"{label}_{t}", res, max_budget, n_iterations)
        view = types.SimpleNamespace(codec_tables=codec_tables(
            build_space_codec(opt.configspace), dev), active_mask_fn=None, forbidden_fn=None)
        inc_loss = res.get_runs_by_id(res.get_incumbent_id())[-1].loss
        rs_best = random_search_median_best(
            torch, dev, toys.hartmann6, view,
            int(sum(k * b for b, k in want.items()) // max_budget), max_budget)
        if not inc_loss < rs_best:
            raise AssertionError(f"{label}_{t}: incumbent {inc_loss} is not below the "
                                 f"random searches' median best {rs_best}")
        model_med, random_med = _stage0_medians(opt.iterations)
        out[t] = dict(incumbent_loss=inc_loss, random_search_median_best=rs_best,
                      stage0_median_model=model_med, stage0_median_random=random_med)
    return out


def drive_serve(torch, dev, label, continuous, n_iterations=10):
    """4 ``BOHB`` tenants (seeds 0-3) at the toy setting on Hartmann-6
    through one ``ServePool`` (``pack_window_s=0.05``, a scheduler quantum
    of one bracket's cost; megabatched, or ``continuous=True,
    lane_count=8``), each in its own thread, the
    background precompile overlapping their stage-0 sampling. Gates: each
    tenant's runs per budget and incumbent, the scorer launches equal to
    the model waves over the tenants' Results, the precompile overlapping
    the tenants' submissions, and the captures: at most the buckets times
    {solo, packed} megabatched, at most the bucket families continuous;
    megabatched, at least one packed bracket; continuous, each tenant's
    lane incumbents equal the best final loss of its bucketed brackets."""
    from hpbandster_tpu_torch.workloads import toys

    objective = fresh_objective(toys.hartmann6)
    pool = serve_pool(dev, objective, toys.hartmann6_space(seed=0), pack_window_s=0.05,
                      continuous=continuous, lane_count=8,
                      scheduler=bracket_quantum(81.0, n_iterations))
    before = capture_counts()
    opts, results, rec = serve_tenants(
        torch, dev, label, pool, serve_bohb_factory(dev, toys.hartmann6_space, num_samples=64),
        SERVE_SEEDS, n_iterations, shutdown=not continuous)
    after = capture_counts()
    captured = {k: after[k] - before[k] for k in after}
    n_buckets = rec["buckets"]
    if rec["jobs_submitted_during_precompile"] < 1:
        raise AssertionError(f"{label}: no tenant job was submitted while the background "
                             "precompile ran")
    if continuous:
        if captured["continuous_bracket"] > n_buckets or captured["fused_bucket"] or \
                captured["megabatch_bracket"]:
            raise AssertionError(f"{label}: captures {captured} for {n_buckets} families")
        rec["lane_incumbents"] = check_lane_incumbents(label, pool, opts, results)
        for opt in opts.values():
            opt.shutdown()
        if any(snap["occupied"] for snap in pool.snapshot()["lanes"]):
            raise AssertionError(f"{label}: lanes still owned after every tenant left")
    else:
        if captured["fused_bucket"] + captured["megabatch_bracket"] > 2 * n_buckets or \
                captured["continuous_bracket"]:
            raise AssertionError(f"{label}: captures {captured} for {n_buckets} buckets")
        if rec["dispatches"]["packed_brackets"] < 1:
            raise AssertionError(f"{label}: no bracket was packed")
    rec["graphs_captured"] = captured
    rec["tenant_checks"] = serve_tenant_checks(torch, dev, label, opts, results, 81.0,
                                               n_iterations)
    check_wave_launches(label, [it for opt in opts.values() for it in opt.iterations])
    print(f"{label} path " + json.dumps(rec), flush=True)
    SERVE_RUNS[label] = (pool, opts, results, rec)
    return results


def check_lane_incumbents(label, pool, opts, results):
    """Each tenant's lane incumbents (the device-resident carry, over the
    lanes it owns in every family) equal the best final-stage loss of its
    bucketed brackets in its ``Result``."""
    lane_best = {}
    for runner in pool._continuous_runners.values():
        for owner, inc in zip(runner.lanes.owners, runner.lane_incumbents()):
            if owner is not None and inc is not None:
                lane_best[owner] = min(inc, lane_best.get(owner, float("inf")))
    out = {}
    for t, opt in opts.items():
        finals = [d.results[it.budgets[-1]] for it in opt.iterations if len(it.budgets) >= 2
                  for d in it.data.values() if d.results.get(it.budgets[-1]) is not None]
        want = min(finals)
        if lane_best.get(t) != want:
            raise AssertionError(f"{label}: tenant {t}'s lane incumbent {lane_best.get(t)} "
                                 f"!= its best final loss {want}")
        out[t] = want
    return out


def check_serve_parity(torch, dev, label, n_iterations=10):
    """Phase 5: each tenant of a serving path equals, bit for bit, the same
    seed run alone in a ``ServePool(pack_window_s=0.0)`` on the same
    objective: every run's loss and configuration."""
    from hpbandster_tpu_torch.workloads import toys

    pool, opts, results, _ = SERVE_RUNS[label]
    make = serve_bohb_factory(dev, toys.hartmann6_space, num_samples=64)
    rec = {}
    for t, opt in opts.items():
        solo_pool = serve_pool(dev, pool.backend.eval_fn, toys.hartmann6_space(seed=0),
                               pack_window_s=0.0)
        solo = make(solo_pool, t, int(t[1:]))
        res = solo.run(n_iterations=n_iterations)
        solo.shutdown()
        want, got = _runs(res), _runs(results[t])
        if got != want:
            diff = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
            raise AssertionError(f"{label}: tenant {t}: {len(diff)} runs differ from its "
                                 f"solo run, first {diff[:3]}")
        rec[t] = dict(runs=len(got), solo_dispatches=solo_pool.snapshot()["dispatches"])
    print(f"{label} solo compare " + json.dumps(dict(equal_bitwise=True, tenants=rec)),
          flush=True)


def drive_serve_teacher(torch, dev, n_iterations=4, seeds=(0, 1, 2)):
    """3 tenants of the teacher at full width (``TeacherConfig()``, budgets
    1..27, ``min_points_in_model=5``: ``bench.py:1054``'s setting) in one
    megabatched ``ServePool`` (``pack_width=4``: the three tenants' lanes
    and one pad lane), training inside the captured bucket graphs. Gated
    on runs per budget, crash ranking and a finite incumbent per tenant;
    reports each incumbent's validation accuracy. The objective is
    ``batched_teacher``'s, so the solo bucket graphs that the pool's
    precompile asks for are already captured; the packed graphs are
    captured here."""
    from hpbandster_tpu_torch.workloads import TARGET_VAL_ACCURACY, teacher_space

    pool = serve_pool(dev, teacher_eval_fn(dev),
                      teacher_space(seed=0), pack_window_s=0.05, pack_width=4,
                      scheduler=bracket_quantum(27.0, n_iterations))
    opts, results, rec = serve_tenants(
        torch, dev, "serve_teacher", pool,
        serve_bohb_factory(dev, teacher_space, max_budget=27.0, min_points_in_model=5),
        seeds, n_iterations)
    rec["tenant_checks"] = {}
    for t, res in results.items():
        chk = check_workload_sweep(f"serve_teacher_{t}", res, 1.0, 27.0, n_iterations, True)
        chk["incumbent_val_accuracy"] = 1.0 - chk["incumbent_loss"]
        rec["tenant_checks"][t] = chk
    rec["execute_device_s"] = sum(p.get("replay_device_ms_total", 0.0)
                                  for p in rec["programs"]) / 1e3
    rec["target_val_accuracy"] = TARGET_VAL_ACCURACY
    check_wave_launches("serve_teacher", [it for opt in opts.values() for it in opt.iterations])
    print("serve_teacher path " + json.dumps(rec), flush=True)
    return results


# ------------------------------------------------------------ resident tier
#: resident runs of phase 4, by path: (optimizer, result, brackets), for
#: the parity checks of phase 5
RESIDENT_RUNS = {}


def check_device_metrics(label, opt, res, n_iterations, max_budget=81.0, min_budget=1.0):
    """The run's decoded device telemetry (``opt.last_device_telemetry``)
    against a recount from its ``Result``: per rung, evaluations and
    promotions as the HyperBand plan says, no crash, the histogram sums to
    the evaluations and equals the schema's binning of that rung's losses;
    per bracket, the best final-stage loss is the minimum of its final
    rung; the rung stamps increase in execution order (bracket, then
    stage). Returns what it checked."""
    from hpbandster_tpu_torch.obs.device_metrics import N_BINS, bin_index_np
    from hpbandster_tpu_torch.ops.bracket import hyperband_bracket

    rec = opt.last_device_telemetry
    if rec is None:
        raise AssertionError(f"{label}: no device telemetry was decoded")
    plans = [hyperband_bracket(i, min_budget, max_budget, 3.0) for i in range(n_iterations)]
    want_evals = plan_runs_per_budget(max_budget, n_iterations, min_budget=min_budget)
    want_promos, final = {}, {}
    for p in plans:
        for s, b in enumerate(p.budgets):
            nxt = p.num_configs[s + 1] if s + 1 < len(p.num_configs) else 0
            want_promos[float(b)] = want_promos.get(float(b), 0) + nxt
    losses = {}
    for r in res.get_all_runs():
        losses.setdefault(float(r.budget), []).append(r.loss)
        if r.budget == max_budget:
            final.setdefault(r.config_id[0], []).append(r.loss)
    got = {r["budget"]: r for r in rec["rungs"]}
    if set(got) != set(want_evals):
        raise AssertionError(f"{label}: telemetry rungs {sorted(got)} != plan {sorted(want_evals)}")
    for b, rung in got.items():
        hist = np.bincount(bin_index_np(np.asarray(losses[b], np.float32)), minlength=N_BINS)
        if (rung["evals"] != want_evals[b] or rung["crashes"] != 0
                or rung["promotions"] != want_promos[b]
                or sum(rung["hist"]) != rung["evals"] - rung["crashes"]
                or rung["hist"] != hist.tolist()):
            raise AssertionError(f"{label}: telemetry of rung {b} {rung} disagrees with the "
                                 f"recount (evals {want_evals[b]}, promotions "
                                 f"{want_promos[b]}, histogram {hist.tolist()})")
    if rec["crashes"] != 0 or rec["brackets"] != n_iterations:
        raise AssertionError(f"{label}: {rec['crashes']} crashes over {rec['brackets']} brackets")
    best = [round(float(np.float32(min(final[b]))), 6) for b in range(n_iterations)]
    if rec["per_bracket_best"] != best:
        raise AssertionError(f"{label}: per-bracket bests {rec['per_bracket_best']} != {best}")
    order = [(r["bracket"], r["stage"]) for r in rec["rung_order"]]
    seq = [r["seq"] for r in rec["rung_order"]]
    if order != sorted(order) or any(b <= a for a, b in zip(seq, seq[1:])) \
            or len(order) != sum(len(p.num_configs) for p in plans):
        raise AssertionError(f"{label}: rung stamps out of execution order: {rec['rung_order']}")
    return dict(telemetry_rungs=len(got), telemetry_evaluations=rec["evaluations"],
                telemetry_promotions=rec["promotions"], telemetry_model_fits=rec["model_fits"])


def graph_stats(opt):
    """The resident run's CUDA-graph times from its ``run_stats`` row."""
    row = opt.run_stats[-1]
    if "graph_replay_ms" not in row:
        raise AssertionError("the resident run replayed no CUDA graph")
    replays = row["graph_replay_ms"]
    return dict(graph_capture_s=row["graph_capture_s"],
                graph_instantiate_s=row["graph_instantiate_s"],
                graph_replays=len(replays), graph_replay_ms=replays,
                graph_replay_ms_median=float(np.median(replays)))


def drive_resident(torch, dev, label, make_opt, fn, n_iterations, conditional=False):
    """``run(n_iterations, resident=True, device_metrics=True)`` with the
    moment-kernel fit: the sweep gates, the telemetry recount, the graph's
    times and the synchronizing calls of the sweep's build and call.
    Returns the result."""
    with moments_fit_flag(), sync_counter(torch) as (syncs, sync_sites):
        t0 = time.perf_counter()
        opt, ctor_syncs = _syncs_of(torch, make_opt, dev)
        res = opt.run(n_iterations=n_iterations, resident=True, device_metrics=True)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    rec = dict(n_iterations=n_iterations, wall_s=wall,
               execute_fetch_s=opt.run_stats[-1]["execute_fetch_s"], **graph_stats(opt),
               **check_sweep(torch, dev, label, opt, res, fn, 81.0, n_iterations),
               **check_device_metrics(label, opt, res, n_iterations),
               syncs_in_sweep=syncs, syncs_in_constructor=len(ctor_syncs),
               sync_sites=sync_sites)
    if conditional:
        rec.update(check_conditional_configs(torch, label, opt, res))
    print(f"{label} path " + json.dumps(rec), flush=True)
    RESIDENT_RUNS[label] = (opt, res, n_iterations)
    return res


def drive_incumbent(torch, dev, n_iterations=10):
    """``run_incumbent(n_iterations, device_metrics=True)`` on Hartmann-6
    with the moment-kernel fit. Returns its output."""
    with moments_fit_flag():
        opt = chunked_optimizer(dev)
        out = opt.run_incumbent(n_iterations=n_iterations, device_metrics=True)
    inc = out["incumbent"]
    if len(inc["vector"]) != 6 or not np.isfinite(inc["loss"]):
        raise AssertionError(f"incumbent: malformed incumbent {inc}")
    print("incumbent path " + json.dumps({k: v for k, v in out.items()
                                          if k != "device_telemetry"}), flush=True)
    RESIDENT_RUNS["incumbent"] = (opt, out, n_iterations)
    return out


# ------------------------------------------- sweep cache and chunk pipeline
#: the chunked_long run: its optimizer, result, transfer gauges and chunk
#: keys, for its twins (phase 5) and the runtime_ledger path
CHUNKED_LONG = {}
#: chunked_long's schedule: the BOHB paper's toy setting for 50 brackets
LONG_BRACKETS, LONG_CHUNK = 50, 5


def chunk_keys(opt, n_iterations, chunk):
    """Each chunk's sweep-cache key as the host reckons it: its bracket
    shapes and its pow2 capacities (the warm counts at its boundary plus
    its own additions)."""
    from hpbandster_tpu_torch.ops.sweep import plan_additions, pow2_capacities

    plans = [opt._plan(i) for i in range(n_iterations)]
    warm, keys = {}, []
    for c in range(0, n_iterations, chunk):
        adds = plan_additions(plans[c:c + chunk])
        caps = dict(warm)
        for b, k in adds.items():
            caps[b] = caps.get(b, 0) + k
        keys.append((tuple((p.num_configs, p.budgets) for p in plans[c:c + chunk]),
                     tuple(sorted(pow2_capacities(caps).items()))))
        for b, k in adds.items():
            warm[b] = warm.get(b, 0) + k
    return keys


def fetched_bytes(opt, n_iterations, d=6):
    """The bytes a chunked run fetches, reckoned from its plans: per
    bracket the stage-0 vectors (f32), the model flags (bool), and the
    packed indices (int64) and losses (f32) of every stage."""
    total = 0
    for i in range(n_iterations):
        p = opt._plan(i)
        n0, evals = p.num_configs[0], sum(p.num_configs)
        total += n0 * d * 4 + n0 + evals * (8 + 4)
    return total


def run_long(torch, dev, opt, **kw):
    """``opt.run(n_iterations=50, chunk_brackets=5, **kw)`` to a
    synchronize: (result, wall seconds)."""
    t0 = time.perf_counter()
    res = opt.run(n_iterations=LONG_BRACKETS, chunk_brackets=LONG_CHUNK, **kw)
    torch.cuda.synchronize(dev)
    return res, time.perf_counter() - t0


def drive_chunked_long(torch, dev):
    """``run(n_iterations=50, chunk_brackets=5)`` on Hartmann-6 with the
    moment-kernel fit: every chunk a captured program, as many captures as
    distinct chunk keys, the later chunks of a known key cache hits that
    cost no build, every chunk after the first with its predecessor's
    replay inside it, and the sweep gates. Prints each chunk's times.
    Returns the result."""
    from hpbandster_tpu_torch import obs
    from hpbandster_tpu_torch.ops import graphs
    from hpbandster_tpu_torch.workloads.toys import hartmann6

    with moments_fit_flag():
        before = graphs.CAPTURES["sweep_chunk"]
        opt = chunked_optimizer(dev)
        res, wall = run_long(torch, dev, opt)
        gauges = obs.get_metrics().snapshot()["gauges"]
        captured = graphs.CAPTURES["sweep_chunk"] - before
    keys = chunk_keys(opt, LONG_BRACKETS, LONG_CHUNK)
    hits = [k in keys[:i] for i, k in enumerate(keys)]
    stats = opt.run_stats
    for row in stats:
        print("chunked_long chunk " + json.dumps({k: row.get(k) for k in (
            "chunk_index", "execute_fetch_s", "build_compile_s", "replay_overlap_s",
            "compile_cache_hit", "warm_upload_bytes", "graph_replay_ms")}), flush=True)
    checks = dict(
        captured_programs=all("graph_replay_ms" in s and len(s["graph_replay_ms"]) == 1
                              for s in stats),
        captures_equal_keys=captured == len(set(keys)),
        hits_as_reckoned=[s["compile_cache_hit"] for s in stats] == hits,
        hits_cost_nothing=all(s["build_compile_s"] == 0.0 for s, h in zip(stats, hits) if h),
        overlap_on_rows_1_on=[("replay_overlap_s" in s) for s in stats]
        == [False] + [True] * (len(stats) - 1),
    )
    if not all(checks.values()):
        raise AssertionError(f"chunked_long: {checks}; captures {captured}, keys "
                             f"{len(set(keys))}, hits {hits}")
    rec = dict(brackets=LONG_BRACKETS, chunk_brackets=LONG_CHUNK, wall_s=wall,
               execute_fetch_s=sum(s["execute_fetch_s"] for s in stats),
               build_compile_s=sum(s["build_compile_s"] for s in stats),
               replay_overlap_s=sum(s.get("replay_overlap_s", 0.0) for s in stats),
               captures=captured, distinct_keys=len(set(keys)), cache_hits=sum(hits),
               **checks,
               **check_sweep(torch, dev, "chunked_long", opt, res, hartmann6, 81.0,
                             LONG_BRACKETS))
    CHUNKED_LONG.update(opt=opt, res=res, gauges=gauges)
    print("chunked_long path " + json.dumps(rec), flush=True)
    return res


def check_chunked_long_twins(torch, dev):
    """Phase 5: chunked_long equals, bit for bit, the same run with a
    checkpoint (the replay in turn, no overlap), the same run with the
    sweep cache cleared before each chunk (a capture per chunk), and the
    same run with the chunks run eagerly (no graph)."""
    from hpbandster_tpu_torch.optimizers import fused_bohb

    opt0, res0 = CHUNKED_LONG["opt"], CHUNKED_LONG["res"]
    walls = {"pipelined": sum(s["execute_fetch_s"] for s in opt0.run_stats)}
    with moments_fit_flag():
        seq = chunked_optimizer(dev)
        res, _ = run_long(torch, dev, seq,
                          checkpoint_path=os.path.join(JOURNAL_DIR, "chunked_long.pkl"))
        compare_sweeps("chunked_long", LONG_BRACKETS, opt0, res0, seq, res,
                       kind="chunked_long sequential-replay parity")
        if any("replay_overlap_s" in s for s in seq.run_stats):
            raise AssertionError("chunked_long: the checkpointed run overlapped a replay")
        cleared = chunked_optimizer(dev)
        built = cleared._sweep_built

        def built_afresh(*a, **k):
            fused_bohb._SWEEP_CACHE.clear()
            return built(*a, **k)

        cleared._sweep_built = built_afresh
        res, _ = run_long(torch, dev, cleared)
        compare_sweeps("chunked_long", LONG_BRACKETS, opt0, res0, cleared, res,
                       kind="chunked_long cache-cleared parity")
        if any(s["compile_cache_hit"] for s in cleared.run_stats):
            raise AssertionError("chunked_long: a chunk hit a cache cleared before it")
        eager = chunked_optimizer(dev)
        eager._eager_sweeps = True
        res, _ = run_long(torch, dev, eager)
        compare_sweeps("chunked_long", LONG_BRACKETS, opt0, res0, eager, res,
                       kind="chunked_long eager parity")
        if any("graph_replay_ms" in s for s in eager.run_stats):
            raise AssertionError("chunked_long: an eager chunk replayed a graph")
    for label, opt in (("sequential", seq), ("cache_cleared", cleared), ("eager", eager)):
        walls[label] = sum(s["execute_fetch_s"] for s in opt.run_stats)
    print("chunked_long twins execute_fetch_s " + json.dumps(walls), flush=True)


def drive_sweep_cache(torch, dev, n_iterations=10):
    """The resident sweep run by two fresh optimizers of equal settings and
    seed (a miss, then a hit with an equal result and telemetry), a third
    with another seed on the hit graph (equal to that seed's run on a graph
    captured afresh, the cache cleared), and ``run_incumbent`` twice (a
    hit, an equal payload); all with the moment-kernel fit. Prints the
    miss's capture seconds against the hit's wall. Returns the first
    result."""
    from hpbandster_tpu_torch.optimizers import fused_bohb

    runs = []
    with moments_fit_flag():
        for seed in (0, 0, 1):
            opt = chunked_optimizer(dev, seed=seed)
            t0 = time.perf_counter()
            res = opt.run(n_iterations=n_iterations, resident=True, device_metrics=True)
            torch.cuda.synchronize(dev)
            runs.append((opt, res, time.perf_counter() - t0))
        fused_bohb._SWEEP_CACHE.clear()
        fresh = chunked_optimizer(dev, seed=1)
        fresh_res = fresh.run(n_iterations=n_iterations, resident=True, device_metrics=True)
        incs = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = chunked_optimizer(dev).run_incumbent(n_iterations=n_iterations)
            incs.append((out, time.perf_counter() - t0))
    (miss, res_miss, wall_miss), (hit, res_hit, wall_hit), (reseeded, res_reseeded, _) = runs
    hits = [o.run_stats[-1]["compile_cache_hit"] for o, _, _ in runs]
    if hits != [False, True, True] or fresh.run_stats[-1]["compile_cache_hit"]:
        raise AssertionError(f"sweep_cache: cache hits {hits}, fresh "
                             f"{fresh.run_stats[-1]['compile_cache_hit']}")
    compare_sweeps("sweep_cache", n_iterations, miss, res_miss, hit, res_hit,
                   kind="sweep_cache hit parity")
    if _timing_free(miss.last_device_telemetry) != _timing_free(hit.last_device_telemetry):
        raise AssertionError("sweep_cache: the hit's telemetry differs from the miss's")
    compare_sweeps("sweep_cache", n_iterations, fresh, fresh_res, reseeded, res_reseeded,
                   kind="sweep_cache reseeded-hit parity")
    (inc_miss, inc_miss_wall), (inc_hit, inc_hit_wall) = incs
    if (inc_miss["compile_cache_hit"], inc_hit["compile_cache_hit"]) != (False, True) \
            or inc_hit["incumbent"] != inc_miss["incumbent"]:
        raise AssertionError(f"sweep_cache: run_incumbent hit {inc_hit['compile_cache_hit']}, "
                             f"{inc_hit['incumbent']} != {inc_miss['incumbent']}")
    rec = dict(
        miss_build_capture_s=miss.run_stats[-1]["build_compile_s"],
        miss_graph_capture_s=miss.run_stats[-1].get("graph_capture_s"),
        miss_graph_instantiate_s=miss.run_stats[-1].get("graph_instantiate_s"),
        miss_wall_s=wall_miss, hit_wall_s=wall_hit,
        miss_execute_fetch_s=miss.run_stats[-1]["execute_fetch_s"],
        hit_execute_fetch_s=hit.run_stats[-1]["execute_fetch_s"],
        reseeded_hit_equals_fresh_capture=True,
        incumbent_miss_build_capture_s=inc_miss["build_compile_s"],
        incumbent_miss_wall_s=inc_miss_wall, incumbent_hit_wall_s=inc_hit_wall,
        incumbent_transfers=inc_hit["transfers"])
    print("sweep_cache path " + json.dumps(rec), flush=True)
    return res_miss


def check_sweep_cache_threads(torch, dev, n_iterations=10):
    """Phase 5: two threads share the cached sweeps at once. Seeds 0 and 1
    each run resident, then chunked (two brackets a chunk), first alone
    (which fills the cache), then both together from two threads on the
    same cached graphs: every threaded run is a cache hit and equals its
    seed's run alone bit for bit."""
    def both(seed, barrier=None):
        out = []
        for kw in (dict(resident=True, device_metrics=True), dict(chunk_brackets=2)):
            opt = chunked_optimizer(dev, seed=seed)
            if barrier is not None:
                barrier.wait()
            out.append((opt, opt.run(n_iterations=n_iterations, **kw)))
        torch.cuda.synchronize(dev)
        return out

    with moments_fit_flag():
        alone = {seed: both(seed) for seed in (0, 1)}
        barrier = threading.Barrier(2)
        with ThreadPoolExecutor(2) as pool:
            futures = {seed: pool.submit(both, seed, barrier) for seed in (0, 1)}
            shared = {seed: f.result() for seed, f in futures.items()}
    hits = {seed: [o.run_stats[i]["compile_cache_hit"] for o, _ in runs
                   for i in range(len(o.run_stats))] for seed, runs in shared.items()}
    if not all(all(h) for h in hits.values()):
        raise AssertionError(f"sweep_cache threads: a threaded run missed the cache: {hits}")
    for seed in (0, 1):
        for (opt_a, res_a), (opt_s, res_s), tier in zip(alone[seed], shared[seed],
                                                         ("resident", "chunked")):
            compare_sweeps("sweep_cache", n_iterations, opt_a, res_a, opt_s, res_s,
                           kind=f"sweep_cache two-thread {tier} parity (seed {seed})")


def measure_cache_memory(torch, dev):
    """The device memory the sweep cache holds when nothing empties it: the
    cached paths' runs back to back on one cache, as one user process
    would run them (the main paths empty the cache before each path, so
    each captures its own graphs). More distinct sweeps than the cache's
    16 entries, so the oldest are evicted along the way. Prints, after
    each run, the cache's entries and the allocator's allocated and
    reserved bytes; the peaks over all runs; and the reserved bytes the
    full cache pins (reserved after ``empty_cache()`` with the cache full,
    less the same once it is emptied)."""
    from hpbandster_tpu_torch.optimizers import fused_bohb

    def workload(name, n_iterations, **kw):
        return lambda: workload_optimizer(name, dev)[0].run(n_iterations=n_iterations, **kw)

    resident = dict(resident=True, device_metrics=True)
    runs = [
        ("chunked", lambda: chunked_optimizer(dev).run(n_iterations=10, chunk_brackets=2)),
        ("resident", lambda: chunked_optimizer(dev).run(n_iterations=10, **resident)),
        ("resident_tail", lambda: chunked_optimizer(dev).run(n_iterations=12, **resident)),
        ("resident_long", lambda: chunked_optimizer(dev).run(n_iterations=50, **resident)),
        ("conditional_resident", lambda: cond_optimizer(dev).run(n_iterations=10, **resident)),
        ("incumbent", lambda: chunked_optimizer(dev).run_incumbent(
            n_iterations=10, device_metrics=True)),
        ("chunked_long", lambda: run_long(torch, dev, chunked_optimizer(dev))),
        ("cnn_unrolled", workload("cnn", 4, device_metrics=True, dynamic_counts=True)),
        ("cnn_resident", workload("cnn", 4, **resident)),
        ("ensemble_unrolled", workload("ensemble", 10, dynamic_counts=True)),
        ("ensemble_resident", workload("ensemble", 10, resident=True)),
    ]
    fused_bohb._SWEEP_CACHE.clear()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    rows = [dict(after="start", cache_entries=0,
                 allocated_bytes=torch.cuda.memory_allocated(dev),
                 reserved_bytes=torch.cuda.memory_reserved(dev))]
    with moments_fit_flag():
        for label, run in runs:
            run()
            torch.cuda.synchronize(dev)
            rows.append(dict(after=label, cache_entries=len(fused_bohb._SWEEP_CACHE),
                             allocated_bytes=torch.cuda.memory_allocated(dev),
                             reserved_bytes=torch.cuda.memory_reserved(dev)))
    torch.cuda.empty_cache()
    full = torch.cuda.memory_reserved(dev)
    entries = len(fused_bohb._SWEEP_CACHE)
    fused_bohb._SWEEP_CACHE.clear()
    torch.cuda.empty_cache()
    emptied = torch.cuda.memory_reserved(dev)
    rec = dict(runs=rows, peak_allocated_bytes=torch.cuda.max_memory_allocated(dev),
               peak_reserved_bytes=torch.cuda.max_memory_reserved(dev),
               cache_entries_at_end=entries, reserved_with_full_cache_bytes=full,
               reserved_with_empty_cache_bytes=emptied, cache_pins_bytes=full - emptied)
    print("cache_memory " + json.dumps(rec), flush=True)


def drive_runtime_ledger(torch, dev, n_iterations=10):
    """The runtime ledger on the card: chunked_long's transfer gauges
    against its ``run_stats`` and the bytes its plans fetch; one device
    census; a chunked run with ``profile_dir`` from a cold cache (its
    graphs captured under the profiler), then again on the cached graphs,
    each trace naming ``kde_score``; the roofline's rows against the
    capture ledger and the card's peaks. Returns the cached profiled run's
    result."""
    from hpbandster_tpu_torch import obs
    from hpbandster_tpu_torch.optimizers import fused_bohb
    from hpbandster_tpu_torch.obs.profile import device_peaks, format_roofline, roofline_report
    from hpbandster_tpu_torch.obs.runtime import DeviceSampler
    from hpbandster_tpu_torch.workloads.toys import hartmann6

    opt_long, gauges = CHUNKED_LONG["opt"], CHUNKED_LONG["gauges"]
    stats = opt_long.run_stats
    want = {
        "sweep.transfer_bytes.h2d": float(sum(s["warm_upload_bytes"] for s in stats)),
        "sweep.transfer_bytes.d2h": float(fetched_bytes(opt_long, LONG_BRACKETS)),
        "sweep.host_syncs": float(sum(s["warm_upload_bytes"] > 0 for s in stats) + len(stats)),
    }
    got = {k: gauges.get(k) for k in want}
    if got != want or not all(v > 0 for v in got.values()):
        raise AssertionError(f"runtime_ledger: chunked_long's gauges {got} != {want}")
    census = DeviceSampler(registry=obs.MetricsRegistry()).sample()
    card = census["devices"]["0"]
    if not (card["bytes_in_use"] > 0 and card["bytes_limit"] == torch.cuda.mem_get_info(0)[1]):
        raise AssertionError(f"runtime_ledger: census {census}")
    # profiled twice: from a cold cache (each chunk's graph captured inside
    # the profiler), then on the graphs that run cached (replays only)
    traced = {}
    keys = chunk_keys(chunked_optimizer(dev), n_iterations, 5)
    with moments_fit_flag():
        fused_bohb._SWEEP_CACHE.clear()
        for label, want_hits in (("cold", [k in keys[:i] for i, k in enumerate(keys)]),
                                 ("cached", [True] * len(keys))):
            trace_dir = tempfile.mkdtemp(prefix=f"trace_{label}_", dir=JOURNAL_DIR)
            opt = chunked_optimizer(dev)
            res = opt.run(n_iterations=n_iterations, chunk_brackets=5, profile_dir=trace_dir)
            names = set()
            for f in sorted(os.listdir(trace_dir)):
                with open(os.path.join(trace_dir, f)) as fh:
                    names |= {e.get("name", "") for e in json.load(fh).get("traceEvents", [])}
            hits = [s["compile_cache_hit"] for s in opt.run_stats]
            if not any("kde_score" in n for n in names) or hits != want_hits:
                raise AssertionError(f"runtime_ledger: the {label} profiled run's trace names "
                                     f"no kde_score kernel, or its cache hits are {hits}")
            traced[label] = dict(files=len(os.listdir(trace_dir)), cache_hits=hits,
                                 build_compile_s=[s["build_compile_s"] for s in opt.run_stats],
                                 kde_events=sorted(n for n in names if "kde_" in n)[:4])
    replay_s = [ms / 1e3 for s in stats for ms in s["graph_replay_ms"]]
    report = roofline_report(seconds_by_program={"sweep_chunk": float(np.median(replay_s))})
    ledger = {(p["fn"], p["signature"]) for p in obs.get_compile_tracker().programs()}
    rows = {(p["fn"], p["signature"]) for p in report["programs"]}
    peaks = report["peak"]
    if rows != ledger or not any(fn == "sweep_chunk" for fn, _ in rows) \
            or peaks["kind"] != torch.cuda.get_device_name(0) \
            or peaks["bytes_per_s"] is None or peaks["flops_per_s"] is None:
        raise AssertionError(f"runtime_ledger: roofline rows {len(rows)} vs ledger "
                             f"{len(ledger)}, peaks {peaks}")
    print(format_roofline(report), flush=True)
    rec = dict(gauges=got, census=census, traces=traced,
               roofline_programs=report["program_count"], peaks=peaks,
               checks=check_runs_per_budget("runtime_ledger", res, 81.0, n_iterations),
               device_peaks_default=device_peaks()["kind"])
    print("runtime_ledger path " + json.dumps(rec), flush=True)
    return res


def profile_chunked_long(torch, dev):
    """``--profile``: device-busy milliseconds and the idle share of
    chunked_long against its sequential-replay twin (checkpointed), both
    on cached graphs, profiled in turns."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    with moments_fit_flag():
        for label in ("pipelined", "sequential", "sequential", "pipelined"):
            kw = ({} if label == "pipelined" else
                  dict(checkpoint_path=os.path.join(JOURNAL_DIR, "profile_long.pkl")))
            opt = chunked_optimizer(dev)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, wall = run_long(torch, dev, opt, **kw)
            busy = sum(_device_us(e) for e in prof.key_averages()
                       if e.device_type.name == "CUDA") / 1e3
            out.setdefault(label, []).append(dict(
                wall_s=wall, device_busy_ms=busy, idle_share=1.0 - busy / 1e3 / wall,
                execute_fetch_s=sum(s["execute_fetch_s"] for s in opt.run_stats),
                replay_overlap_s=sum(s.get("replay_overlap_s", 0.0) for s in opt.run_stats)))
    print("chunked_long profile " + json.dumps(out), flush=True)
    return out


def check_resident_parity(torch, dev, label, make_opt):
    """Phase 5: the resident run of ``label`` against a same-seed unrolled
    dynamic-tier run of the same length, bit for bit: every observation
    vector and loss in append order per budget, the configurations and
    their model flags, the runs. Returns the unrolled optimizer."""
    opt_r, res_r, n = RESIDENT_RUNS[label]
    with moments_fit_flag():
        opt_u = make_opt(dev)
        res_u = opt_u.run(n_iterations=n, dynamic_counts=True)
    compare_sweeps(label, n, opt_r, res_r, opt_u, res_u)
    return opt_u


def compare_sweeps(label, n, opt_r, res_r, opt_u, res_u, kind="resident parity"):
    """A resident run against a same-seed unrolled dynamic-tier run (or
    any run against its twin, printed as ``kind``), bit for bit (fatal
    otherwise)."""
    def runs(r):
        return sorted((x.config_id, x.budget, x.loss) for x in r.get_all_runs())

    def flags(r):
        return {c: v["config_info"]["model_based_pick"]
                for c, v in r.get_id2config_mapping().items()}

    same_obs = (set(opt_r._warm_v) == set(opt_u._warm_v) and all(
        np.array_equal(opt_r._warm_v[b], opt_u._warm_v[b], equal_nan=True)
        and np.array_equal(opt_r._warm_l[b], opt_u._warm_l[b], equal_nan=True)
        for b in opt_u._warm_v))
    checks = dict(observations=same_obs, runs=runs(res_r) == runs(res_u),
                  configs=res_r.get_id2config_mapping() == res_u.get_id2config_mapping(),
                  model_flags=flags(res_r) == flags(res_u))
    if not all(checks.values()):
        raise AssertionError(f"{label}: {kind} fails, the runs differ: {checks}")
    print(f"{kind} " + json.dumps(dict(path=label, brackets=n, **checks)), flush=True)


def check_stateful_resident(torch, dev, n_iterations=10):
    """Phase 5: a ``StatefulEval`` on the card: per-config linear-regression
    lanes (weights from a numpy seed, learning rate from the config, one
    gradient step per budget unit, continued across rungs) on Branin's
    space through ``run(resident=True)``, equal bit for bit to the
    unrolled dynamic tier, every run finite."""
    from hpbandster_tpu_torch import FusedBOHB
    from hpbandster_tpu_torch.ops.fused import StatefulEval
    from hpbandster_tpu_torch.workloads.toys import branin_space

    rng = np.random.default_rng(42)
    x = torch.as_tensor(rng.normal(size=(64, 8)), dtype=torch.float32, device=dev)
    y = x @ torch.as_tensor(rng.normal(size=8), dtype=torch.float32, device=dev)
    w0 = torch.as_tensor(rng.normal(size=(2, 8)), dtype=torch.float32, device=dev)

    def step_fn(w, v, budget, prev_budget):
        lr = (0.002 + 0.01 * v[:, :1])
        for _ in range(int(round(budget - prev_budget))):
            w = w - lr * (2.0 / x.shape[0]) * ((w @ x.T - y) @ x)
        return w, ((w @ x.T - y) ** 2).mean(dim=1)

    seam = StatefulEval(lambda v: v @ w0, step_fn)
    results = []
    for kw in (dict(resident=True), dict(dynamic_counts=True)):
        opt = FusedBOHB(configspace=branin_space(seed=0), stateful_eval=seam, min_budget=1,
                        max_budget=81, eta=3, num_samples=64, seed=0, device=dev)
        res = opt.run(n_iterations=n_iterations, **kw)
        results.append((opt, sorted((r.config_id, r.budget, r.loss) for r in res.get_all_runs())))
    (opt_r, runs_r), (opt_u, runs_u) = results
    equal = runs_r == runs_u and all(np.array_equal(opt_r._warm_v[b], opt_u._warm_v[b])
                                     for b in opt_u._warm_v)
    finite = all(loss is not None and np.isfinite(loss) for _, _, loss in runs_r)
    rec = dict(brackets=n_iterations, runs=len(runs_r), equal=equal, finite=finite,
               best_loss=min(loss for _, _, loss in runs_r), **graph_stats(opt_r))
    print("stateful resident " + json.dumps(rec), flush=True)
    if not (equal and finite):
        raise AssertionError(f"stateful resident run: {rec}")
    return rec


def _timing_free(rec):
    """A decoded telemetry record without the fields derived from time."""
    if isinstance(rec, dict):
        return {k: _timing_free(v) for k, v in rec.items()
                if k not in ("execute_s", "est_cost_s", "est_s")}
    if isinstance(rec, list):
        return [_timing_free(v) for v in rec]
    return rec


def check_incumbent_parity():
    """Phase 5: ``run_incumbent`` against the same-seed resident run: the
    best final-stage row of each bracket (first on ties, crashes last), the
    best of them, its vector, and the same decoded telemetry."""
    from hpbandster_tpu_torch.ops.bracket import hyperband_bracket

    _, out, n = RESIDENT_RUNS["incumbent"]
    opt_r, _, n_r = RESIDENT_RUNS["resident"]
    if n != n_r:
        raise AssertionError("incumbent: the resident run has another length")
    # every HyperBand bracket ends at the max budget: its final rung is the
    # bracket's segment of the observations there, in bracket order
    v, l = opt_r._warm_v[81.0], opt_r._warm_l[81.0]
    key = np.where(np.isnan(l), np.float32(3.0e38), l)
    per_bracket, rows, off = [], [], 0
    for i in range(n):
        k = hyperband_bracket(i, 1.0, 81.0, 3.0).num_configs[-1]
        a = off + int(np.argmin(key[off:off + k]))
        per_bracket.append(float(l[a]))
        rows.append(a)
        off += k
    best = int(np.argmin(key[rows]))
    want = dict(vector=[float(x) for x in v[rows[best]]], loss=float(l[rows[best]]),
                bracket=best, per_bracket_loss=per_bracket)
    if out["incumbent"] != want:
        raise AssertionError(f"incumbent {out['incumbent']} != resident run's {want}")
    if _timing_free(out["device_telemetry"]) != _timing_free(opt_r.last_device_telemetry):
        raise AssertionError("incumbent: device telemetry differs from the resident run's")
    print("incumbent parity " + json.dumps(dict(equal=True, bracket=best, loss=want["loss"])),
          flush=True)


def profile_resident_launches(torch, dev, n_iterations=10):
    """The profiler's count of each kernel over a resident sweep against
    the wrappers' count (captured launches times replays). A few empty
    launches open the window, where the profiler has missed events."""
    from torch.profiler import ProfilerActivity, profile

    from hpbandster_tpu_torch.ops import cuda_kde

    opt = chunked_optimizer(dev)
    before = dict(cuda_kde.LAUNCHES)
    with moments_fit_flag(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            cuda_kde.noop_launch(dev)
        opt.run(n_iterations=n_iterations, resident=True)
        torch.cuda.synchronize(dev)
    counted = {k: cuda_kde.LAUNCHES[k] - before[k] for k in before}
    seen = {"kde_score": 0, "kde_moments": 0}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        if "kde_score_kernel" in e.key:
            seen["kde_score"] += int(e.count)
        elif "moments_kernel" in e.key:
            seen["kde_moments"] += int(e.count)
    rec = dict(wrapper_counts=counted, profiler_counts=seen)
    print("resident launches by the profiler " + json.dumps(rec), flush=True)
    if seen != counted:
        raise AssertionError(f"resident sweep: profiler saw {seen}, wrappers counted {counted}")
    return rec


def measure_resident(torch, dev, n_iterations=50, reps=5):
    """The resident tier's times on this card at ``n_iterations``: the
    graph's capture and instantiate seconds and device milliseconds per
    replay (from the resident run), one eager round of the unrolled dynamic
    sweep (host clock to a synchronize, the same five brackets and buffer
    capacities), and wall, device-busy time and idle share of the resident
    run against the unrolled dynamic run (one captured graph; profiled, its
    graph cached by the unprofiled run before it), with their unprofiled
    walls and execute+fetch seconds."""
    from torch.profiler import ProfilerActivity, profile

    from hpbandster_tpu_torch.ops.sweep import plan_additions, pow2_capacities

    out = {}
    with moments_fit_flag():
        for label, kw in (("resident", dict(resident=True)),
                          ("unrolled_dynamic", dict(dynamic_counts=True))):
            opt = chunked_optimizer(dev)
            t0 = time.perf_counter()
            opt.run(n_iterations=n_iterations, **kw)
            torch.cuda.synchronize(dev)
            rec = dict(wall_s=time.perf_counter() - t0,
                       execute_fetch_s=opt.run_stats[-1]["execute_fetch_s"])
            if label == "resident":
                rec.update(graph_stats(opt))
            opt = chunked_optimizer(dev)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                opt.run(n_iterations=n_iterations, **kw)
                torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0
            busy = sum(_device_us(e) for e in prof.key_averages()
                       if e.device_type.name == "CUDA") / 1e6
            rec.update(profiled_wall_s=wall, device_busy_s=busy,
                       device_idle_share=1.0 - busy / wall,
                       profiled_execute_fetch_s=opt.run_stats[-1]["execute_fetch_s"])
            out[label] = rec
        opt = chunked_optimizer(dev)
        opt._eager_sweeps = True  # an eager round, not a replay
        plans = [opt._plan(i) for i in range(n_iterations)]
        sweep = opt._sweep_fn(plans[:5], dynamic_counts=True,
                              capacities=pow2_capacities(plan_additions(plans)))
        times = []
        for i in range(reps + 1):
            t0 = time.perf_counter()
            sweep(i)
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
    out["eager_round_ms"] = times[1:]
    out["eager_round_ms_median"] = float(np.median(times[1:]))
    out["n_iterations"] = n_iterations
    print("resident timing " + json.dumps(out), flush=True)
    return out


def measure_conditional_host_work(torch, dev, n0=81, cap=256, reps=200):
    """Host and event time per call of the conditional path's new device
    work at the main path's shapes: the 8-pass rejection resampling of one
    bracket's 81 proposals (its draws included), the activity mask, and
    one side's imputation over a 256-row buffer; and the synchronizing
    calls each makes."""
    from hpbandster_tpu_torch.ops.kde import impute_conditional_masked
    from hpbandster_tpu_torch.ops.sweep import quantize_unit, random_unit, resample_forbidden

    opt = cond_optimizer(dev)
    tables = opt.codec_tables
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def draw(n):
        return quantize_unit(tables, random_unit(tables, gen, n))

    vecs = draw(n0)
    fallback = quantize_unit(tables, opt._fallback_vector)
    buf = torch.where(opt.active_mask_fn(draw(cap)), draw(cap), float("nan"))
    buf[cap // 3:] = float("nan")  # the non-members of one split side
    u = torch.rand((2, cap, buf.shape[1]), generator=gen, device=dev)
    def resample():
        # one bracket's new work: eight passes' draws, their quantization
        # and the closed-form selection
        redraws = torch.stack([random_unit(tables, gen, n0) for _ in range(8)])
        return resample_forbidden(vecs, opt.forbidden_fn, opt.active_mask_fn,
                                  quantize_unit(tables, redraws), fallback)

    calls = {
        "resample_8_passes": resample,
        "active_mask": lambda: opt.active_mask_fn(vecs),
        "impute_one_side": lambda: impute_conditional_masked(buf, tables.cards, u[0], u[1]),
    }
    out = {}
    for name, call in calls.items():
        _, syncs = _syncs_of(torch, call)
        out[name] = dict(host_ms=_host_ms(call, torch, reps=reps),
                         event_ms=_median_ms(call, torch), syncs=len(syncs))
    print("conditional host work " + json.dumps(out), flush=True)
    if any(r["syncs"] for r in out.values()):
        raise AssertionError("the conditional path's new device work synchronizes")
    return out


# ---------------------------------------------------------- workload paths
#: the training workloads' sweeps (the reference's ``bench.py`` settings):
#: path -> (optimizer, result, record), for phase 5 and the workloads line
WORKLOAD_RUNS = {}
#: the CNN sweep's incumbent must reach this validation accuracy. Chance is
#: 0.1; a chance-level classifier's accuracy on the 256 validation images
#: has a standard deviation of sqrt(0.1 * 0.9 / 256) = 0.019, so the best
#: of the sweep's ~13 runs at the max budget stays near 0.16 by luck alone;
#: 0.30 is seven deviations above that, and well under the 0.746 the
#: reference's sweeps reach (``CNN_TARGET_VAL_ACCURACY`` 0.70)
CNN_MIN_VAL_ACCURACY = 0.30
#: CNN validation cross-entropy on the card against the CPU, 3 SGD steps on
#: the same data and weights: both round every convolution to bfloat16, and
#: cuDNN and the CPU's library sum in other orders, so a value can round to
#: the neighbouring bfloat16 (2^-9 relative) and the layers and steps carry
#: that on (the CPU tests hold the port to the reference at 2e-2)
CNN_CPU_RTOL = 3e-2
#: the ensemble's promoted lanes against the uninterrupted trainer where
#: they are not bit for bit equal: a batched GEMM over another number of
#: lanes may take another cuBLAS kernel, summing in another order
ENSEMBLE_RTOL = 1e-4
ENSEMBLE_ATOL = 1e-6


def _crash_rank(loss):
    """A ``Result`` loss as the sweep ranked it: a crash (None) behind every
    real loss, a genuine +inf behind that."""
    return float(np.float32(3.0e38)) if loss is None else loss


def check_workload_sweep(label, res, min_budget, max_budget, n_iterations, error_rate):
    """A training workload's sweep: runs per budget equal the HyperBand
    plan; error rates lie in [0, 1]; each rung promoted its best, a crash
    (a diverged lane, NaN) never ahead of a real loss, so a rung's
    survivors are finite wherever it had enough finite losses; the
    incumbent's loss is finite. A survivor may still diverge at the next
    rung's longer training: crashes are counted, not gated. Returns what it
    checked."""
    want = plan_runs_per_budget(max_budget, n_iterations, min_budget=min_budget)
    got = {}
    for r in res.get_all_runs():
        got[r.budget] = got.get(r.budget, 0) + 1
    if got != want:
        raise AssertionError(f"{label}: runs per budget {got} != plan {want}")
    rungs = {}
    for r in res.get_all_runs():
        rungs.setdefault((r.config_id[0], float(r.budget)), {})[r.config_id] = r.loss
    crashes = 0
    for (b, budget), losses in sorted(rungs.items()):
        real = [v for v in losses.values() if v is not None]
        crashes += len(losses) - len(real)
        if error_rate and not all(0.0 <= v <= 1.0 for v in real):
            raise AssertionError(f"{label}: an error rate outside [0, 1] at budget {budget}")
        later = [bb for (bi, bb) in rungs if bi == b and bb > budget]
        if later:
            promoted = rungs[(b, min(later))]
            kept = [_crash_rank(v) for c, v in losses.items() if c in promoted]
            dropped = [_crash_rank(v) for c, v in losses.items() if c not in promoted]
            if dropped and max(kept) > min(dropped):
                raise AssertionError(f"{label}: bracket {b} at budget {budget} promoted "
                                     f"{sorted(kept)} over {min(dropped)}")
    inc = res.get_incumbent_id()
    inc_loss = None if inc is None else res.get_runs_by_id(inc)[-1].loss
    if inc_loss is None or not np.isfinite(inc_loss):
        raise AssertionError(f"{label}: no finite incumbent at budget {max_budget}")
    return dict(evaluations=len(res.get_all_runs()), crashes=crashes,
                incumbent_loss=inc_loss)


def workload_optimizer(name, dev):
    """``(optimizer, min_budget, max_budget, error_rate, training FLOPs of
    a Result)`` of a training workload at its reference settings and full
    widths, seed 0 (the reference's ``bench.py``)."""
    from hpbandster_tpu_torch import FusedBOHB
    from hpbandster_tpu_torch.workloads import flops
    from hpbandster_tpu_torch.workloads import (
        CNNConfig,
        MLPConfig,
        ResNetConfig,
        TeacherConfig,
        TransformerConfig,
        cnn_space,
        make_cnn_error_fn,
        make_mlp_ensemble,
        make_resnet_eval_fn,
        make_teacher_eval_fn,
        make_transformer_error_fn,
        mlp_space,
        resnet_space,
        teacher_space,
        transformer_space,
    )

    if name == "cnn":  # bench.py:857 bench_cnn
        kw = dict(configspace=cnn_space(seed=0), eval_fn=make_cnn_error_fn(CNNConfig(), device=dev))
        spec = (3.0, 81.0, True, lambda r: flops.sweep_training_flops(
            r, flops.cnn_step_flops(CNNConfig()), include_failed=True))
    elif name == "ensemble":  # workloads/ensemble.py make_mlp_ensemble
        kw = dict(configspace=mlp_space(seed=0),
                  stateful_eval=make_mlp_ensemble(MLPConfig(), device=dev))
        spec = (1.0, 81.0, False, lambda r: ensemble_training_flops(r, MLPConfig()))
    elif name == "teacher":  # tests/test_teacher_workload.py:93-96
        kw = dict(configspace=teacher_space(seed=0),
                  eval_fn=make_teacher_eval_fn(TeacherConfig(), device=dev))
        spec = (1.0, 27.0, True, lambda r: flops.sweep_training_flops(
            r, flops.teacher_epoch_flops(TeacherConfig()), include_failed=True))
    elif name == "resnet":  # bench.py:903 bench_resnet
        kw = dict(configspace=resnet_space(seed=0),
                  eval_fn=make_resnet_eval_fn(ResNetConfig(), device=dev))
        spec = (3.0, 27.0, False, lambda r: flops.sweep_training_flops(
            r, flops.resnet_step_flops(ResNetConfig()), include_failed=True))
    else:  # bench.py:958 bench_transformer
        kw = dict(configspace=transformer_space(seed=0),
                  eval_fn=make_transformer_error_fn(TransformerConfig(), device=dev))
        spec = (3.0, 81.0, True, lambda r: flops.sweep_training_flops(
            r, flops.transformer_step_flops(TransformerConfig()), include_failed=True))
    opt = FusedBOHB(min_budget=spec[0], max_budget=spec[1], eta=3, seed=0, device=dev, **kw)
    return (opt,) + spec


def ensemble_training_flops(res, cfg):
    """The ensemble's training FLOPs: a lane trains only its rung's budget
    increment (warm continuation), so each bracket's rung ``s`` costs
    ``n_s * (b_s - b_{s-1})`` steps."""
    from hpbandster_tpu_torch.workloads.flops import mlp_step_flops

    steps = 0.0
    for b in {r.config_id[0] for r in res.get_all_runs()}:
        budgets = sorted({r.budget for r in res.get_all_runs() if r.config_id[0] == b})
        for prev, budget in zip([0.0] + budgets, budgets):
            n = sum(1 for r in res.get_all_runs()
                    if r.config_id[0] == b and r.budget == budget)
            steps += n * (round(budget) - round(prev))
    return mlp_step_flops(cfg) * steps


def drive_workload(torch, dev, label, name, n_iterations, **run_kw):
    """One training workload's ``FusedBOHB.run()`` on the card: the sweep
    gates, wall and execute+fetch seconds, peak memory, and the training
    FLOP/s against the card's bfloat16 peak. A resident run also passes
    the telemetry recount (with ``device_metrics``) and gives its graph's
    times. Returns the result."""
    from hpbandster_tpu_torch.workloads.flops import peak_bf16_flops

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    opt, min_b, max_b, error_rate, flops_of = workload_optimizer(name, dev)
    res = opt.run(n_iterations=n_iterations, **run_kw)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    execute_s = sum(r["execute_fetch_s"] for r in opt.run_stats)
    train_flops = flops_of(res)
    peak = peak_bf16_flops(dev)
    rec = dict(workload=name, n_iterations=n_iterations, min_budget=min_b, max_budget=max_b,
               run_kw=run_kw, moments_fit=os.environ.get("HPB_PALLAS_KDE_FIT") == "1",
               wall_s=wall, execute_fetch_s=execute_s,
               peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
               **check_workload_sweep(label, res, min_b, max_b, n_iterations, error_rate),
               training_flops=train_flops, training_flops_per_s=train_flops / execute_s,
               share_of_peak_bf16=None if peak is None else train_flops / execute_s / peak)
    if error_rate:
        rec["incumbent_val_accuracy"] = 1.0 - rec["incumbent_loss"]
    if run_kw.get("resident"):
        rec.update(graph_stats(opt))
    if run_kw.get("device_metrics"):
        rec.update(check_device_metrics(label, opt, res, n_iterations, max_b, min_b))
    print(f"{label} path " + json.dumps(rec), flush=True)
    WORKLOAD_RUNS[label] = (opt, res, rec)
    return res


def drive_cnn(torch, dev):
    """The CNN at full width, static tier, ``bench_cnn``'s sweep; its
    incumbent must beat chance by ``CNN_MIN_VAL_ACCURACY``."""
    from hpbandster_tpu_torch.workloads import CNN_TARGET_VAL_ACCURACY

    res = drive_workload(torch, dev, "cnn", "cnn", 5)
    acc = WORKLOAD_RUNS["cnn"][2]["incumbent_val_accuracy"]
    print("cnn incumbent " + json.dumps(dict(
        val_accuracy=acc, gate=CNN_MIN_VAL_ACCURACY, chance=0.1,
        target_val_accuracy=CNN_TARGET_VAL_ACCURACY,
        target_met=acc >= CNN_TARGET_VAL_ACCURACY)), flush=True)
    if not acc >= CNN_MIN_VAL_ACCURACY:
        raise AssertionError(f"cnn: incumbent validation accuracy {acc} < {CNN_MIN_VAL_ACCURACY}")
    return res


def drive_cnn_tier(torch, dev, label, **run_kw):
    """The CNN through the dynamic tier, one rotation (4 brackets), with
    the moment-kernel fit and the device metrics: unrolled, or resident (a
    captured CUDA graph holding the round's training, backward passes
    included)."""
    with moments_fit_flag():
        return drive_workload(torch, dev, label, "cnn", 4, device_metrics=True, **run_kw)


def check_cnn_against_cpu(torch, dev, n=8, budget=3.0):
    """The CNN's validation cross-entropy after ``budget`` steps for ``n``
    seeded configs (learning rates up to 0.16), on the card and on the CPU
    from the same data and weights (drawn on the CPU), within
    ``CNN_CPU_RTOL``."""
    from hpbandster_tpu_torch.workloads.cnn import (
        CNNConfig,
        draw_cnn_unit_params,
        make_cnn_eval_fn,
        make_image_dataset,
    )
    from hpbandster_tpu_torch.workloads.train import make_generator

    cfg, cpu = CNNConfig(), torch.device("cpu")
    data = make_image_dataset(make_generator(cpu, 0), cfg)
    unit = draw_cnn_unit_params(make_generator(cpu, 1), cfg)
    v = torch.from_numpy(np.random.default_rng(0).uniform(0.05, 0.8, (n, 4)).astype(np.float32))
    t0 = time.perf_counter()
    on_card = make_cnn_eval_fn(cfg, device=dev, data=data, init=unit)(v.to(dev), budget).cpu()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = make_cnn_eval_fn(cfg, device=cpu, data=data, init=unit)(v, budget)
    cpu_s = time.perf_counter() - t0
    err = float(((on_card - on_cpu).abs() / on_cpu.abs()).max())
    rec = dict(configs=n, budget=budget, max_rel_err=err, rtol=CNN_CPU_RTOL,
               card=on_card.tolist(), cpu=on_cpu.tolist(), card_s=card_s, cpu_s=cpu_s)
    print("cnn card vs cpu " + json.dumps(rec), flush=True)
    if not (torch.isfinite(on_card).all() and err <= CNN_CPU_RTOL):
        raise AssertionError(f"cnn: card and CPU losses differ: {rec}")
    return rec


def check_workload_parity(label_r, label_u):
    """Phase 5: a workload's resident run against its unrolled run, bit for
    bit."""
    opt_r, res_r, rec = WORKLOAD_RUNS[label_r]
    opt_u, res_u, _ = WORKLOAD_RUNS[label_u]
    compare_sweeps(label_r, rec["n_iterations"], opt_r, res_r, opt_u, res_u)


def check_ensemble_continuation(torch, dev):
    """Phase 5: the ensemble at ``MLPConfig()`` through the first bracket of
    its sweep (81 configs, budgets 1..81); each rung's losses and the
    promoted lane's final state against ``make_uninterrupted_train_fn`` at
    the same cumulative steps: bit for bit where that holds, else within
    ``ENSEMBLE_RTOL``/``ENSEMBLE_ATOL``."""
    from hpbandster_tpu_torch.ops.bracket import hyperband_bracket
    from hpbandster_tpu_torch.ops.fused import fused_sh_bracket, tree_leaves
    from hpbandster_tpu_torch.workloads import (
        MLPConfig,
        make_mlp_ensemble,
        make_uninterrupted_train_fn,
    )

    plan = hyperband_bracket(0, 1.0, 81.0, 3.0)
    v = torch.from_numpy(np.random.default_rng(0).random((81, 4)).astype(np.float32)).to(dev)
    stages, state = fused_sh_bracket(None, v, plan.num_configs, plan.budgets,
                                     stateful=make_mlp_ensemble(MLPConfig(), device=dev),
                                     return_final_state=True)
    straight = make_uninterrupted_train_fn(MLPConfig(), device=dev)
    bitwise, worst = True, 0.0

    def diff(a, b):
        nonlocal bitwise, worst
        same_nan = bool((torch.isnan(a) == torch.isnan(b)).all())
        a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        bitwise = bitwise and same_nan and torch.equal(a, b)
        excess = ((a - b).abs() - ENSEMBLE_ATOL - ENSEMBLE_RTOL * b.abs()).max()
        worst = max(worst, float(excess) if same_nan else float("inf"))

    for (idx, losses), budget in zip(stages, plan.budgets):
        diff(losses, straight(v[idx], int(round(budget)))[1])
    final_state = straight(v[stages[-1][0]], int(round(plan.budgets[-1])))[0]
    for a, b in zip(tree_leaves(state), tree_leaves(final_state)):
        diff(a, b)
    rec = dict(lanes=plan.num_configs, budgets=plan.budgets, bitwise=bitwise,
               worst_excess_over_tolerance=worst, rtol=ENSEMBLE_RTOL, atol=ENSEMBLE_ATOL)
    print("ensemble continuation " + json.dumps(rec), flush=True)
    if worst > 0.0:
        raise AssertionError(f"ensemble: promoted lanes differ from the uninterrupted run: {rec}")
    return rec


def print_workload_accuracies():
    """The teacher's and the transformer's incumbents beside the
    reference's documented targets (reported, not gated)."""
    from hpbandster_tpu_torch.workloads import (
        TARGET_VAL_ACCURACY,
        TRANSFORMER_TARGET_VAL_ACCURACY,
    )

    for label, target in (("teacher", TARGET_VAL_ACCURACY),
                          ("transformer", TRANSFORMER_TARGET_VAL_ACCURACY)):
        acc = WORKLOAD_RUNS[label][2]["incumbent_val_accuracy"]
        print(f"{label} incumbent " + json.dumps(dict(
            val_accuracy=acc, target_val_accuracy=target, target_met=acc >= target)),
            flush=True)


def profile_workloads(torch, dev):
    """``--profile``: each workload path again under the profiler: device
    busy time and idle share over the sweep's wall."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, (_, _, rec) in WORKLOAD_RUNS.items():
        run_kw = {k: v for k, v in rec["run_kw"].items() if k != "device_metrics"}
        with contextlib.ExitStack() as stack:
            if rec["moments_fit"]:
                stack.enter_context(moments_fit_flag())
            opt = workload_optimizer(rec["workload"], dev)[0]
            torch.cuda.synchronize(dev)
            prof = stack.enter_context(
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            t0 = time.perf_counter()
            opt.run(n_iterations=rec["n_iterations"], **run_kw)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        busy = sum(_device_us(e) for e in events) / 1e6
        top = sorted(events, key=_device_us, reverse=True)[:8]
        out[label] = dict(profiled_wall_s=wall, device_busy_ms=busy * 1e3,
                          device_idle_share=1.0 - busy / wall,
                          top_kernels=[dict(name=e.key[:60], count=int(e.count),
                                            device_ms=_device_us(e) / 1e3) for e in top])
        print(f"profile {label} " + json.dumps(out[label]), flush=True)
    return out


def workloads_line(torch, profiled, card):
    """The workloads' JSON line: per path the wall and execute+fetch
    seconds, device busy ms and idle share (``--profile``, else not
    measured), peak memory and training FLOP/s with its share of the
    card's bfloat16 peak; and the card."""
    keys = ("workload", "n_iterations", "wall_s", "execute_fetch_s", "peak_memory_bytes",
            "training_flops", "training_flops_per_s", "share_of_peak_bf16", "evaluations",
            "crashes", "incumbent_val_accuracy", "graph_capture_s", "graph_instantiate_s",
            "graph_replay_ms")
    paths = {}
    for label, (_, _, rec) in WORKLOAD_RUNS.items():
        row = {k: rec[k] for k in keys if k in rec}
        prof = profiled.get(label, {})
        row["device_busy_ms"] = prof.get("device_busy_ms", "not measured")
        row["device_idle_share"] = prof.get("device_idle_share", "not measured")
        paths[label] = row
    return "workloads " + json.dumps(dict(card=card, paths=paths))


def record_facts(name, inputs):
    """What a recorded launch's inputs (a ``cuda_kde.RECORD`` entry) were:
    ``finite`` (no NaN or inf in any tensor input), ``mixed_vartypes`` (the
    scorer saw a vartype other than 0, so its per-vartype branch ran) and
    ``discrete_cards`` (a nonzero cardinality: the scorer's
    Aitchison-Aitken and ordinal terms, or the moments' discrete bandwidth
    cap)."""
    import torch

    if name == "kde_score":
        cands, good, bad, vt, cards = inputs
        tensors = [cands, *good, *bad, vt, cards]
        mixed = bool((vt != 0).any())
    else:
        data, masks, cards, _ = inputs
        tensors = [data, masks] + ([] if cards is None else [cards])
        mixed = False
    return dict(
        finite=all(bool(torch.isfinite(t).all()) for t in tensors),
        mixed_vartypes=mixed,
        discrete_cards=cards is not None and bool((cards != 0).any()),
    )


def check_record_facts(recorded):
    """Every recorded launch's inputs are finite; print, per path, how many
    scorer launches took the mixed-vartype branch and how many launches of
    either kernel saw discrete cards. Returns those counts."""
    counts = {}
    for path, name, inputs in recorded:
        facts = record_facts(name, inputs)
        if not facts["finite"]:
            raise AssertionError(f"{path}: a {name} launch had a non-finite input")
        c = counts.setdefault(path, {"kde_score_mixed_vartypes": 0,
                                     "kde_score_discrete_cards": 0,
                                     "kde_moments_discrete_cards": 0})
        if name == "kde_score":
            c["kde_score_mixed_vartypes"] += facts["mixed_vartypes"]
            c["kde_score_discrete_cards"] += facts["discrete_cards"]
        else:
            c["kde_moments_discrete_cards"] += facts["discrete_cards"]
    print("recorded launches: all inputs finite; by path " + json.dumps(counts), flush=True)
    return counts


def _device_us(event):
    return float(getattr(event, "self_device_time_total", 0.0) or
                 getattr(event, "self_cuda_time_total", 0.0))


def profile_sweeps(torch, dev):
    """Device time by kernel and the device idle share over static,
    chunked and resident Hartmann-6 and conditional sweeps
    (``--profile``)."""
    from torch.profiler import ProfilerActivity, profile

    for label, make_opt, run_kw in (
            ("static", chunked_optimizer, {}),
            ("chunked", chunked_optimizer, dict(chunk_brackets=2)),
            ("resident", chunked_optimizer, dict(resident=True)),
            ("conditional_static", cond_optimizer, {}),
            ("conditional_chunked", cond_optimizer, dict(chunk_brackets=2)),
            ("conditional_resident", cond_optimizer, dict(resident=True))):
        opt = make_opt(dev)
        with contextlib.ExitStack() as stack:
            if run_kw:
                stack.enter_context(moments_fit_flag())
            prof = stack.enter_context(
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            t0 = time.perf_counter()
            opt.run(n_iterations=10, **run_kw)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        total_us = sum(_device_us(e) for e in events)
        top = sorted(events, key=_device_us, reverse=True)[:12]
        out = dict(path=label, wall_s=wall, device_busy_s=total_us / 1e6,
                   device_idle_share=(1.0 - total_us / 1e6 / wall) if total_us else None,
                   kernels=[dict(name=e.key[:80], count=int(e.count),
                                 device_ms=_device_us(e) / 1e3) for e in top])
        print("profile " + json.dumps(out), flush=True)


def profile_moments_device_time(torch, dev, reps=20):
    """Device time per call of the fit's moments and bandwidths at the
    scale checks, by kernel (``--profile``; the CUDA events of phase 2 also
    hold the wrapper's host work). Measured twice: back to back, where
    inputs under the card's 50 MB L2 stay cached, and with a 128 MB buffer
    rewritten before every call, so the inputs come from HBM as the bound
    assumes."""
    from torch.profiler import ProfilerActivity, profile

    from hpbandster_tpu_torch.ops import cuda_kde

    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    for name, seed, c, cards, frac in MOMENTS_CASES:
        data, masks = moments_inputs(torch, dev, seed, c, cards, frac)
        cards_t = _fit_cards(torch, data, cards)
        cuda_kde.moment_bandwidths(data, masks, cards_t, MIN_BANDWIDTH)
        torch.cuda.synchronize(dev)
        rec = dict(shape=name)
        for l2 in ("warm_l2", "cold_l2"):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    if l2 == "cold_l2":
                        flush.zero_()
                    cuda_kde.moment_bandwidths(data, masks, cards_t, MIN_BANDWIDTH)
                torch.cuda.synchronize(dev)
            mine = [e for e in prof.key_averages()
                    if e.device_type.name == "CUDA" and "moments" in e.key]
            per_launch = {e.key[:60]: _device_us(e) / 1e3 / reps for e in mine}
            rec[l2] = dict(per_launch_ms=per_launch, total_ms=sum(per_launch.values()),
                           kernels_per_call=sum(e.count for e in mine) / reps)
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
    from hpbandster_tpu_torch.optimizers import fused_bohb
    from hpbandster_tpu_torch.workloads.toys import hartmann6

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # deterministic cuDNN algorithms: a conv workload's resident run equals
    # its unrolled run bit for bit only with these
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda", 0)
    global JOURNAL_DIR
    JOURNAL_DIR = tempfile.mkdtemp(prefix="chip_smoke_journal_")
    atexit.register(shutil.rmtree, JOURNAL_DIR, True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    build_kernels()

    # phase 2: kernels against plain versions at scale checks
    checks = {"kde_score": check_kde_score(torch, dev),
              "kde_moments": check_kde_moments(torch, dev)}

    # phases 3 and 4: each main path with the counts reset just before and
    # read just after, every launch's inputs recorded
    paths = {
        "static": drive_static_path,
        "chunked": drive_chunked_path,
        "conditional_static": drive_conditional_static,
        "conditional_chunked": drive_conditional_chunked,
        "h2bo": drive_h2bo,
        "hyperband": lambda torch, dev: drive_model_free(torch, dev, "FusedHyperBand"),
        "random_search": lambda torch, dev: drive_model_free(torch, dev, "FusedRandomSearch"),
        "resident": lambda torch, dev: drive_resident(
            torch, dev, "resident", chunked_optimizer, hartmann6, 10),
        "resident_tail": lambda torch, dev: drive_resident(
            torch, dev, "resident_tail", chunked_optimizer, hartmann6, 12),
        "resident_long": lambda torch, dev: drive_resident(
            torch, dev, "resident_long", chunked_optimizer, hartmann6, 50),
        "conditional_resident": lambda torch, dev: drive_resident(
            torch, dev, "conditional_resident", cond_optimizer, cond_objective, 10,
            conditional=True),
        "incumbent": drive_incumbent,
        # the sweep cache, the pipelined chunk replay and the runtime ledger
        "chunked_long": drive_chunked_long,
        "sweep_cache": drive_sweep_cache,
        "runtime_ledger": drive_runtime_ledger,
        # the training workloads at the reference's widths
        "cnn": drive_cnn,
        "cnn_unrolled": lambda torch, dev: drive_cnn_tier(
            torch, dev, "cnn_unrolled", dynamic_counts=True),
        "cnn_resident": lambda torch, dev: drive_cnn_tier(
            torch, dev, "cnn_resident", resident=True),
        "ensemble_unrolled": lambda torch, dev: drive_workload(
            torch, dev, "ensemble_unrolled", "ensemble", 10, dynamic_counts=True),
        "ensemble_resident": lambda torch, dev: drive_workload(
            torch, dev, "ensemble_resident", "ensemble", 10, resident=True),
        "teacher": lambda torch, dev: drive_workload(torch, dev, "teacher", "teacher", 4),
        "resnet": lambda torch, dev: drive_workload(torch, dev, "resnet", "resnet", 2),
        "transformer": lambda torch, dev: drive_workload(
            torch, dev, "transformer", "transformer", 2),
        # the Master-driven tier (per-bracket batched path)
        "batched_bohb": drive_batched_bohb,
        "batched_bohb_fusion": drive_batched_fusion,
        "batched_bohb_in_trace": drive_batched_in_trace,
        "batched_hyperband": lambda torch, dev: drive_batched_model_free(
            torch, dev, "HyperBand"),
        "batched_random_search": lambda torch, dev: drive_batched_model_free(
            torch, dev, "RandomSearch"),
        "batched_h2bo": drive_batched_h2bo,
        "batched_resume": drive_batched_resume,
        "batched_teacher": drive_batched_teacher,
        # the promotion rules and the journal
        "batched_bohb_asha": lambda torch, dev: drive_batched_rule(torch, dev, "asha"),
        "batched_bohb_pareto": lambda torch, dev: drive_batched_rule(torch, dev, "pareto"),
        "batched_bohb_lc_earlystop": lambda torch, dev: drive_batched_rule(
            torch, dev, "lc_earlystop"),
        "fused_journal": drive_fused_journal,
        # the bucketed brackets and the serving tier
        "batched_bohb_bucketed": drive_batched_bucketed,
        "serve_megabatch": lambda torch, dev: drive_serve(
            torch, dev, "serve_megabatch", continuous=False),
        "serve_continuous": lambda torch, dev: drive_serve(
            torch, dev, "serve_continuous", continuous=True),
        "serve_teacher": drive_serve_teacher,
    }
    launches, recorded, results, seconds = {}, [], {}, {}
    for path, drive in paths.items():
        # each path builds and captures its own sweeps (and records their
        # launches); cached graphs hold their memory pools until dropped
        fused_bohb._SWEEP_CACHE.clear()
        for name in cuda_kde.LAUNCHES:
            cuda_kde.LAUNCHES[name] = 0
        cuda_kde.RECORD = []
        t0 = time.perf_counter()
        results[path] = drive(torch, dev)
        seconds[path] = time.perf_counter() - t0
        launches[path] = dict(cuda_kde.LAUNCHES)
        recorded += [(path, name, inputs) for name, inputs in cuda_kde.RECORD]
        cuda_kde.RECORD = None
    print("main path launches " + json.dumps(launches), flush=True)
    print("main path seconds " + json.dumps(seconds), flush=True)
    expected = {**MAIN_PATH_LAUNCHES, **BATCHED_EXPECTED}
    if launches != expected:
        raise AssertionError(
            f"main path launches {launches} != {expected}: every model "
            "bracket of the static sweeps scores once, every chunked, resident "
            "or incumbent bracket fits and scores once (a conditional fit runs "
            "the moments once per split side), HyperBand and random search run "
            "no model, every Master-driven model wave scores once (and fits "
            "once with the in-trace moments fit)")
    facts = check_record_facts(recorded)
    for path in ("conditional_static", "conditional_chunked", "conditional_resident"):
        if not facts[path]["kde_score_mixed_vartypes"]:
            raise AssertionError(f"{path}: no kde_score launch took the mixed-vartype branch")
    for path in ("conditional_chunked", "conditional_resident"):
        if not facts[path]["kde_moments_discrete_cards"]:
            raise AssertionError(f"{path}: no kde_moments launch saw discrete cards")

    # phase 5: resume on the card equals the uninterrupted chunked runs
    check_resume(torch, dev, "hartmann6_chunked", results["chunked"], chunked_optimizer)
    check_resume(torch, dev, "conditional_chunked", results["conditional_chunked"],
                 cond_optimizer)
    check_chunked_long_twins(torch, dev)
    check_sweep_cache_threads(torch, dev)
    for label, make_opt in (("resident", chunked_optimizer),
                            ("resident_tail", chunked_optimizer),
                            ("resident_long", chunked_optimizer),
                            ("conditional_resident", cond_optimizer)):
        check_resident_parity(torch, dev, label, make_opt)
    check_incumbent_parity()
    check_stateful_resident(torch, dev)
    check_workload_parity("cnn_resident", "cnn_unrolled")
    check_workload_parity("ensemble_resident", "ensemble_unrolled")
    check_cnn_against_cpu(torch, dev)
    check_ensemble_continuation(torch, dev)
    check_bucketed_parity(torch, dev)
    check_serve_parity(torch, dev, "serve_megabatch")
    check_serve_parity(torch, dev, "serve_continuous")
    print_workload_accuracies()
    profile_resident_launches(torch, dev)
    measure_resident(torch, dev)
    measure_conditional_host_work(torch, dev)
    measure_obs_overhead(torch, dev)
    measure_cache_memory(torch, dev)

    # phase 6: kernels against plain versions on the main paths' own inputs
    held = check_recorded_launches(torch, recorded)

    profiled = {}
    if args.profile:
        profile_sweeps(torch, dev)
        profile_chunked_long(torch, dev)
        profile_moments_device_time(torch, dev)
        profiled = profile_workloads(torch, dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(workloads_line(torch, profiled, smi), flush=True)

    floor = launch_floor(torch, dev)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        per_path, main_err = held[name]
        path = max(per_path, key=lambda p: per_path[p]["size"])
        main_rec = per_path[path]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(launches[p][name] for p in launches),
            launches_by_path={p: launches[p][name] for p in launches},
            max_abs_err=max([main_err] + [c["max_abs_err"] for c in checks[name]]),
            ms=main_rec["ms"], plain_ms=main_rec["plain_ms"],
            bound_ms=main_rec["bound_ms"], bound_by=main_rec["bound_by"],
            library_ms=None,
            device_ms=main_rec["device_ms"], host_ms=main_rec["host_ms"], **floor,
            largest_launch_path=path,
            ms_by_path={p: r["ms"] for p, r in per_path.items()},
            device_ms_by_path={p: r["device_ms"] for p, r in per_path.items()},
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
