#!/usr/bin/env python3
"""Times the KDE kernels' wrappers of one checkout of the port on one CUDA
card, so that two checkouts can be compared on the same card:

    python3 compare_kernels.py --root path/to/checkout --label parent

``--root`` is the directory that holds the checkout's
``hpbandster_tpu_torch`` package; its kernels are built there. The
inputs, the timers and the profiler come from this directory's
``chip_smoke.py``, so every checkout is measured the same way through the
wrapper signatures all of them share (``score_candidates``,
``masked_moments``, ``moment_bandwidths``). Run the checkouts in turns
(A, B, B, A) in one session on one card.

It prints one ``compare {...}`` JSON line per measurement:

* ``host``: mean host time per call (``chip_smoke._host_ms``) at the main
  paths' largest launches, with ``vartypes``/``cards`` passed as int32 and
  as float32 (what a sweep hands the wrapper: int32 before the sweep kept
  float32 twins, float32 after);
* ``device``: per call, event-timed ms (``chip_smoke._median_ms``) and the
  profiler's device time by kernel and in all, with the kernels per call,
  at the same launches (float32 arguments);
* ``moments_scale``: the masked moments and the fit's bandwidths at the
  scale checks of ``chip_smoke.MOMENTS_CASES``, device time per call of the
  moments kernels with warm L2 (back to back) and cold L2 (a 128 MB buffer
  rewritten before every call), and of all kernels with warm L2; and the
  span of a call's moments kernels on the device clock (first start to
  last end, the gap between two launches included);

then the card's name and power limit. Needs one CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


def _smoke():
    """This directory's ``chip_smoke.py``, loaded by path (the checkout
    under test may hold its own)."""
    path = Path(__file__).resolve().parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _emit(label, kind, rec):
    print("compare " + json.dumps(dict(label=label, kind=kind, **rec)), flush=True)


def _per_call(torch, smoke, fn, reps=20, flush=None, only="moments"):
    """Device ms per call from the profiler: ``{"all_ms": ms, "span_ms":
    :func:`_mean_span_ms`, "kernels": {name: [ms per launch, launches per
    call]}}``; with ``flush``, a buffer
    rewritten before every call and only kernels whose name holds
    ``only`` counted."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    if flush is not None:
        events = [e for e in events if only in e.key]
    us = sum(smoke._device_us(e) for e in events)
    return dict(all_ms=us / 1e3 / reps, span_ms=_mean_span_ms(prof), kernels={
        e.key[:60]: [smoke._device_us(e) / 1e3 / max(e.count, 1), e.count / reps]
        for e in events})


def _mean_span_ms(prof):
    """Mean span of one call's moments kernels on the device clock: from the
    start of its first kernel to the end of its last, the gap between two
    launches included (a kernel whose name holds neither ``finish`` nor
    ``final`` opens a call). None when no moments kernel ran."""
    evs = sorted((e for e in prof.events()
                  if e.device_type.name == "CUDA" and "moments" in e.name),
                 key=lambda e: e.time_range.start)
    spans, cur = [], None
    for e in evs:
        if "finish" not in e.name and "final" not in e.name:
            if cur is not None:
                spans.append(cur[1] - cur[0])
            cur = [e.time_range.start, e.time_range.end]
        elif cur is not None:
            cur[1] = e.time_range.end
    if cur is not None:
        spans.append(cur[1] - cur[0])
    return float(np.mean(spans)) / 1e3 if spans else None


def _fit_inputs(torch, dev, c=256, d=6, live=(7, 17), seed=400):
    """The chunked path's fit: a 256-row buffer, the good side a prefix of
    ``live[0]`` rows, the bad side the next ``live[1]``."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(size=(c, d)).astype(np.float32)).to(dev)
    masks = torch.zeros((2, c), dtype=torch.float32, device=dev)
    masks[0, : live[0]] = 1.0
    masks[1, live[0]: live[0] + live[1]] = 1.0
    return x, masks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", required=True,
                        help="directory holding the checkout's hpbandster_tpu_torch")
    parser.add_argument("--label", default=None, help="name printed with every line")
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    label = args.label or root.name

    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from hpbandster_tpu_torch.ops import _build, cuda_kde

    if not Path(cuda_kde.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {cuda_kde.__file__}, not the checkout at {root}")
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    with ThreadPoolExecutor(max_workers=2) as pool:
        list(pool.map(_build.load_library, ("kde_score", "kde_moments")))

    # the scorer at the main paths' largest launches
    score_cases = {
        "score_static_5184_7+8": dict(s=5184, n_good=7, n_bad=8),
        "score_chunked_5184_256+256_7/8_live": dict(s=5184, n_good=256, n_bad=256,
                                                    good_live=7, bad_live=8),
    }
    for i, (name, kw) in enumerate(score_cases.items()):
        cands, good, bad, vt, cards = smoke._score_inputs(
            torch, dev, 300 + i, vartypes=[0] * 6, cards=[0] * 6, **kw)
        host = {}
        for dtype in (torch.int32, torch.float32):
            v, c = vt.to(dtype), cards.to(dtype)
            host[str(dtype).split(".")[-1]] = smoke._host_ms(
                lambda: cuda_kde.score_candidates(cands, good, bad, v, c), torch)
        _emit(label, "host", dict(case=name, host_ms=host))
        vf, cf = vt.float(), cards.float()
        call = lambda: cuda_kde.score_candidates(cands, good, bad, vf, cf)  # noqa: E731
        _emit(label, "device", dict(case=name, ms=smoke._median_ms(call, torch),
                                    **_per_call(torch, smoke, call)))

    # the fit at the chunked path's launch: moments alone and the bandwidths
    x, masks = _fit_inputs(torch, dev)
    cards = torch.zeros(6, dtype=torch.int32, device=dev)
    host = {}
    for dtype in (torch.int32, torch.float32):
        c = cards.to(dtype)
        host[str(dtype).split(".")[-1]] = smoke._host_ms(
            lambda: cuda_kde.moment_bandwidths(x, masks, c, smoke.MIN_BANDWIDTH), torch)
    host["masked_moments"] = smoke._host_ms(lambda: cuda_kde.masked_moments(x, masks), torch)
    _emit(label, "host", dict(case="fit_256_d6_7/17_live", host_ms=host))
    cf = cards.float()
    calls = {
        "masked_moments": lambda: cuda_kde.masked_moments(x, masks),
        "moment_bandwidths": lambda: cuda_kde.moment_bandwidths(
            x, masks, cf, smoke.MIN_BANDWIDTH),
    }
    for what, call in calls.items():
        _emit(label, "device", dict(case=f"fit_256_d6_7/17_live {what}",
                                    ms=smoke._median_ms(call, torch),
                                    **_per_call(torch, smoke, call)))

    # the moments at the scale checks
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    for name, seed, c, card_list, frac in smoke.MOMENTS_CASES[:2]:
        data, m = smoke.moments_inputs(torch, dev, seed, c, card_list, frac)
        cf = torch.as_tensor(card_list, dtype=torch.float32, device=dev)
        for what, call in (
            ("masked_moments", lambda: cuda_kde.masked_moments(data, m)),
            ("moment_bandwidths", lambda: cuda_kde.moment_bandwidths(
                data, m, cf, smoke.MIN_BANDWIDTH)),
        ):
            warm = _per_call(torch, smoke, call)
            cold = _per_call(torch, smoke, call, flush=flush)
            _emit(label, "moments_scale", dict(
                case=f"{name} {what}", warm_all_ms=warm["all_ms"],
                warm_moments_ms=sum(ms * n for k, (ms, n) in warm["kernels"].items()
                                    if "moments" in k),
                cold_moments_ms=cold["all_ms"], warm_span_ms=warm["span_ms"],
                cold_span_ms=cold["span_ms"], warm_kernels=warm["kernels"],
                cold_kernels=cold["kernels"],
                bound_ms=smoke.bound_ms(*smoke.kde_moments_work(data, m))[0]))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
