"""The fused whole-sweep tier (``"driver": "portbench.harness.fused:run"``):
back-to-back ``FusedBOHB.run()`` sweeps, one fresh optimizer per sweep.

Set-up runs one sweep of the cell's own schedule on a seed the window does
not use: it builds the kernels (or loads them from the checkout's kernel
cache) and captures every chunk's CUDA graph into the port's sweep cache,
so the window replays and never captures. With the model on, the scorer's
launches are recorded while they are captured (``cuda_kde.RECORD``): each
recorded input is a buffer of its graph and holds the values of the
graph's latest replay, which is how the check reads the candidates of the
window's last sweep.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from portbench.harness import check
from portbench.harness.manifest import load_callable
from portbench.harness.trace import GCWatch, Stretch, collect_setup_garbage, span
from portbench.harness.traffic import sweep_seeds
from portbench.reference import kde

#: the window's sweeps whose Results the check reads besides the last: two
#: in a row from a start drawn from the seed among the first four, so that
#: every run holds as many Results (and as much heap) as any other
KEEP, KEEP_FROM = 2, 4


def _recorded(cuda_kde, n: int):
    """The scorer's last ``n`` recorded launches (one per bracket)."""
    recs = [inputs for name, inputs in (cuda_kde.RECORD or []) if name == "kde_score"]
    if len(recs) < n:
        raise RuntimeError(f"expected {n} recorded kde_score launches, found {len(recs)}")
    return recs[-n:]


def run(spec: Dict[str, Any], seed: int, seconds: float, trace: bool, device,
        on_window=lambda: None) -> Dict[str, Any]:
    from hpbandster_tpu_torch import obs
    from hpbandster_tpu_torch.ops import cuda_kde, graphs

    cfg, tr = spec["config_data"], spec["traffic"]
    settings, dims = cfg["optimizer"], cfg["space"]
    space = load_callable(cfg["objective"]["space"])(seed=0)
    if space.get_hyperparameter_names() != [d["name"] for d in dims]:
        raise ValueError("the configuration's dimensions are not the port space's order")
    eval_fn = load_callable(cfg["objective"]["port"])
    cls = load_callable(tr["optimizer"])
    n_it, chunk = int(tr["n_iterations"]), int(tr["chunk_brackets"])
    replay_s = [0.0]

    def sweep(s: int):
        opt = cls(configspace=space, eval_fn=eval_fn, run_id="portbench", seed=s,
                  device=device, **settings)
        if trace:
            inner = opt._replay_bracket

            def timed(*a, **kw):
                t = time.perf_counter()
                with span("replay"):
                    inner(*a, **kw)
                replay_s[0] += time.perf_counter() - t

            opt._replay_bracket = timed
        with span("sweep"):
            return opt, opt.run(n_iterations=n_it, chunk_brackets=chunk)

    if tr["model"] and cuda_kde.RECORD is None:
        # a second run in one process (the control) finds its graphs cached
        # and their launches already recorded
        cuda_kde.RECORD = []
    sweep(sweep_seeds(seed, 1, stream=0)[0])
    stretch = Stretch(device) if trace else None
    if trace:
        stretch.warm()
    replay_s[0] = 0.0
    seeds = sweep_seeds(seed, 20000)
    k0 = int(np.random.default_rng(seeds[-1]).integers(KEEP_FROM))
    captures0 = sum(graphs.CAPTURES.values())
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    collect_setup_garbage()
    on_window()
    out: Dict[str, Any] = {"t0": time.perf_counter()}
    t0, k, evals, kept, per_sweep, durations = out["t0"], 0, 0, {}, [], []
    traced = None
    gcw = GCWatch().__enter__()
    while True:
        if trace and k == 1:
            stretch.start()
        t_sweep = time.perf_counter()
        opt, res = sweep(seeds[k])
        if trace and k == 1:
            stretch.stop()
            traced = res
        evals += int(opt.total_evaluated)
        if trace:
            per_sweep.append({"run_stats": list(opt.run_stats), "brackets": n_it,
                              "host_syncs": obs.get_metrics().snapshot()["gauges"].get(
                                  "sweep.host_syncs")})
        if k0 <= k < k0 + KEEP:
            kept[k] = res
        durations.append(time.perf_counter() - t_sweep)
        last, k = res, k + 1
        if time.perf_counter() - t0 >= seconds and (not trace or k >= 2):
            break
    out["t1"] = time.perf_counter()
    gcw.__exit__()
    out["gc"] = gcw.line()
    out.update(attempted=k, failed=0, evals=evals, durations_s=durations,
               window_captures=sum(graphs.CAPTURES.values()) - captures0)
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_reserved(device)
                                   if torch.device(device).type == "cuda" else 0)
    records = _recorded(cuda_kde, n_it) if tr["model"] else None
    del opt

    exs = ([check.extract(r, dims) for i, r in kept.items() if i != k - 1]
           + [check.extract(last, dims)])
    prog = np.concatenate([e["run_loss"] for e in exs])
    ref_fn = load_callable(cfg["objective"]["reference"])
    ref = np.concatenate([check.losses(e, ref_fn) for e in exs])
    numbers = {"loss_gap": check.loss_gap(prog, ref)}
    for e in exs:
        for key, v in check.schedule_and_promotions(e, n_it, settings).items():
            numbers[key] = numbers.get(key, 0) + v
    if tr["model"]:
        numbers.update(check.fused_model(exs[-1], records, settings, dims))
    else:
        numbers["model_picks"] = sum(bool(i.get("model_based_pick")) for e in exs
                                     for i in e["info"])
    out["numbers"] = numbers
    out["control_inputs"] = {"exs": exs, "records": records, "settings": settings, "dims": dims}

    if trace:
        ctx = {"tier": "fused", "window_s": out["t1"] - t0, "sweeps": per_sweep,
               "replay_s": replay_s[0], "trace": stretch.reduce()}
        if tr["model"]:
            ex_t = check.extract(traced, dims)
            ctx["kde_launches"] = kde_launches(ex_t, records, settings, len(dims))
        out["ctx"] = ctx
    return out


def kde_launches(ex, records, settings, d: int):
    """Each scorer launch of one sweep, one per bracket: its shapes (from
    the recorded inputs) and the rows live in it (from the sweep's own
    Result, by the reference's budget and split rule)."""
    mp = max(int(settings.get("min_points_in_model") or d + 1), d + 1)
    out = []
    for j, rec in enumerate(records):
        counts = {b: len(l) for b, (_, l) in check.obs_before(ex, j).items()}
        b = kde.model_budget(counts, d, mp, settings["top_n_percent"])
        live = (0, 0) if b is None else kde.split_sizes(counts[b], d, mp,
                                                         settings["top_n_percent"])
        out.append({"s": int(rec[0].shape[0]), "d": int(rec[0].shape[1]),
                    "n_good": int(rec[1].data.shape[0]), "n_bad": int(rec[2].data.shape[0]),
                    "live_good": int(live[0]), "live_bad": int(live[1])})
    return out
