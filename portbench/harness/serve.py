"""The serving tier (``"driver": "portbench.harness.serve:run"``, with
``"arrivals"`` ``open`` or ``closed``): each request is one drop-in
``BOHB`` sweep of a few brackets over a shared ``ServePool``'s executor
facade for its tenant.

Set-up makes the pool, announces the schedule's brackets
(``ServePool.prepare``), waits for the bucket programs, and serves the
cell's own request mix twice on seeds the window does not use (a burst of
every tenant at once, then one at a time), so the packed and solo programs
and the model's shapes are built before the window opens.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench.harness import check, traffic
from portbench.harness.manifest import load_callable
from portbench.harness.trace import GCWatch, Stretch, collect_setup_garbage, span

#: seconds past the window's close that a request may still take
LATE_S = 60.0
#: the share of requests whose Results the check reads (drawn from the seed;
#: the rest are counted and dropped, as a serving tier would drop them)
KEEP_P = 0.125
#: the pool's ``serve.queue_wait_s`` histogram, registered before the pool
#: is built: 0.1 ms buckets to 1 s, then 1% steps to 10 minutes, so that a
#: percentile read from it is the waits' own to 0.1 ms (the registry's
#: default buckets, 10 and 50 ms apart there, would decide it instead)
WAIT_BUCKETS = tuple(np.unique(np.round(np.concatenate(
    [np.arange(1, 10001) * 1e-4, np.geomspace(1.0, 600.0, 645)]), 6)).tolist())


def _hist(snapshot, name):
    h = snapshot["histograms"].get(name)
    return None if h is None else dict(h["buckets"])


def _delta(after, before):
    if after is None:
        return None
    before = before or {}
    return {k: v - before.get(k, 0) for k, v in after.items()}


def run(spec: Dict[str, Any], seed: int, seconds: float, trace: bool, device,
        on_window=lambda: None) -> Dict[str, Any]:
    from hpbandster_tpu_torch import obs
    from hpbandster_tpu_torch.ops import graphs
    from hpbandster_tpu_torch.ops.bracket import hyperband_bracket
    from hpbandster_tpu_torch.optimizers import BOHB
    from hpbandster_tpu_torch.parallel import VmapBackend
    from hpbandster_tpu_torch.serve import ServePool

    cfg, tr = spec["config_data"], spec["traffic"]
    if tr["arrivals"] not in ("open", "closed"):
        raise ValueError(f"arrivals must be open or closed, got {tr['arrivals']!r}")
    settings, dims = cfg["optimizer"], cfg["space"]
    space = load_callable(cfg["objective"]["space"])(seed=0)
    if space.get_hyperparameter_names() != [d["name"] for d in dims]:
        raise ValueError("the configuration's dimensions are not the port space's order")
    eval_fn = load_callable(cfg["objective"]["port"])
    waits = obs.get_metrics().histogram("serve.queue_wait_s", WAIT_BUCKETS)
    fine_waits = waits.bounds == tuple(sorted(WAIT_BUCKETS))
    pool = ServePool(VmapBackend(eval_fn, device=device), space, **cfg["pool"])
    sizes = [int(k) for k in tr["brackets"]]
    lo, hi, eta = settings["min_budget"], settings["max_budget"], settings["eta"]
    pool.prepare([hyperband_bracket(i, lo, hi, eta) for i in range(max(sizes))])
    if pool.precompile is not None:
        pool.precompile.wait(600)

    results: Dict[int, Any] = {}
    done: Dict[int, float] = {}
    evals: Dict[int, int] = {}
    errors: Dict[int, str] = {}
    keep = (np.random.default_rng(traffic.sweep_seeds(seed, 1, stream=4)[0])
            .random(100000) < KEEP_P)

    def serve_one(req) -> None:
        try:
            with span("request"):
                opt = BOHB(configspace=space, run_id=f"r{req.index}", tenant_id=req.tenant,
                           executor=pool.executor_for(req.tenant), seed=req.seed,
                           device=device, **settings)
                try:
                    res = opt.run(n_iterations=req.brackets)
                finally:
                    opt.shutdown()
                    pool.release_tenant(req.tenant)
            done[req.index] = time.perf_counter()
            evals[req.index] = len(res.get_all_runs())
            if req.index >= len(keep) or keep[req.index]:
                results[req.index] = res
        except Exception as e:  # a failed request is counted, never lost
            errors[req.index] = f"{type(e).__name__}: {e}"

    def burst(reqs) -> List[threading.Thread]:
        ths = [threading.Thread(target=serve_one, args=(r,), daemon=True) for r in reqs]
        for t in ths:
            t.start()
        return ths

    # set-up: the cell's mix on stream-0 seeds, all tenants at once, then in turn
    tenants = int(tr["tenants"])
    warm = traffic.closed_requests(tr, traffic.sweep_seeds(seed, 1, stream=0)[0],
                                   max(tenants, len(sizes)) * 2)
    for t in burst(warm):
        t.join(300)
    for r in warm[:len(sizes)]:
        serve_one(r)
    if errors:
        raise RuntimeError(f"set-up requests failed: {sorted(errors.values())[:3]}")
    results.clear(), done.clear(), evals.clear(), errors.clear()
    if trace:
        pool._run_items = _spanned(pool._run_items, "dispatch")
    stretch = Stretch(device) if trace else None
    if trace:
        stretch.warm()

    open_loop = tr["arrivals"] == "open"
    reqs = (traffic.open_requests(tr, seed, seconds) if open_loop
            else traffic.closed_requests(tr, seed, 100000))
    snap0 = obs.get_metrics().snapshot()
    disp0 = dict(pool.dispatches)
    captures0 = sum(graphs.CAPTURES.values())
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    collect_setup_garbage()
    on_window()
    gcw = GCWatch().__enter__()
    t0 = time.perf_counter()
    sent: Dict[int, float] = {}
    if open_loop:
        start_at = len(reqs) // 4
        threads = []
        for r in reqs:
            delay = t0 + r.due_s - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            if trace and r.index == start_at:
                stretch.start()
            sent[r.index] = t0 + r.due_s
            threads += burst([r])
        for t in threads:
            t.join(max(t0 + seconds + LATE_S - time.perf_counter(), 0.0))
        if trace:
            stretch.stop()
    else:
        i = 0
        while True:
            if trace and not stretch.started and time.perf_counter() - t0 >= seconds / 4:
                stretch.start()
            sent[i] = time.perf_counter()
            serve_one(reqs[i])
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        reqs = reqs[:i]
        if trace:
            stretch.stop()
    t1 = max(done.values(), default=time.perf_counter())
    gcw.__exit__()
    snap1 = obs.get_metrics().snapshot()
    out: Dict[str, Any] = {"t0": t0, "t1": t1, "attempted": len(reqs), "gc": gcw.line(),
                           "window_captures": sum(graphs.CAPTURES.values()) - captures0}
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_reserved(device)
                                   if torch.device(device).type == "cuda" else 0)
    lat = [done[r.index] - sent[r.index] for r in reqs if r.index in done]
    missing = [r.index for r in reqs if r.index not in done]
    out["failed"] = len(missing)
    out["errors"] = [errors.get(i, "never finished") for i in missing][:5]
    out["latency_s"] = lat
    exs = {r.index: check.extract(results[r.index], dims) for r in reqs if r.index in results}
    out["evals"] = sum(evals.values())

    numbers = {"failed": len(missing), "loss_gap": 0.0, "schedule_mismatch": 0,
               "promotion_mismatch": 0, "model_budget_mismatch": 0, "lg_score_gap": 0.0}
    ref_dev = torch.device(device)
    ref_fn = load_callable(cfg["objective"]["reference"])
    by_index = {r.index: r for r in reqs}
    for i, e in exs.items():
        numbers["loss_gap"] = max(numbers["loss_gap"],
                                  check.loss_gap(e["run_loss"], check.losses(e, ref_fn)))
        k = by_index[i].brackets
        for key, v in check.schedule_and_promotions(e, k, settings).items():
            numbers[key] += v
        m = check.host_model(e, k, settings, dims, ref_dev)
        numbers["model_budget_mismatch"] += m["model_budget_mismatch"]
        numbers["lg_score_gap"] = max(numbers["lg_score_gap"], m["lg_score_gap"])
    out["numbers"] = numbers
    out["control_inputs"] = {"exs": exs, "sizes": {i: by_index[i].brackets for i in exs},
                             "settings": settings, "dims": dims, "device": ref_dev}
    if trace:
        out["ctx"] = {
            "tier": "serve", "window_s": t1 - t0, "trace": stretch.reduce(), "latency_s": lat,
            "queue_wait_buckets": (_delta(_hist(snap1, "serve.queue_wait_s"),
                                          _hist(snap0, "serve.queue_wait_s"))
                                   if fine_waits else None),
            "dispatches": {k: v - disp0.get(k, 0) for k, v in pool.dispatches.items()},
        }
    return out


def _spanned(fn, name):
    def wrapped(*a, **kw):
        with span(name):
            return fn(*a, **kw)
    return wrapped
