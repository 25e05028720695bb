"""The fused whole-sweep tier on a space of continuous and categorical dims
(``"driver": "portbench.harness.fused_mixed:run"``).

The window is ``fused.run``'s, run with its Gaussian model check off:
back-to-back ``FusedBOHB.run()`` sweeps, one fresh optimizer each, set-up
capturing every chunk's graph. The mixed model check takes its place:
``fused.run`` reads the scorer's inputs from one captured launch a
bracket, which holds only where every chunk captures a graph of its own;
where chunks of equal shapes share a cached graph, its recorded inputs
keep only its latest replay. So after the window the last sweep runs again on its seed with the sweep cache bypassed (:func:`twin`),
and the check reads that twin, which must equal the window's sweep
(``twin_mismatch``), holding its model against ``reference/mixed_kde.py``.
A traced run adds what this tier's readers take: the window's change in
the bulk decode's counters (``space.decode_rows``, ``space.decode_s``) and
in the scorer's launches by kernel width (``kde.score_launches.<width>``),
and the twin's launches, whose shapes and live rows the schedule fixes.

The cell's bfloat16 control, the reference computed in bfloat16 in the
program's place, runs from here too:

    python -m portbench.harness.fused_mixed --workload <cell> --seeds 1 2 3 --seconds 4

One JSON line per seed on standard output (``program``, ``control``).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from portbench.harness import check, fused, manifest
from portbench.harness.manifest import load_callable
from portbench.harness.traffic import sweep_seeds
from portbench.reference import kde, mixed_kde

LOW = torch.bfloat16
#: counter prefixes the traced window's change is taken of
COUNTERS = ("space.decode_", "kde.score_launches.")


def cards_of(dims) -> List[int]:
    """Choices per dimension of the configuration file (0: continuous)."""
    return [len(d["choices"]) if "choices" in d else 0 for d in dims]


def _fit(obs, d, settings, cards, device):
    """The reference's model for a bracket: (good, bad, their float64
    tensors, their bandwidths) or None while no gate is open."""
    counts = {b: len(l) for b, (_, l) in obs.items()}
    mp = max(int(settings.get("min_points_in_model") or d + 1), d + 1)
    b = kde.model_budget(counts, d, mp, settings["top_n_percent"])
    if b is None:
        return None
    good, bad = kde.split(*obs[b], d, mp, settings["top_n_percent"])
    g = torch.as_tensor(good, dtype=torch.float64, device=device)
    h = torch.as_tensor(bad, dtype=torch.float64, device=device)
    mb = settings["min_bandwidth"]
    return (good, bad, g, h, mixed_kde.bandwidths(g, cards, mb),
            mixed_kde.bandwidths(h, cards, mb))


def fused_model(ex, records, settings, dims, dtype=torch.float64) -> Dict[str, float]:
    """``check.fused_model`` on a mixed space: each bracket's good and bad
    rows against the scorer's recorded inputs, their bandwidths, and each
    model pick against the best of its own candidates, by the mixed
    reference. With ``dtype`` below float64 the reference's bandwidths and
    picks in that dtype stand in for the program's (the control)."""
    d, cards, mb = len(dims), cards_of(dims), settings["min_bandwidth"]
    split_mm, bw_gap, pick_gap = 0, 0.0, 0.0
    stage0 = [[i for i, c in enumerate(ex["cids"]) if c[0] == j and c[1] == 0]
              for j in range(len(records))]
    for j, rec in enumerate(records):
        cands, good_p, bad_p = rec[0], rec[1], rec[2]
        picks = [i for i in stage0[j] if ex["info"][i].get("model_based_pick")]
        dev = cands.device
        fit = _fit(check.obs_before(ex, j), d, settings, cards, dev)
        if fit is None:
            split_mm += len(picks)
            continue
        good, bad, g, h, bw_g, bw_b = fit
        if dtype == torch.float64:
            for kde_p, ref in ((good_p, good), (bad_p, bad)):
                live = kde_p.data[kde_p.mask > 0].detach().cpu().numpy()
                split_mm += sum(((check._rows(live) - check._rows(ref))
                                 + (check._rows(ref) - check._rows(live))).values())
            prog_bw = (good_p.bw.detach().to(torch.float64), bad_p.bw.detach().to(torch.float64))
        else:
            prog_bw = tuple(mixed_kde.bandwidths(x.to(dtype), cards, mb).to(torch.float64)
                            for x in (g, h))
        for p, r in zip(prog_bw, (bw_g, bw_b)):
            bw_gap = max(bw_gap, float(((p - r).abs() / r).max()))
        if not picks:
            continue
        per = cands.shape[0] // len(stage0[j])
        c64 = cands.detach().to(torch.float64)
        for i in picks:
            k = ex["cids"][i][2]
            blk = c64[k * per:(k + 1) * per]
            ref_s = mixed_kde.scores(blk, g, h, bw_g, bw_b, cards)
            if dtype == torch.float64:
                v = torch.as_tensor(ex["vec"][i], dtype=torch.float64, device=dev)
                dist, r = (blk - v).abs().max(dim=1).values.min(dim=0)
                if float(dist) > 1e-6:
                    pick_gap = math.inf
                    continue
            else:
                low = mixed_kde.scores(blk.to(dtype), g.to(dtype), h.to(dtype),
                                       bw_g.to(dtype), bw_b.to(dtype), cards)
                r = torch.argmax(low.to(torch.float64))
            pick_gap = max(pick_gap, float(ref_s.max() - ref_s[r]))
    return {"kde_split_mismatch": int(split_mm), "kde_bandwidth_gap": bw_gap,
            "pick_score_gap": pick_gap}


def _counters() -> Dict[str, float]:
    from hpbandster_tpu_torch import obs

    snap = obs.get_metrics().snapshot()["counters"]
    return {k: v for k, v in snap.items() if k.startswith(COUNTERS)}


class _NeverHit:
    """A sweep cache that never hits and keeps every entry: each chunk of
    the twin captures a graph of its own."""

    def __init__(self):
        self.entries = []

    def get(self, key, default=None):
        return default

    def put(self, key, value, **kw):
        self.entries.append(value)

    def clear(self):
        self.entries.clear()


def twin(sweep, seed: int, n_it: int):
    """The window's last sweep run again on its seed (``sweep``: seed ->
    Result), every chunk on a graph captured for it alone, with the
    scorer's launches recorded: ``(Result, records)``, one record a
    bracket, each holding the inputs of that bracket's launch. In the
    window chunks with equal shapes share one cached graph, whose recorded
    inputs hold only its latest replay's values."""
    from hpbandster_tpu_torch.ops import cuda_kde
    from hpbandster_tpu_torch.optimizers import fused_bohb

    cache, record = fused_bohb._SWEEP_CACHE, cuda_kde.RECORD
    fused_bohb._SWEEP_CACHE, cuda_kde.RECORD = _NeverHit(), []
    try:
        res = sweep(seed)
        records = [inputs for name, inputs in cuda_kde.RECORD if name == "kde_score"]
    finally:
        fused_bohb._SWEEP_CACHE, cuda_kde.RECORD = cache, record
    if len(records) != n_it:
        raise RuntimeError(f"expected {n_it} recorded kde_score launches, found {len(records)}")
    return res, records


def twin_mismatch(a, b) -> int:
    """Configurations and runs in which two extracted Results differ
    (vectors, model-pick flags; configuration, budget and loss of each
    run): 0 where the twin is the sweep it stands for."""
    if a["cids"] != b["cids"] or len(a["run_loss"]) != len(b["run_loss"]):
        return max(len(a["cids"]), 1)
    vec = ~((a["vec"] == b["vec"]) | (np.isnan(a["vec"]) & np.isnan(b["vec"]))).all(axis=1)
    pick = [bool(x.get("model_based_pick")) != bool(y.get("model_based_pick"))
            for x, y in zip(a["info"], b["info"])]
    loss = ~((a["run_loss"] == b["run_loss"])
             | (np.isnan(a["run_loss"]) & np.isnan(b["run_loss"])))
    runs = (a["run_row"] != b["run_row"]) | (a["run_budget"] != b["run_budget"]) | loss
    return int(vec.sum() + sum(pick) + runs.sum())


def run(spec: Dict[str, Any], seed: int, seconds: float, trace: bool, device,
        on_window=lambda: None) -> Dict[str, Any]:
    """``fused.run``'s window, then the mixed check on the last sweep's
    twin."""
    cfg, tr = spec["config_data"], spec["traffic"]
    settings, dims = cfg["optimizer"], cfg["space"]
    n_it = int(tr["n_iterations"])
    counters0: Dict[str, float] = {}

    def start():
        counters0.update(_counters())
        on_window()

    out = fused.run(dict(spec, traffic=dict(tr, model=False)), seed, seconds, trace, device,
                    on_window=start)
    # nothing after fused.run's window decodes or launches
    counters = {name: v - counters0.get(name, 0) for name, v in _counters().items()}
    if trace:
        out["ctx"]["counters"] = counters
        launches = {n: v for n, v in counters.items() if n.startswith("kde.score_launches.")}
        print(f"portbench: window kde_score launches by width {json.dumps(launches)}",
              file=sys.stderr)
    space = load_callable(cfg["objective"]["space"])(seed=0)
    eval_fn = load_callable(cfg["objective"]["port"])
    cls = load_callable(tr["optimizer"])

    def sweep(s: int):
        opt = cls(configspace=space, eval_fn=eval_fn, run_id="portbench", seed=s,
                  device=device, **settings)
        return opt.run(n_iterations=n_it, chunk_brackets=int(tr["chunk_brackets"]))

    # fused.run's k-th sweep runs on the k-th of these seeds
    last_seed = sweep_seeds(seed, 20000)[out["attempted"] - 1]
    res_twin, records = twin(sweep, last_seed, n_it)
    ex_twin = check.extract(res_twin, dims)
    exs = out["control_inputs"]["exs"]
    numbers = out["numbers"]
    del numbers["model_picks"]
    numbers["twin_mismatch"] = twin_mismatch(exs[-1], ex_twin)
    numbers.update(fused_model(ex_twin, records, settings, dims))
    out["control_inputs"] = {"exs": exs[:-1] + [ex_twin], "records": records,
                             "settings": settings, "dims": dims}
    if trace:
        out["ctx"]["kde_launches"] = fused.kde_launches(ex_twin, records, settings, len(dims))
    return out


def control_numbers(spec: Dict[str, Any], inputs: Dict[str, Any]) -> Dict[str, float]:
    """The numbers the check compares, with the reference in ``LOW`` in
    the program's place."""
    ref_fn = load_callable(spec["config_data"]["objective"]["reference"])
    exs = inputs["exs"]
    out = {"loss_gap": max(check.loss_gap(check.losses(e, ref_fn, LOW), check.losses(e, ref_fn))
                           for e in exs)}
    m = fused_model(exs[-1], inputs["records"], inputs["settings"], inputs["dims"], LOW)
    out.update(kde_bandwidth_gap=m["kde_bandwidth_gap"], pick_score_gap=m["pick_score_gap"])
    return out


def main(argv: Optional[List[str]] = None, device: Optional[str] = None) -> int:
    from portbench.run import pin_environment

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    spec = manifest.resolve(args.workload)
    pin_environment(spec["config_data"])
    if device is None:
        if not torch.cuda.is_available():
            print("portbench.harness.fused_mixed: no CUDA card", file=sys.stderr)
            return 2
        device = "cuda:0"
    for seed in args.seeds:
        out = run(spec, seed, args.seconds, False, device)
        line = {"workload": args.workload, "seed": seed, "attempted": out["attempted"],
                "failed": out["failed"], "program": out["numbers"],
                "control": control_numbers(spec, out["control_inputs"])}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
