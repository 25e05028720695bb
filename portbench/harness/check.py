"""What decides ``correct``: the program's outputs read from its
``Result`` objects (and, for a fused sweep's proposals, the scorer's
recorded inputs), held against the plain reference (``reference/``).

Every number compared is a gap or a count with a limit of its own, from
the configuration's ``limits``. The control (``control.py``) computes the
same numbers with the reference, in bfloat16, in the program's place.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Any, Dict, Sequence

import numpy as np
import torch

from portbench.reference import hyperband, kde


# ----------------------------------------------------------------- reading
def unit_vectors(configs: Sequence[Dict[str, float]], dims: Sequence[Dict[str, Any]]) -> np.ndarray:
    """Configuration dicts -> unit-hypercube vectors (float64), in the
    configuration file's dimension order."""
    lo = np.array([d["lower"] for d in dims], np.float64)
    hi = np.array([d["upper"] for d in dims], np.float64)
    vals = np.array([[c[d["name"]] for d in dims] for c in configs], np.float64)
    return (vals - lo) / (hi - lo)


def extract(res, dims) -> Dict[str, Any]:
    """A ``Result`` as arrays: configuration ids, unit vectors and infos,
    and every run as (configuration row, budget, loss)."""
    id2c = res.get_id2config_mapping()
    cids = sorted(id2c)
    row = {cid: i for i, cid in enumerate(cids)}
    runs = res.get_all_runs()
    return {
        "cids": [tuple(c) for c in cids],
        "vec": unit_vectors([id2c[c]["config"] for c in cids], dims),
        "info": [dict(id2c[c].get("config_info") or {}) for c in cids],
        "run_row": np.array([row[tuple(r.config_id)] for r in runs], np.int64),
        "run_budget": np.array([float(r.budget) for r in runs], np.float64),
        "run_loss": np.array([math.nan if r.loss is None else float(r.loss)
                              for r in runs], np.float64),
    }


def _bracket_of(ex) -> np.ndarray:
    return np.array([c[0] for c in ex["cids"]], np.int64)


# ------------------------------------------------------------- the numbers
def schedule_and_promotions(ex, n_brackets: int, settings) -> Dict[str, int]:
    """Runs per (bracket, budget) against HyperBand's schedule, and every
    rung's promotions against the top-k of its losses: counts of (bracket,
    rung) pairs that differ, and of runs outside the schedule."""
    lo, hi, eta = settings["min_budget"], settings["max_budget"], settings["eta"]
    bracket_of = _bracket_of(ex)[ex["run_row"]]
    sched = prom = 0
    seen = set(np.unique(bracket_of).tolist())
    sched += len(seen - set(range(n_brackets)))
    for b in range(n_brackets):
        ns, bs = hyperband.bracket(b, lo, hi, eta)
        mine = bracket_of == b
        rungs = []
        for k, budget in zip(ns, bs):
            at = mine & np.isclose(ex["run_budget"], budget)
            rows = ex["run_row"][at]
            if len(rows) != k:
                sched += 1
            rungs.append(dict(zip(rows.tolist(), ex["run_loss"][at].tolist())))
        extra = int(mine.sum()) - sum(len(r) for r in rungs)
        sched += extra != 0
        for r in range(len(rungs) - 1):
            if hyperband.promoted(rungs[r], ns[r + 1]) != set(rungs[r + 1]):
                prom += 1
    return {"schedule_mismatch": int(sched), "promotion_mismatch": int(prom)}


def losses(ex, ref_fn, dtype=torch.float64) -> np.ndarray:
    """The reference objective's (``ref_fn(vectors, budgets)``) loss of
    every run, computed in ``dtype``."""
    v = torch.as_tensor(ex["vec"][ex["run_row"]], dtype=torch.float64).to(dtype)
    b = torch.as_tensor(ex["run_budget"], dtype=torch.float64)
    return ref_fn(v, b).to(torch.float64).numpy()


def loss_gap(program: np.ndarray, reference: np.ndarray) -> float:
    """The widest gap between a run's loss and the reference's (a crash
    where the reference has a loss is an infinite gap)."""
    if len(program) == 0:
        return 0.0
    gap = np.abs(program - reference)
    return float(np.max(np.where(np.isfinite(gap), gap, np.inf)))


def obs_before(ex, bracket: int):
    """Per budget, the (vectors, losses) of the runs of earlier brackets."""
    rows = ex["run_row"]
    earlier = _bracket_of(ex)[rows] < bracket
    out = {}
    for b in np.unique(ex["run_budget"][earlier]):
        at = earlier & (ex["run_budget"] == b)
        out[float(b)] = (ex["vec"][rows[at]], ex["run_loss"][at])
    return out


def _model_fit(obs, d, settings, device, dtype):
    """The reference's model for a bracket: (budget, n, good, bad,
    bandwidths) or None while no gate is open."""
    counts = {b: len(l) for b, (_, l) in obs.items()}
    mp = settings.get("min_points_in_model") or d + 1
    mp = max(int(mp), d + 1)
    b = kde.model_budget(counts, d, mp, settings["top_n_percent"])
    if b is None:
        return None
    good, bad = kde.split(*obs[b], d, mp, settings["top_n_percent"])
    g = torch.as_tensor(good, dtype=torch.float64, device=device).to(dtype)
    h = torch.as_tensor(bad, dtype=torch.float64, device=device).to(dtype)
    mb = settings["min_bandwidth"]
    return b, counts[b], good, bad, g, h, kde.bandwidths(g, mb), kde.bandwidths(h, mb)


def _rows(a: np.ndarray) -> Counter:
    return Counter(map(bytes, np.ascontiguousarray(a, np.float32)))


def fused_model(ex, records, settings, dims, dtype=torch.float64) -> Dict[str, float]:
    """A fused sweep's model, bracket by bracket, against the scorer's
    recorded inputs of that sweep (one launch per bracket, in bracket
    order): the good and bad rows the fit kept, their bandwidths, and each
    model pick against the best of its own candidates by the reference's
    score. With ``dtype`` below float64 the reference's bandwidths and
    picks stand in for the program's (the control)."""
    d = len(dims)
    split_mm, bw_gap, pick_gap = 0, 0.0, 0.0
    stage0 = [[i for i, c in enumerate(ex["cids"]) if c[0] == j and c[1] == 0]
              for j in range(len(records))]
    for j, rec in enumerate(records):
        cands, good_p, bad_p = rec[0], rec[1], rec[2]
        picks = [i for i in stage0[j] if ex["info"][i].get("model_based_pick")]
        dev = cands.device
        fit = _model_fit(obs_before(ex, j), d, settings, dev, torch.float64)
        if fit is None:
            split_mm += len(picks)
            continue
        _, _, good, bad, g, h, bw_g, bw_b = fit
        if dtype == torch.float64:
            for kde_p, ref in ((good_p, good), (bad_p, bad)):
                live = kde_p.data[kde_p.mask > 0].detach().cpu().numpy()
                split_mm += sum(((_rows(live) - _rows(ref)) + (_rows(ref) - _rows(live))).values())
            prog_bw = (good_p.bw.detach().to(torch.float64), bad_p.bw.detach().to(torch.float64))
        else:
            prog_bw = (kde.bandwidths(g.to(dtype), settings["min_bandwidth"]).to(torch.float64),
                       kde.bandwidths(h.to(dtype), settings["min_bandwidth"]).to(torch.float64))
        for p, r in zip(prog_bw, (bw_g, bw_b)):
            bw_gap = max(bw_gap, float(((p - r).abs() / r).max()))
        if not picks:
            continue
        n0 = len(stage0[j])
        per = cands.shape[0] // n0
        c64 = cands.detach().to(torch.float64)
        for i in picks:
            k = ex["cids"][i][2]
            blk = c64[k * per:(k + 1) * per]
            ref_s = kde.scores(blk, g, h, bw_g, bw_b)
            if dtype == torch.float64:
                v = torch.as_tensor(ex["vec"][i], dtype=torch.float64, device=dev)
                dist, r = (blk - v).abs().max(dim=1).values.min(dim=0)
                if float(dist) > 1e-6:
                    pick_gap = math.inf
                    continue
            else:
                low = kde.scores(blk.to(dtype), g.to(dtype), h.to(dtype),
                                 bw_g.to(dtype), bw_b.to(dtype))
                r = torch.argmax(low.to(torch.float64))
            pick_gap = max(pick_gap, float(ref_s.max() - ref_s[r]))
    return {"kde_split_mismatch": int(split_mm), "kde_bandwidth_gap": bw_gap,
            "pick_score_gap": pick_gap}


def host_model(ex, n_brackets, settings, dims, device, dtype=torch.float64) -> Dict[str, float]:
    """The Master-driven model of one request: each model pick's budget and
    point count against the reference's, and its recorded score
    (``lg_score``, the scorer's output for the chosen candidate) against
    the reference's score of that configuration. With ``dtype`` below
    float64 the reference's score in that dtype stands in for the
    program's (the control)."""
    d = len(dims)
    mm, gap = 0, 0.0
    for j in range(1, n_brackets):
        picks = [i for i, c in enumerate(ex["cids"])
                 if c[0] == j and c[1] == 0 and ex["info"][i].get("model_based_pick")]
        if not picks:
            continue
        fit = _model_fit(obs_before(ex, j), d, settings, device, torch.float64)
        if fit is None:
            mm += len(picks)
            continue
        b, n, _, _, g, h, bw_g, bw_b = fit
        x = torch.as_tensor(ex["vec"][picks], dtype=torch.float64, device=device)
        ref = kde.scores(x, g, h, bw_g, bw_b)
        if dtype == torch.float64:
            prog = torch.tensor([ex["info"][i].get("lg_score", math.nan) for i in picks],
                                dtype=torch.float64, device=device)
            for i in picks:
                info = ex["info"][i]
                mm += (info.get("model_budget") != b) or (info.get("n_points_in_model") != n)
        else:
            prog = kde.scores(x.to(dtype), g.to(dtype), h.to(dtype), bw_g.to(dtype),
                              bw_b.to(dtype)).to(torch.float64)
        rel = (prog - ref).abs() / ref.abs().clamp(min=1.0)
        gap = max(gap, float(torch.nan_to_num(rel, nan=math.inf).max()))
    return {"model_budget_mismatch": int(mm), "lg_score_gap": gap}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each number beside its limit; ``correct`` is every number at or
    under its limit (a number without a limit fails)."""
    return {k: {"value": v, "limit": limits.get(k, -math.inf)} for k, v in numbers.items()}


def passed(judged: Dict[str, Dict[str, float]]) -> bool:
    return all(j["value"] <= j["limit"] for j in judged.values())
