"""Device metrics plane, host half: the bin schema and the decoder of the
sweep's in-device telemetry.

Ported from ``hpbandster_tpu/obs/device_metrics.py`` (the port keeps its
own copy; it imports nothing of the JAX package): ``N_BINS``,
``LOG10_LO``/``LOG10_HI``, ``SCHEMA_VERSION``, ``device_metrics_default``,
``bin_edges``, ``bin_index_np``, ``hist_quantile``, ``finite_or_none``,
``_plan_shapes``, ``merge_rungs`` and ``decode_device_metrics``. The
device half is ``ops.sweep.DeviceMetrics``, accumulated per rung by
``ops.fused.stage_telemetry`` against :func:`bin_edges`.

Bin schema (``schema`` version 1): bin 0 holds every loss at or below
``10**LOG10_LO`` (zeros and negatives included); bins ``1..N_BINS-2``
are log-spaced up to ``10**LOG10_HI``; bin ``N_BINS-1`` is the +inf
overflow. A loss equal to a bin's upper bound lands IN that bin
(``bisect_left``). NaN (crashed) losses are never histogrammed; they are
counted in the crash counters. Quantiles decode as bucket upper bounds;
a quantile landing in the overflow bin decodes as None.

The reference's ``publish_device_metrics`` and ``emit_device_telemetry``
feed its observability bus, which the port has not yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "N_BINS",
    "LOG10_LO",
    "LOG10_HI",
    "SCHEMA_VERSION",
    "bin_edges",
    "bin_index_np",
    "hist_quantile",
    "device_metrics_default",
    "decode_device_metrics",
    "merge_rungs",
    "finite_or_none",
]

#: total bin count, underflow (bin 0) and overflow (bin N_BINS-1) included
N_BINS = 32
#: log10 of bin 0's upper bound / of the last finite upper bound
LOG10_LO = -6.0
LOG10_HI = 6.0
#: decoded-record schema version (bump on any layout change so journal
#: readers can tell records apart)
SCHEMA_VERSION = 1


def device_metrics_default() -> bool:
    """Process default for the optimizers' ``device_metrics=None`` knob:
    ``HPB_DEVICE_METRICS=1`` turns the device telemetry on everywhere,
    any other value (or unset) leaves it off: telemetry adds device work,
    so the default is explicit and stable."""
    import os

    return os.environ.get("HPB_DEVICE_METRICS", "") == "1"


def bin_edges():
    """Ascending upper bounds of bins ``0..N_BINS-2`` (f64[N_BINS-1]) —
    THE schema definition. The device accumulator
    (``ops.fused.stage_telemetry``, on these edges as float32) and the
    host twin (:func:`bin_index_np`) both bin against exactly this
    array."""
    import numpy as np

    return np.logspace(LOG10_LO, LOG10_HI, N_BINS - 1)


def bin_index_np(losses) -> "Any":
    """Host twin of the in-trace binning: ``i64[n]`` bin index per loss
    (``searchsorted`` left, matching ``obs.metrics.Histogram``'s
    ``bisect_left``). NaN rows index the overflow bin — callers mask
    them out exactly like the device accumulator does."""
    import numpy as np

    losses = np.asarray(losses, np.float32)
    return np.minimum(
        np.searchsorted(bin_edges().astype(np.float32), losses, side="left"),
        N_BINS - 1,
    )


def hist_quantile(hist: Sequence[int], q: float) -> Optional[float]:
    """Conservative quantile from one bin-count vector: the upper bound
    of the bucket holding the q-quantile observation (the
    ``obs.metrics.Histogram`` convention). None when the histogram is
    empty or the quantile lands in the +inf overflow bin (no honest
    upper bound exists there)."""
    total = sum(int(c) for c in hist)
    if total <= 0:
        return None
    edges = bin_edges()
    rank = max(float(q), 0.0) * total
    acc = 0
    for i, c in enumerate(hist):
        acc += int(c)
        if acc >= rank and c:
            return float(edges[i]) if i < len(edges) else None
    return None


def finite_or_none(v: Any) -> Optional[float]:
    """Finite numeric or None; bools (a corrupt record's `true` loss)
    are not numbers."""
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        v = float(v)
        if v == v and v not in (float("inf"), float("-inf")):
            return v
    return None


def _plan_shapes(plans) -> List[Tuple[Tuple[int, ...], Tuple[float, ...]]]:
    """Normalize a plan sequence (BracketPlan or raw pairs) to hashable
    ``(num_configs, budgets)`` tuples — what decode keys rungs by."""
    out = []
    for p in plans:
        if hasattr(p, "num_configs"):
            out.append((
                tuple(int(n) for n in p.num_configs),
                tuple(float(b) for b in p.budgets),
            ))
        else:
            nc, bd = p
            out.append((
                tuple(int(n) for n in nc), tuple(float(b) for b in bd)
            ))
    return out


def merge_rungs(rung_lists: Sequence[Sequence[Dict[str, Any]]]) -> List[Dict[str, Any]]:
    """Fold several decoded records' ``rungs`` sections (same schema)
    into one per-budget aggregate — histograms sum bin-wise, quantiles
    recompute from the merged histogram. The one merge implementation
    readers of several records share."""
    by_budget: Dict[float, Dict[str, Any]] = {}
    for rungs in rung_lists:
        for r in rungs or []:
            b = finite_or_none(r.get("budget"))
            if b is None:
                continue
            slot = by_budget.setdefault(b, {
                "budget": b, "evals": 0, "crashes": 0, "promotions": 0,
                "hist": [0] * N_BINS,
            })
            for k in ("evals", "crashes", "promotions"):
                v = r.get(k)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    slot[k] += int(v)
            h = r.get("hist")
            if isinstance(h, (list, tuple)) and len(h) == N_BINS:
                slot["hist"] = [
                    a + int(c) for a, c in zip(slot["hist"], h)
                ]
    out = []
    for b in sorted(by_budget):
        slot = by_budget[b]
        slot["crash_rate"] = (
            round(slot["crashes"] / slot["evals"], 6)
            if slot["evals"] else None
        )
        slot["loss_p50"] = hist_quantile(slot["hist"], 0.50)
        slot["loss_p95"] = hist_quantile(slot["hist"], 0.95)
        out.append(slot)
    return out


def decode_device_metrics(
    parts,
    plans=None,
    execute_s: Optional[float] = None,
) -> Dict[str, Any]:
    """Fold fetched :class:`~hpbandster_tpu_torch.ops.sweep.DeviceMetrics`
    pytree(s) into ONE deterministic, JSON-safe record.

    ``parts`` is either a single metrics pytree (then ``plans`` names its
    bracket schedule) or a sequence of ``(metrics, plans)`` pairs — the
    chunked run decodes all chunks at once. Determinism is a hard
    contract (pinned by tests): the record derives only from the pytree
    values and plan shapes — two decodes of the same inputs are
    byte-identical.

    ``execute_s`` (the sweep's measured device seconds) additionally
    derives a per-budget evaluation-cost estimate (``est_cost_s`` per
    rung): device seconds split across rungs proportionally to
    ``evals x budget`` (the HyperBand cost model — budget IS the unit of
    evaluation work), divided by the rung's evaluations.
    """
    import numpy as np

    if plans is not None:
        parts = [(parts, plans)]
    parts = [
        (m, _plan_shapes(p)) for m, p in parts
    ]

    n_brackets = 0
    total = {"evals": 0, "crashes": 0, "promotions": 0, "model_fits": 0}
    by_budget: Dict[float, Dict[str, Any]] = {}
    per_bracket_best: List[Optional[float]] = []
    per_bracket_crashes: List[int] = []
    #: per-rung execution-order entries (the ``rung_seq`` stamp the
    #: device accumulator writes), assembled into the flat ``rung_order``
    #: list the flight recorder (obs/timeline.py) lays device rows from
    rung_order: List[Dict[str, Any]] = []
    seq_offset = 0

    def budget_slot(b: float) -> Dict[str, Any]:
        return by_budget.setdefault(float(b), {
            "budget": float(b), "evals": 0, "crashes": 0, "promotions": 0,
            "hist": [0] * N_BINS,
        })

    for part_i, (metrics, shapes) in enumerate(parts):
        hist = np.asarray(metrics.loss_hist)
        evals = np.asarray(metrics.evals)
        crashes = np.asarray(metrics.crashes)
        promos = np.asarray(metrics.promotions)
        fits = np.asarray(metrics.model_fits)
        best = np.asarray(metrics.best_final)
        # older pytrees (pre-rung_seq journals replayed through decode)
        # carry no stamp: synthesize bracket-major order, which is what
        # the unrolled sweep executes anyway
        seq = getattr(metrics, "rung_seq", None)
        seq = np.asarray(seq) if seq is not None else None
        if hist.shape[0] != len(shapes):
            raise ValueError(
                f"metrics carry {hist.shape[0]} brackets but the plan "
                f"schedule names {len(shapes)} — decode needs the exact "
                "schedule the sweep ran"
            )
        part_rungs = 0
        part_entries: List[Dict[str, Any]] = []
        for b_i, (num_configs, budgets) in enumerate(shapes):
            n_brackets += 1
            total["model_fits"] += int(fits[b_i])
            bracket_crashes = 0
            for s, budget in enumerate(budgets):
                slot = budget_slot(budget)
                slot["evals"] += int(evals[b_i, s])
                slot["crashes"] += int(crashes[b_i, s])
                slot["promotions"] += int(promos[b_i, s])
                slot["hist"] = [
                    a + int(c) for a, c in zip(slot["hist"], hist[b_i, s])
                ]
                total["evals"] += int(evals[b_i, s])
                total["crashes"] += int(crashes[b_i, s])
                total["promotions"] += int(promos[b_i, s])
                bracket_crashes += int(crashes[b_i, s])
                s_raw = int(seq[b_i, s]) if seq is not None else part_rungs
                if s_raw >= 0:
                    part_entries.append({
                        "seq": s_raw,
                        "bracket": n_brackets - 1,
                        "stage": s,
                        "budget": float(budget),
                        "evals": int(evals[b_i, s]),
                    })
                part_rungs += 1
            per_bracket_crashes.append(bracket_crashes)
            bf = float(best[b_i])
            per_bracket_best.append(
                round(bf, 6) if bf == bf and finite_or_none(bf) is not None
                else None
            )
        # stack parts in execution order: rebase each part's stamps to
        # its own minimum (a pytree SLICED out of a larger sweep keeps
        # the sweep-global stamps; a fresh chunk starts at 0 — both land
        # in the same place after the rebase), then offset by the rungs
        # already decoded so chunked decodes order globally
        if part_entries:
            part_min = min(e["seq"] for e in part_entries)
            for e in part_entries:
                e["seq"] = e["seq"] - part_min + seq_offset
            rung_order.extend(part_entries)
        seq_offset += part_rungs

    # running incumbent after each bracket (crashed/NaN bests never
    # improve it): the per-round improvement trail
    incumbent_after: List[Optional[float]] = []
    improvements = 0
    running: Optional[float] = None
    for bf in per_bracket_best:
        if bf is not None and (running is None or bf < running):
            running = bf
            improvements += 1
        incumbent_after.append(running)

    rungs = []
    # work split for the cost estimate: evals x budget per rung
    work_total = sum(
        slot["evals"] * b for b, slot in by_budget.items()
    )
    for b in sorted(by_budget):
        slot = by_budget[b]
        slot["crash_rate"] = (
            round(slot["crashes"] / slot["evals"], 6)
            if slot["evals"] else None
        )
        slot["loss_p50"] = hist_quantile(slot["hist"], 0.50)
        slot["loss_p95"] = hist_quantile(slot["hist"], 0.95)
        if (
            execute_s is not None and work_total > 0 and slot["evals"] > 0
        ):
            slot["est_cost_s"] = round(
                float(execute_s) * (slot["evals"] * b / work_total)
                / slot["evals"],
                9,
            )
        rungs.append(slot)

    # execution-order section: rungs sorted by the device stamp, each
    # carrying its estimated device-seconds slice (same evals x budget
    # work model as est_cost_s) so the timeline can lay the device row
    # out to scale without any per-rung host timing existing
    rung_order.sort(key=lambda r: (r["seq"], r["bracket"], r["stage"]))
    if execute_s is not None and work_total > 0:
        for r in rung_order:
            r["est_s"] = round(
                float(execute_s) * (r["evals"] * r["budget"] / work_total),
                9,
            )

    rec: Dict[str, Any] = {
        "schema": SCHEMA_VERSION,
        "n_bins": N_BINS,
        "brackets": n_brackets,
        "rounds_completed": n_brackets,
        "evaluations": total["evals"],
        "crashes": total["crashes"],
        "promotions": total["promotions"],
        "model_fits": total["model_fits"],
        "crash_rate": (
            round(total["crashes"] / total["evals"], 6)
            if total["evals"] else None
        ),
        "rungs": rungs,
        "rung_order": rung_order,
        "per_bracket_best": per_bracket_best,
        "per_bracket_crashes": per_bracket_crashes,
        "incumbent_after": incumbent_after,
        "improvements": improvements,
    }
    if execute_s is not None:
        rec["execute_s"] = round(float(execute_s), 6)
    return rec
