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

The bus half: :func:`publish_device_metrics` republishes a decoded record
as registry gauges (``sweep.device_metrics.*``, the ``sweep.rung.<budget>.*``
family and the ``sweep.budget_cost_s.<budget>`` cost gauges);
:func:`emit_device_telemetry` journals it as a ``device_telemetry`` event;
:func:`device_section_from_records` / :func:`format_device_section` fold a
journal's records into one section; :func:`device_metric_fields` parses the
gauges back; :func:`budget_cost_from_obs` is the per-budget cost feed
Pareto promotion ranks by (``promote/pareto.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from hpbandster_tpu_torch.obs import events as E
from hpbandster_tpu_torch.obs.metrics import MetricsRegistry, get_metrics

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
    "device_metric_fields",
    "publish_device_metrics",
    "emit_device_telemetry",
    "device_section_from_records",
    "format_device_section",
    "budget_cost_from_obs",
    "COST_FEED_MIN_COUNT",
]

#: total bin count, underflow (bin 0) and overflow (bin N_BINS-1) included
N_BINS = 32
#: log10 of bin 0's upper bound / of the last finite upper bound
LOG10_LO = -6.0
LOG10_HI = 6.0
#: decoded-record schema version (bump on any layout change so journal
#: readers can tell records apart)
SCHEMA_VERSION = 1

#: minimum observation count before a registry histogram is trusted as a
#: cost feed (below it, one noisy span would masquerade as an aggregate)
COST_FEED_MIN_COUNT = 8


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


#: the gauge namespace publish_device_metrics mints totals under —
#: device_metric_fields is its ONE parser
GAUGE_PREFIX = "sweep.device_metrics."


def device_metric_fields(gauges) -> Dict[str, float]:
    """``{field: value}`` for every ``sweep.device_metrics.*`` gauge in
    a metrics/gauges mapping — THE one parser of the gauge names
    :func:`publish_device_metrics` mints. The collector's endpoint rows
    and ``watch --snapshot``'s device part both read through it, so a
    renamed or added field cannot make the two surfaces disagree."""
    out: Dict[str, float] = {}
    for name, value in (gauges or {}).items():
        if isinstance(name, str) and name.startswith(GAUGE_PREFIX):
            v = finite_or_none(value)
            if v is not None:
                out[name[len(GAUGE_PREFIX):]] = v
    return out


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


def publish_device_metrics(
    decoded: Dict[str, Any],
    registry: Optional[MetricsRegistry] = None,
) -> None:
    """Republish one decoded record as registry gauges.

    * ``sweep.device_metrics.{evaluations,crashes,promotions,model_fits,
      rounds,crash_rate}`` — sweep-level totals (dotted names flatten in
      the Prometheus rendering);
    * ``sweep.rung.<budget>.{evals,crashes,promotions,loss_p50,
      loss_p95}`` — per-rung families, re-expressed by ``obs/export.py``
      as ``sweep_rung_<field>{budget=...}``;
    * ``sweep.budget_cost_s.<budget>`` — the per-evaluation device-cost
      estimate (present when the decoder was given ``execute_s``), the
      gauge half of :func:`budget_cost_from_obs`'s feed.

    Like the per-sweep transfer gauges these describe the LAST sweep;
    scraping mid-run sees the previous sweep's values.
    """
    reg = registry if registry is not None else get_metrics()
    for field, key in (
        ("evaluations", "evaluations"), ("crashes", "crashes"),
        ("promotions", "promotions"), ("model_fits", "model_fits"),
        ("rounds", "rounds_completed"),
    ):
        v = decoded.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            reg.gauge(f"sweep.device_metrics.{field}").set(float(v))
    rate = finite_or_none(decoded.get("crash_rate"))
    if rate is not None:
        reg.gauge("sweep.device_metrics.crash_rate").set(rate)
    for rung in decoded.get("rungs") or []:
        b = finite_or_none(rung.get("budget"))
        if b is None:
            continue
        for field in ("evals", "crashes", "promotions"):
            v = rung.get(field)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                reg.gauge(f"sweep.rung.{b:g}.{field}").set(float(v))
        for field in ("loss_p50", "loss_p95"):
            v = finite_or_none(rung.get(field))
            if v is not None:
                reg.gauge(f"sweep.rung.{b:g}.{field}").set(v)
        cost = finite_or_none(rung.get("est_cost_s"))
        if cost is not None:
            reg.gauge(f"sweep.budget_cost_s.{b:g}").set(cost)


def emit_device_telemetry(decoded: Dict[str, Any]) -> None:
    """Journal one decoded record as a ``device_telemetry`` event — the
    record ``summarize``/``report``/``obs top`` consume and the anomaly
    rules (``nan_burst``, ``bracket_skew``) read device crash counters
    from. A no-op with no sink attached, like every emit."""
    if not E.get_bus().active:
        return
    E.emit(E.DEVICE_TELEMETRY, **decoded)


def device_section_from_records(
    records: Sequence[Dict[str, Any]],
) -> Optional[Dict[str, Any]]:
    """Fold a journal's ``device_telemetry`` records into the section
    ``summarize`` and ``report`` both render — ONE aggregation so the
    two views of a journal cannot drift. Deterministic in record
    content; None when the journal carries no device telemetry."""
    recs = [
        r for r in records
        if isinstance(r, dict) and r.get("event") == E.DEVICE_TELEMETRY
    ]
    if not recs:
        return None
    totals = {
        "sweeps": len(recs), "evaluations": 0, "crashes": 0,
        "promotions": 0, "model_fits": 0, "rounds_completed": 0,
    }
    for r in recs:
        for key in (
            "evaluations", "crashes", "promotions", "model_fits",
            "rounds_completed",
        ):
            v = r.get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                totals[key] += int(v)
    totals["crash_rate"] = (
        round(totals["crashes"] / totals["evaluations"], 6)
        if totals["evaluations"] else None
    )
    totals["rungs"] = merge_rungs([r.get("rungs") for r in recs])
    # each record's running-best tail is that sweep's final incumbent
    bests = [
        finite_or_none((r.get("incumbent_after") or [None])[-1]) for r in recs
    ]
    bests = [b for b in bests if b is not None]
    totals["best_loss"] = round(min(bests), 6) if bests else None
    return totals


def format_device_section(section: Dict[str, Any]) -> List[str]:
    """Text lines for one :func:`device_section_from_records` section —
    shared by the summarize and report renderers."""
    lines = [
        "device telemetry: %d sweep(s), %d evals, %d crashed%s, "
        "%d model fits, %d rounds"
        % (
            section["sweeps"], section["evaluations"], section["crashes"],
            (
                " (%.2f%%)" % (100.0 * section["crash_rate"])
                if isinstance(section.get("crash_rate"), (int, float))
                else ""
            ),
            section["model_fits"], section["rounds_completed"],
        )
    ]
    for rung in section.get("rungs") or []:
        p50 = rung.get("loss_p50")
        p95 = rung.get("loss_p95")
        lines.append(
            "  rung budget=%g: %d evals, %d crashed, %d promoted, "
            "loss p50<=%s p95<=%s"
            % (
                rung.get("budget"), rung.get("evals", 0),
                rung.get("crashes", 0), rung.get("promotions", 0),
                "%.4g" % p50 if isinstance(p50, (int, float)) else "?",
                "%.4g" % p95 if isinstance(p95, (int, float)) else "?",
            )
        )
    if section.get("best_loss") is not None:
        lines.append("  best final loss (device): %.6g" % section["best_loss"])
    return lines


def budget_cost_from_obs(
    budget: float,
    registry: Optional[MetricsRegistry] = None,
    min_count: int = COST_FEED_MIN_COUNT,
) -> Optional[float]:
    """The obs-histogram cost feed for one budget, or None when no feed
    exists.

    Priority: the master's budget-keyed evaluation-time histogram
    (``master.job_run_s.b<budget>`` p50, trusted once it holds
    ``min_count`` observations — the aggregate measurement, immune to
    one straggling span), then the ``sweep.budget_cost_s.<budget>``
    gauge the device-telemetry decoder publishes (fused/resident sweeps,
    where per-job host timing is fiction). ``promote/pareto.py`` ranks
    its cost objective from this feed and falls back to per-job wall
    spans only when it returns None.
    """
    b = finite_or_none(budget)
    if b is None:
        return None
    reg = registry if registry is not None else get_metrics()
    snap = reg.snapshot()
    hist = (snap.get("histograms") or {}).get(f"master.job_run_s.b{b:g}")
    if isinstance(hist, dict):
        count = hist.get("count")
        p50 = finite_or_none(hist.get("p50"))
        if (
            isinstance(count, (int, float)) and count >= max(int(min_count), 1)
            and p50 is not None
        ):
            return p50
    gauge = finite_or_none(
        (snap.get("gauges") or {}).get(f"sweep.budget_cost_s.{b:g}")
    )
    return gauge
