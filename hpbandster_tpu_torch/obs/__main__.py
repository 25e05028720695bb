"""CLI: ``python -m hpbandster_tpu_torch.obs <command>``.

Ported from ``hpbandster_tpu/obs/__main__.py`` (a copy).

* ``summarize <journal> [<journal> ...] [--json]`` — merge one or many
  (possibly rotated) journals by wall clock; print per-stage latency
  percentiles, worker utilization, failure tallies, and the merged
  per-trace timelines (queue wait -> dispatch -> compute -> delivery).
* ``report <journal> [<journal> ...] [--json] [--tenant T]`` — the
  optimizer-decision view (``obs/report.py``): incumbent trajectory,
  model-vs-random win rate, per-rung promotion regret, bracket
  utilization, alert digest. Deterministic: two invocations over the
  same journals are byte-identical. ``--tenant`` replays ONE tenant's
  slice of a multi-tenant serving journal (records without a
  ``tenant_id`` belong to ``default``).
* ``timeline <journal> [<journal> ...] --out trace.json`` — the unified
  sweep timeline (``obs/timeline.py``): every recorded signal — spans,
  RPC hops, compile/dispatch events, lane lifecycle, decoded per-rung
  device sections — assembled into one causally-ordered Chrome
  trace-event JSON, loadable in Perfetto (https://ui.perfetto.dev) or
  ``chrome://tracing``. Process rows per ``(host, pid)``, thread rows
  per worker/lane, flow arrows following each ``trace_id`` across RPC
  hops into the device loop. Cross-host clocks are aligned on each
  record's monotonic/wall twin stamps before assembly.
* ``critical-path <journal> [<journal> ...] [--json]`` — attribute the
  journal's end-to-end wall-clock to named phases (admission wait,
  compile, transfer, rung compute, promotion, KDE refit, RPC): a
  per-phase table plus a machine-readable verdict (attributed share vs
  threshold) — the same verdict ``bench.py``'s ``timeline_overhead``
  tier records next to the budget verdicts. Exit 0 even when the
  verdict fails (it reports, the bench gate enforces).
* ``slo <journal> [<journal> ...] [--json]`` — deterministic offline
  re-evaluation of the SLO pack (``obs/slo.py`` + ``obs/alerts.py``)
  over a journaled run: per-SLO burn rate / budget-remaining / state
  table, the alert-transition replay-parity check (journaled
  ``slo_alert`` records, envelope stripped, must match the offline
  recomputation byte-identically), and a machine-readable verdict
  ``{firing, budget_remaining, ok}`` — the same verdict ``bench.py``'s
  ``slo_overhead`` tier records. Exit 0 even when the verdict fails
  (it reports, the bench gate enforces).
* ``alerts <journal> [<journal> ...] [--json]`` — the alert lifecycle
  ledger: every ``slo_alert`` transition (pending -> firing ->
  resolved) with its burn rates and budget, from the journal's own
  records when the run was live-managed or from an offline scan
  otherwise.
* ``watch <journal> [--interval S] [--ticks N]`` — tail a live journal,
  one status line per tick; runs until ^C unless ``--ticks`` bounds it.
  ``watch --snapshot <uri> [--snapshot <uri> ...]`` polls live
  processes' ``obs_snapshot`` health RPCs instead — latency quantiles,
  compile counts, and device memory with no journal on disk; several
  URIs merge one row per endpoint per tick (collector poll/staleness
  under the hood).
* ``top --snapshot <uri> [--snapshot <uri> ...]`` (or ``top --series
  <file>``) — the live fleet dashboard (``obs/collector.py``): a
  refreshing table of endpoints, in-flight work, device balance, alerts
  and top recompilers, plus the derived fleet gauges. ``q``+Enter or
  ^C quits; ``--ticks``/``--no-clear`` give the scripted/test mode.
* ``export --port N [--snapshot <uri>] [--host H]`` — standalone
  Prometheus exporter (``obs/export.py``): serves ``GET /metrics`` in
  the strict text exposition format, rendering this process's registry
  or, with ``--snapshot``, bridging a fleet peer's ``obs_snapshot`` RPC
  per scrape. ``export --once`` prints one exposition to stdout and
  exits (the curl-equivalent for pipelines and tests).

Corrupt/truncated JSONL lines are skipped with a counted stderr warning,
never fatal (a post-mortem reader must survive the crash it documents).
Exit codes: 0 success, 2 usage error / missing journal.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, List, Optional, Tuple

from hpbandster_tpu_torch.obs.journal import journal_paths
from hpbandster_tpu_torch.obs.report import build_report, filter_tenant, format_report
from hpbandster_tpu_torch.obs.summarize import (
    format_summary,
    read_merged_ex,
    summarize_records,
    watch_journal,
    watch_snapshot,
)


def _missing_journals(paths: List[str]) -> List[str]:
    return [
        p for p in paths
        if not os.path.exists(p) and not journal_paths(p)
    ]


def _read_checked(paths: List[str]) -> Optional[list]:
    """Merged records, or None (after a clear stderr message) when any
    journal is missing; corrupt lines are counted and warned about."""
    missing = _missing_journals(paths)
    if missing:
        print(
            f"error: journal(s) {', '.join(repr(p) for p in missing)} do not exist",
            file=sys.stderr,
        )
        return None
    records, skipped = read_merged_ex(paths)
    if skipped:
        print(
            f"warning: skipped {skipped} corrupt/truncated journal line(s)",
            file=sys.stderr,
        )
    return records


def run_export(
    port: int,
    host: str = "127.0.0.1",
    snapshot_uri: Optional[str] = None,
    once: bool = False,
) -> int:
    """The ``export`` subcommand body (separated so tests drive it)."""
    from hpbandster_tpu_torch.obs.export import (
        ExporterServer,
        render_registry,
        snapshot_fetcher,
    )

    if snapshot_uri is not None:
        fetch = snapshot_fetcher(snapshot_uri)
    else:
        fetch = render_registry
    if once:
        try:
            sys.stdout.write(fetch())
        except Exception as e:
            print(f"error: scrape failed: {e}", file=sys.stderr)
            return 1
        return 0
    try:
        # positional: the obs-reserved-fields rule reserves `host=` kwargs
        # on obs-resolving calls for the identity stamp; this is a bind
        # address
        server = ExporterServer(port, fetch, host)
    except OSError as e:
        # port in use / privileged port / bad bind address: the CLI
        # contract is a clear message + exit 2, never a raw traceback
        print(
            f"error: cannot bind exporter to {host}:{port}: {e}",
            file=sys.stderr,
        )
        return 2
    print(
        f"serving /metrics on http://{host}:{server.port} "
        + (f"(bridging obs_snapshot at {snapshot_uri})" if snapshot_uri
           else "(local registry)"),
        file=sys.stderr,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:  # graftlint: disable=swallowed-exception — ^C is the intended way to stop the exporter
        pass
    finally:
        server.close()
    return 0


# the payload half of a slo_alert record — everything the evaluator
# computed, nothing the bus envelope stamped (t_wall/host/pid differ
# between the live emit and the offline recomputation by design)
_SLO_PAYLOAD = (
    "slo", "severity", "state", "burn_short", "burn_long",
    "budget_remaining", "key",
)

_STATE_NAMES = {0: "ok", 1: "pending", 2: "firing"}


def _slo_payload(rec: dict) -> dict:
    return {k: rec.get(k) for k in _SLO_PAYLOAD}


def run_slo(
    journals: List[str],
    as_json: bool = False,
    stream: Optional[Any] = None,
) -> int:
    """The ``slo`` subcommand body (separated so tests drive it):
    re-evaluate the SLO pack offline over journal records, check the
    journaled ``slo_alert`` stream against the recomputation, and print
    the per-SLO table + machine-readable verdict."""
    from hpbandster_tpu_torch.obs.alerts import scan_slo_records

    out = stream if stream is not None else sys.stdout
    records = _read_checked(journals)
    if records is None:
        return 2
    mgr = scan_slo_records(records)
    snap = mgr.snapshot()
    recomputed = [_slo_payload(t) for t in mgr.transitions]
    recorded = [
        _slo_payload(r) for r in records if r.get("event") == "slo_alert"
    ]
    replay = {
        "recorded_transitions": len(recorded),
        "recomputed_transitions": len(recomputed),
        # the byte-identical contract: a live-managed run's journaled
        # slo_alert records, envelope stripped, equal the offline
        # recomputation exactly; None = run had no live manager, so
        # there is nothing to compare (not a failure)
        "identical": (recorded == recomputed) if recorded else None,
    }
    budgets = [
        p["budget_remaining"]
        for p in snap["by_slo"].values()
        if p.get("budget_remaining") is not None
    ]
    worst_budget = min(budgets) if budgets else None
    verdict = {
        "firing": snap["firing"],
        "budget_remaining": worst_budget,
        "ok": bool(
            snap["firing"] == 0
            and (worst_budget is None or worst_budget > 0.0)
            and replay["identical"] is not False
        ),
    }
    doc = {"slo": snap, "replay": replay, "verdict": verdict}
    if as_json:
        print(json.dumps(doc, indent=1, sort_keys=True), file=out)
        return 0
    status = "OK" if verdict["ok"] else "FAIL"
    print(
        f"slo verdict: {status} — {snap['firing']} firing, worst burn "
        f"{snap['worst_burn_rate']}, worst budget {worst_budget}",
        file=out,
    )
    if not snap["by_slo"]:
        print("  (no SLO-relevant records in this journal)", file=out)
    for name, pub in snap["by_slo"].items():
        state = _STATE_NAMES.get(pub["state"], str(pub["state"]))
        print(
            f"  {name:<24} burn={pub['burn_rate']}  "
            f"budget={pub['budget_remaining']}  state={state}",
            file=out,
        )
    ident = replay["identical"]
    tag = ("n/a (no journaled slo_alert records)" if ident is None
           else "identical" if ident else "MISMATCH")
    print(
        f"  replay parity: {tag} "
        f"({replay['recorded_transitions']} recorded / "
        f"{replay['recomputed_transitions']} recomputed)",
        file=out,
    )
    return 0


def run_alerts(
    journals: List[str],
    as_json: bool = False,
    stream: Optional[Any] = None,
) -> int:
    """The ``alerts`` subcommand body (separated so tests drive it):
    list every slo_alert lifecycle transition — the journal's own
    records when the run was live-managed, an offline scan otherwise."""
    from hpbandster_tpu_torch.obs.alerts import scan_slo_records

    out = stream if stream is not None else sys.stdout
    records = _read_checked(journals)
    if records is None:
        return 2
    recorded = [r for r in records if r.get("event") == "slo_alert"]
    if recorded:
        source, raw = "journal", recorded
    else:
        source, raw = "offline_scan", list(scan_slo_records(records).transitions)
    times = [
        r.get("t_wall") for r in records
        if isinstance(r.get("t_wall"), (int, float))
    ]
    t0 = min(times) if times else 0.0
    rows = []
    for r in raw:
        t = r.get("t_wall")
        at_s = round(float(t) - t0, 3) if isinstance(t, (int, float)) else None
        rows.append({"at_s": at_s, **_slo_payload(r)})
    doc = {"source": source, "count": len(rows), "transitions": rows}
    if as_json:
        print(json.dumps(doc, indent=1, sort_keys=True), file=out)
        return 0
    print(f"slo alert transitions ({source}): {len(rows)}", file=out)
    for r in rows:
        at = f"+{r['at_s']:.3f}s" if r["at_s"] is not None else "?"
        print(
            f"  {at:>12}  {str(r['slo']):<24} {str(r['severity']):<7} "
            f"-> {str(r['state']):<9} burn {r['burn_short']}/{r['burn_long']} "
            f"budget {r['budget_remaining']}",
            file=out,
        )
    return 0


def _top_wait_or_quit(interval: float) -> bool:
    """Sleep one refresh interval; True = keep running. Keybindings:
    ``q`` (+Enter) or ^C quits — stdin is only consulted when it is a
    real TTY, so piped/scripted runs never block on it."""
    try:
        if sys.stdin is not None and sys.stdin.isatty():
            import select

            ready, _, _ = select.select([sys.stdin], [], [], interval)
            if ready:
                line = sys.stdin.readline()
                if line.strip().lower().startswith("q"):
                    return False
        else:
            time.sleep(interval)
    except KeyboardInterrupt:  # graftlint: disable=swallowed-exception — ^C is the intended way to leave top
        return False
    except (OSError, ValueError):  # closed/odd stdin: plain sleep instead
        time.sleep(interval)
    return True


def run_top(
    uris: Optional[List[str]],
    series: Optional[str] = None,
    interval: float = 2.0,
    ticks: Optional[int] = None,
    clear: bool = True,
    stream: Optional[Any] = None,
    tenant: Optional[str] = None,
) -> int:
    """The ``top`` subcommand body (separated so tests drive it): a
    refreshing fleet table from live endpoint polling (``--snapshot``,
    repeatable) or from the newest sample of a collector series file
    (``--series``)."""
    from hpbandster_tpu_torch.obs.collector import (
        format_fleet_table,
        read_series_tail,
    )
    from hpbandster_tpu_torch.obs.summarize import make_viewer_collector

    out = stream if stream is not None else sys.stdout
    if bool(uris) == bool(series):
        print(
            "error: top needs --snapshot URI(s) or --series PATH (not both)",
            file=sys.stderr,
        )
        return 2
    collector = None
    if uris:
        try:
            collector = make_viewer_collector(uris, interval)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    tick = 0
    sample = None
    series_stat: Optional[Tuple[int, int]] = None
    while True:
        if collector is not None:
            sample = collector.poll_once()
        else:
            if not os.path.exists(series):
                print(f"error: series file {series!r} does not exist",
                      file=sys.stderr)
                return 2
            st = os.stat(series)
            stat_now = (st.st_mtime_ns, st.st_size)
            # re-read only when the live file actually changed; even
            # then only its tail — a tick renders one frame, not the
            # fleet's whole history
            if stat_now != series_stat:
                series_stat = stat_now
                sample = read_series_tail(series)
        if clear:
            print("\x1b[2J\x1b[H", end="", file=out)
        stamp = time.strftime("%H:%M:%S")
        source = "live" if collector is not None else series
        print(f"hpbandster fleet top — {stamp} ({source})  [q quits]",
              file=out)
        if sample is not None:
            print(format_fleet_table(sample, tenant=tenant), file=out,
                  flush=True)
        else:
            print("(no fleet samples yet)", file=out, flush=True)
        tick += 1
        if ticks is not None and tick >= ticks:
            return 0
        if not _top_wait_or_quit(interval):
            return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m hpbandster_tpu_torch.obs",
        description="observability tooling (see docs/observability.md)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p_sum = sub.add_parser(
        "summarize",
        help="per-stage latency percentiles, worker utilization, failures, "
        "and merged per-trace timelines",
    )
    p_sum.add_argument(
        "journals", nargs="+", metavar="journal",
        help="JSONL run journal(s) — e.g. the master's and each worker's",
    )
    p_sum.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the summary as JSON instead of text",
    )
    p_rep = sub.add_parser(
        "report",
        help="optimizer decision report: incumbent trajectory, "
        "model-vs-random win rate, promotion regret, alert digest",
    )
    p_rep.add_argument(
        "journals", nargs="+", metavar="journal",
        help="JSONL run journal(s) — merged before analysis",
    )
    p_rep.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the report as JSON instead of text",
    )
    p_rep.add_argument(
        "--tenant", metavar="TENANT", default=None,
        help="report one tenant's slice of a multi-tenant journal "
        "(records without tenant_id belong to 'default')",
    )
    p_tl = sub.add_parser(
        "timeline",
        help="export the unified sweep timeline as Chrome trace-event "
        "JSON (open in Perfetto or chrome://tracing); see "
        "docs/observability.md 'Timeline & critical path'",
    )
    p_tl.add_argument(
        "journals", nargs="+", metavar="journal",
        help="JSONL run journal(s) — merged and clock-aligned first",
    )
    p_tl.add_argument(
        "--out", metavar="PATH", default=None,
        help="write the trace JSON here (default: stdout)",
    )
    p_cp = sub.add_parser(
        "critical-path",
        help="attribute end-to-end wall-clock to named phases (admission "
        "wait, compile, transfer, rung compute, promotion, KDE refit, "
        "RPC) with a machine-readable verdict",
    )
    p_cp.add_argument(
        "journals", nargs="+", metavar="journal",
        help="JSONL run journal(s) — merged and clock-aligned first",
    )
    p_cp.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the attribution (and verdict) as JSON instead of text",
    )
    p_cp.add_argument(
        "--threshold", type=float, default=0.95,
        help="attributed-share bar for the verdict (default 0.95)",
    )
    p_rpl = sub.add_parser(
        "replay",
        help="re-score recorded promotion_decision records under another "
        "promotion rule: rank-inversion and incumbent-regret deltas "
        "(deterministic; see docs/promotion.md)",
    )
    p_rpl.add_argument(
        "journals", nargs="+", metavar="journal",
        help="JSONL run journal(s) — merged before analysis",
    )
    p_rpl.add_argument(
        "--rule", required=True, metavar="RULE",
        help="promotion rule to replay under (e.g. asha, pareto, "
        "lc_earlystop, successive_halving)",
    )
    p_rpl.add_argument(
        "--eta", type=float, default=None,
        help="eta for the asha replay (default: derived from each "
        "record's budget ratio)",
    )
    p_rpl.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the replay report as JSON instead of text",
    )
    p_slo = sub.add_parser(
        "slo",
        help="re-evaluate the SLO pack over a journaled run: per-SLO "
        "burn/budget/state table, replay-parity check, machine-readable "
        "verdict (see docs/observability.md 'SLOs & alerting')",
    )
    p_slo.add_argument(
        "journals", nargs="+", metavar="journal",
        help="JSONL run journal(s) — merged before evaluation",
    )
    p_slo.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the table, replay parity, and verdict as JSON",
    )
    p_al = sub.add_parser(
        "alerts",
        help="list every slo_alert lifecycle transition (pending -> "
        "firing -> resolved) with burn rates and budget",
    )
    p_al.add_argument(
        "journals", nargs="+", metavar="journal",
        help="JSONL run journal(s) — merged before evaluation",
    )
    p_al.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the transition list as JSON",
    )
    p_watch = sub.add_parser(
        "watch", help="tail a live journal (or poll a health RPC), "
        "one status line per tick"
    )
    p_watch.add_argument(
        "journal", nargs="?", default=None,
        help="path to a (possibly future) journal",
    )
    p_watch.add_argument(
        "--snapshot", metavar="URI", action="append", default=None,
        help="poll obs_snapshot on this RPC endpoint (host:port) instead "
        "of tailing a journal — latency quantiles without a journal; "
        "repeat for several endpoints (one merged row each per tick)",
    )
    p_watch.add_argument(
        "--interval", type=float, default=2.0, help="seconds between ticks"
    )
    p_watch.add_argument(
        "--ticks", type=int, default=None,
        help="stop after N ticks (default: run until ^C)",
    )
    p_watch.add_argument(
        "--tenant", metavar="TENANT", default=None,
        help="with --snapshot: show this tenant's serving counters on "
        "each row instead of the tenant census",
    )
    p_top = sub.add_parser(
        "top",
        help="live fleet dashboard: refreshing table of endpoints, device "
        "balance, alerts, top recompilers (see docs/observability.md "
        "'Fleet observatory')",
    )
    p_top.add_argument(
        "--snapshot", metavar="URI", action="append", default=None,
        help="poll obs_snapshot on this endpoint (host:port); repeat for "
        "the whole fleet (master + dispatcher + workers)",
    )
    p_top.add_argument(
        "--series", metavar="PATH", default=None,
        help="render the newest sample of a collector series file instead "
        "of polling live endpoints",
    )
    p_top.add_argument(
        "--interval", type=float, default=2.0, help="seconds between refreshes"
    )
    p_top.add_argument(
        "--ticks", type=int, default=None,
        help="stop after N refreshes (default: run until q/^C)",
    )
    p_top.add_argument(
        "--no-clear", action="store_true", dest="no_clear",
        help="append frames instead of clearing the screen (pipelines/tests)",
    )
    p_top.add_argument(
        "--tenant", metavar="TENANT", default=None,
        help="narrow the table to endpoints serving this tenant; the "
        "tenants column then shows the tenant's configs_done",
    )
    p_exp = sub.add_parser(
        "export",
        help="Prometheus exporter: serve GET /metrics in the strict text "
        "exposition format (see docs/observability.md 'Scraping the fleet')",
    )
    p_exp.add_argument(
        "--port", type=int, default=9090,
        help="HTTP port to serve /metrics on (default 9090)",
    )
    p_exp.add_argument(
        "--host", default="127.0.0.1",
        help="bind address (default 127.0.0.1; use 0.0.0.0 to expose)",
    )
    p_exp.add_argument(
        "--snapshot", metavar="URI", default=None,
        help="bridge mode: per scrape, poll obs_snapshot on this RPC "
        "endpoint (host:port) and export ITS metrics instead of this "
        "process's registry",
    )
    p_exp.add_argument(
        "--once", action="store_true",
        help="print one exposition to stdout and exit (no HTTP server)",
    )
    args = parser.parse_args(argv)

    if args.command == "top":
        return run_top(
            uris=args.snapshot, series=args.series, interval=args.interval,
            ticks=args.ticks, clear=not args.no_clear, tenant=args.tenant,
        )

    if args.command == "slo":
        return run_slo(args.journals, as_json=args.as_json)

    if args.command == "alerts":
        return run_alerts(args.journals, as_json=args.as_json)

    if args.command == "export":
        return run_export(
            port=args.port, host=args.host, snapshot_uri=args.snapshot,
            once=args.once,
        )

    if args.command == "watch":
        if args.snapshot is not None:
            if args.journal is not None:
                print(
                    "error: watch takes a journal path OR --snapshot, "
                    "not both",
                    file=sys.stderr,
                )
                return 2
            return watch_snapshot(
                args.snapshot, interval=args.interval, ticks=args.ticks,
                tenant=args.tenant,
            )
        if args.journal is None:
            print(
                "error: watch needs a journal path or --snapshot URI",
                file=sys.stderr,
            )
            return 2
        if args.tenant is not None:
            # refusing beats silently watching every tenant's records
            print(
                "error: watch --tenant requires --snapshot (journal mode "
                "has no tenant filter; use 'report --tenant' for a "
                "per-tenant journal replay)",
                file=sys.stderr,
            )
            return 2
        return watch_journal(args.journal, interval=args.interval, ticks=args.ticks)

    records = _read_checked(args.journals)
    if records is None:
        return 2
    if args.command == "timeline":
        from hpbandster_tpu_torch.obs.timeline import to_chrome_trace

        doc = to_chrome_trace(records)
        payload = json.dumps(doc, indent=1, sort_keys=True)
        stats = doc["otherData"]
        if args.out is not None:
            with open(args.out, "w", encoding="utf-8") as fh:
                fh.write(payload + "\n")
            print(
                f"wrote {args.out}: {stats['slices']} slices, "
                f"{stats['flows']} flow arrows, {stats['processes']} "
                f"process row(s) over {stats['span_s']}s — open in "
                "https://ui.perfetto.dev",
                file=sys.stderr,
            )
        else:
            print(payload)
        return 0
    if args.command == "critical-path":
        from hpbandster_tpu_torch.obs.timeline import (
            critical_path,
            format_critical_path,
        )

        cp = critical_path(records, threshold=args.threshold)
        if args.as_json:
            print(json.dumps(cp, indent=1, sort_keys=True))
        else:
            print(format_critical_path(cp))
        return 0
    if args.command == "replay":
        # CLI-only import: the replay harness pulls in the promotion
        # kernels (numpy/torch); the substrate commands stay stdlib-only
        from hpbandster_tpu_torch.promote.replay import (
            format_replay,
            replay_records,
        )

        try:
            rep = replay_records(records, args.rule, eta=args.eta)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if args.as_json:
            print(json.dumps(rep, indent=1, sort_keys=True))
        else:
            print(format_replay(rep))
        return 0
    if args.command == "report":
        if args.tenant is not None:
            records = filter_tenant(records, args.tenant)
        rep = build_report(records)
        if args.as_json:
            print(json.dumps(rep, indent=1, sort_keys=True))
        else:
            print(format_report(rep))
        return 0
    summary = summarize_records(records)
    if args.as_json:
        print(json.dumps(summary, indent=1))
    else:
        print(format_summary(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
