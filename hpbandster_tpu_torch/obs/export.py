"""Prometheus-compatible metrics exporter (text exposition format 0.0.4).

Ported from ``hpbandster_tpu/obs/export.py`` (a copy; the exposition
format, help strings included, is the reference's).

The fleet's metrics were only reachable through the bespoke
``obs_snapshot`` RPC; this module renders the same atomic
:meth:`~hpbandster_tpu_torch.obs.metrics.MetricsRegistry.snapshot` as the
strict Prometheus text exposition format any standard scraper ingests:

* counters as ``<family>_total`` with ``# HELP`` / ``# TYPE`` lines;
* gauges verbatim;
* histograms as ``_count`` / ``_sum`` / ``_p50`` / ``_p95`` gauges (the
  quantiles the registry already computes — bucket upper bounds,
  conservative by design);
* dotted registry names flatten to legal metric names, and the
  per-entity families this repo mints dynamically (per-function compile
  counters, per-device gauges, per-worker ages, per-rule alert tallies)
  become proper labeled families with correct label escaping.

Rendering is deterministic: families sort by name, samples by label
string, values format identically call to call — two scrapes of a frozen
registry are byte-identical (pinned by ``tests/test_export.py`` through
the strict round-trip parser :func:`parse_prometheus_text`). Non-finite
values never render (Prometheus accepts NaN; our exposition contract is
NaN-free because every NaN this repo produces is a bug signal that
belongs in the anomaly pipeline, not a scrape).

Serving:

* every :class:`~hpbandster_tpu_torch.obs.health.HealthEndpoint` registers a
  ``metrics_text`` RPC method returning this exposition, so any fleet
  process can be scraped through its existing health port;
* ``python -m hpbandster_tpu_torch.obs export --port N`` runs a standalone
  HTTP exporter serving ``GET /metrics`` — either this process's own
  registry or, with ``--snapshot host:port``, a bridge that polls a
  fleet peer's ``obs_snapshot`` RPC per scrape and re-renders it (the
  Prometheus-side adapter for workers/dispatchers that only speak the
  repo's JSON-RPC).
"""

from __future__ import annotations

import http.server
import json
import logging
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from hpbandster_tpu_torch.obs.metrics import MetricsRegistry, get_metrics

__all__ = [
    "render_snapshot",
    "render_registry",
    "parse_prometheus_text",
    "metric_family",
    "ExporterServer",
    "serve",
    "CONTENT_TYPE",
]

logger = logging.getLogger("hpbandster_tpu_torch.obs")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: default family prefix: every exported metric is namespaced so a shared
#: Prometheus cannot collide with another job's vocabulary
DEFAULT_NAMESPACE = "hpbandster"

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")

#: dynamic per-entity registry names -> (family, labels). Everything the
#: repo mints with an entity baked into the dotted name is re-expressed
#: as one labeled family, the idiom scrapers can aggregate over.
#: DOTALL: entity names (worker ids especially) may carry any byte — the
#: label value escaping handles them, so the match must not stop at \n.
#: The third element is a label key (single-label rules: the group is
#: named ``label``) or a tuple of keys (multi-label rules: groups named
#: after the keys themselves).
_LABEL_RULES: Tuple[Tuple[re.Pattern, str, object], ...] = (
    (re.compile(r"^runtime\.device\.(?P<label>\d+)\.(?P<field>[a-z_]+)$"),
     "runtime_device_{field}", "device"),
    # sharded-sweep balance gauges (parallel/multihost.py
    # publish_device_balance): sweep.device.<id>.configs ->
    # sweep_device_configs{device="<id>"} — the per-device config-count /
    # padding family fleet.device_compute_skew is derived from
    (re.compile(r"^sweep\.device\.(?P<label>\d+)\.(?P<field>[a-z_]+)$"),
     "sweep_device_{field}", "device"),
    # per-sweep host-link byte gauges (obs/runtime.py
    # publish_sweep_transfers): sweep.transfer_bytes.h2d ->
    # sweep_transfer_bytes{direction="h2d"} — one labeled family so a
    # scraper can plot both directions on one panel; the resident
    # sweep's flat-d2h acceptance reads this gauge
    (re.compile(r"^sweep\.transfer_bytes\.(?P<label>h2d|d2h)$"),
     "sweep_transfer_bytes", "direction"),
    # device metrics plane (obs/device_metrics.py publish_device_metrics):
    # sweep.rung.<budget>.loss_p95 -> sweep_rung_loss_p95{budget="..."} —
    # per-rung crash/eval/promotion counts and loss quantiles decoded
    # from the in-trace telemetry pytree. Greedy label + dot-free field:
    # a budget rendered with a dot (0.5) keeps it in the label, the LAST
    # dot separates the field (the serve-tenant idiom).
    (re.compile(
        r"^sweep\.rung\.(?P<label>.+)\.(?P<field>[a-zA-Z0-9_]+)$",
        re.DOTALL),
     "sweep_rung_{field}", "budget"),
    # per-budget evaluation-cost estimate derived from device telemetry —
    # the gauge half of the Pareto cost feed (budget_cost_from_obs)
    (re.compile(r"^sweep\.budget_cost_s\.(?P<label>.+)$", re.DOTALL),
     "sweep_budget_cost_s", "budget"),
    # the master's budget-keyed evaluation-time histograms (the histogram
    # half of the cost feed): master.job_run_s.b<budget> histogram
    # families label by budget instead of minting one family per budget
    (re.compile(r"^master\.job_run_s\.b(?P<label>.+)$", re.DOTALL),
     "master_job_run_s_budget", "budget"),
    (re.compile(r"^runtime\.compiles\.(?P<label>.+)$", re.DOTALL),
     "runtime_fn_compiles", "fn"),
    # roofline/cost families (obs/runtime.py CompileTracker.record, fed by
    # each capture's count_cost): per-program FLOPs and bytes re-expressed
    # as one labeled family each, so a scraper can sum/aggregate across
    # functions
    (re.compile(r"^runtime\.flops\.(?P<label>.+)$", re.DOTALL),
     "runtime_fn_flops", "fn"),
    (re.compile(r"^runtime\.bytes_accessed\.(?P<label>.+)$", re.DOTALL),
     "runtime_fn_bytes_accessed", "fn"),
    (re.compile(r"^anomaly\.alerts\.(?P<label>.+)$", re.DOTALL),
     "anomaly_rule_alerts", "rule"),
    # promotion-rule counters (obs/audit.py emit_bracket_promotion):
    # bracket.promotions.<rule>.<rung> ->
    # bracket_promotions{rule="<rule>", rung="<rung>"}. The greedy rule
    # group + the digits-only rung tail means a rule name containing
    # dots keeps them in the label (the LAST dot separates the rung).
    (re.compile(
        r"^bracket\.promotions\.(?P<rule>.+)\.(?P<rung>\d+)$", re.DOTALL),
     "bracket_promotions", ("rule", "rung")),
    (re.compile(
        r"^dispatcher\.worker_last_seen_age_s\.(?P<label>.+)$", re.DOTALL),
     "dispatcher_worker_last_seen_age_s", "worker"),
    # per-tenant serving-tier families (serve/pool.py, serve/frontend.py):
    # serve.tenant.<tenant>.configs_done -> serve_tenant_configs_done
    # {tenant="<tenant>"}. The greedy label group + the dot-free field
    # group means a tenant id containing dots keeps them in the label
    # (the LAST dot separates the field); any byte is legal in the label
    # value via the exposition escaping.
    (re.compile(
        r"^serve\.tenant\.(?P<label>.+)\.(?P<field>[a-zA-Z0-9_]+)$",
        re.DOTALL),
     "serve_tenant_{field}", "tenant"),
    # the pool-wide serving counters take no rule and flatten:
    # serve.rounds -> serve_rounds_total, and the pack window's ends
    # (serve/pool.py) serve.pack_window.closed_early ->
    # serve_pack_window_closed_early_total, serve.pack_window.full ->
    # serve_pack_window_full_total
    # SLO gauges (obs/alerts.py AlertManager): slo.<name>.burn_rate ->
    # slo_burn_rate{slo="<name>"} — one labeled family per field so a
    # scraper alerts on max(slo_burn_rate) across specs. Greedy label +
    # dot-free field (the serve-tenant idiom): a spec name containing
    # dots keeps them in the label, the LAST dot separates the field.
    (re.compile(
        r"^slo\.(?P<label>.+)\.(?P<field>[a-zA-Z0-9_]+)$",
        re.DOTALL),
     "slo_{field}", "slo"),
    # alert lifecycle counters (obs/alerts.py): alert.transitions.<slo>
    # -> slo_alert_transitions{slo="<slo>"} — a DISTINCT family from the
    # flattened global alert.transitions / alert.firing totals (the
    # anomaly_rule_alerts idiom: per-entity and global tallies must not
    # share one exposition family).
    (re.compile(r"^alert\.transitions\.(?P<label>.+)$", re.DOTALL),
     "slo_alert_transitions", "slo"),
    # kde_score launches by the kernel instance's register width
    # (ops/cuda_kde.py): kde.score_launches.32 ->
    # kde_score_launches{width="32"}
    (re.compile(r"^kde\.score_launches\.(?P<label>\d+)$"),
     "kde_score_launches", "width"),
    # values the bulk decode took through each branch
    # (space/configspace.py _decode_column): space.decode_values.mapped
    # -> space_decode_values{branch="mapped"}
    (re.compile(r"^space\.decode_values\.(?P<label>numpy|mapped)$"),
     "space_decode_values", "branch"),
)


def _sanitize(name: str) -> str:
    out = _SANITIZE.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def metric_family(name: str, namespace: str = DEFAULT_NAMESPACE) -> Tuple[str, Dict[str, str]]:
    """Registry name -> (exposition family, labels). Dotted names flatten
    (``dispatcher.queue_depth`` -> ``hpbandster_dispatcher_queue_depth``);
    per-entity names matching a label rule become labeled families."""
    for pattern, family_tmpl, label_key in _LABEL_RULES:
        m = pattern.match(name)
        if m is not None:
            groups = m.groupdict()
            if isinstance(label_key, str):
                labels = {label_key: groups["label"]}
                label_groups = {"label"}
            else:  # multi-label rule: groups are named after the keys
                labels = {k: groups[k] for k in label_key}
                label_groups = set(label_key)
            family = family_tmpl.format(
                **{
                    k: _sanitize(v)
                    for k, v in groups.items() if k not in label_groups
                }
            )
            prefix = f"{namespace}_" if namespace else ""
            return prefix + _sanitize(family), labels
    prefix = f"{namespace}_" if namespace else ""
    return prefix + _sanitize(name), {}


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: Any) -> Optional[str]:
    """Deterministic sample value, or None for values that must not
    render (non-finite, non-numeric)."""
    if isinstance(v, bool) or v is None:
        return None
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v or v in (float("inf"), float("-inf")):
            return None
        return repr(v)
    return None


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_sanitize(k)}="{_escape_label_value(str(v))}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def render_snapshot(
    snap: Dict[str, Dict[str, Any]],
    namespace: str = DEFAULT_NAMESPACE,
) -> str:
    """Render one ``MetricsRegistry.snapshot()`` dict as the strict text
    exposition. Counters gain the conventional ``_total`` suffix;
    histograms flatten to ``_count``/``_sum``/``_p50``/``_p95`` gauges."""
    #: family -> {"type": str, "help": str, "samples": [(labels, value)]}
    families: Dict[str, Dict[str, Any]] = {}

    def add(family: str, mtype: str, help_text: str,
            labels: Dict[str, str], value: Any) -> None:
        rendered = _fmt_value(value)
        if rendered is None:
            return
        slot = families.setdefault(
            family, {"type": mtype, "help": help_text, "samples": []}
        )
        if slot["type"] != mtype:
            # a label rule folded two registry kinds into one family name;
            # first kind wins, the straggler is dropped loudly
            logger.warning(
                "metric family %s seen as both %s and %s; dropping the %s sample",
                family, slot["type"], mtype, mtype,
            )
            return
        slot["samples"].append((labels, rendered))

    for name, value in (snap.get("counters") or {}).items():
        family, labels = metric_family(name, namespace)
        add(
            family + "_total", "counter",
            f"hpbandster_tpu counter {name!r}", labels, value,
        )
    for name, value in (snap.get("gauges") or {}).items():
        family, labels = metric_family(name, namespace)
        add(family, "gauge", f"hpbandster_tpu gauge {name!r}", labels, value)
    for name, h in (snap.get("histograms") or {}).items():
        family, labels = metric_family(name, namespace)
        base_help = f"hpbandster_tpu histogram {name!r}"
        add(family + "_count", "gauge", base_help + " (observations)",
            labels, h.get("count"))
        add(family + "_sum", "gauge", base_help + " (sum)",
            labels, h.get("sum"))
        add(family + "_p50", "gauge",
            base_help + " (p50, bucket upper bound)", labels, h.get("p50"))
        add(family + "_p95", "gauge",
            base_help + " (p95, bucket upper bound)", labels, h.get("p95"))

    lines: List[str] = []
    for family in sorted(families):
        slot = families[family]
        if not _NAME_OK.match(family):  # defense in depth; _sanitize upholds it
            logger.warning("skipping illegal metric family %r", family)
            continue
        lines.append(f"# HELP {family} {_escape_help(slot['help'])}")
        lines.append(f"# TYPE {family} {slot['type']}")
        for labels, rendered in sorted(
            slot["samples"], key=lambda s: _label_str(s[0])
        ):
            lines.append(f"{family}{_label_str(labels)} {rendered}")
    return "\n".join(lines) + "\n" if lines else ""


def render_registry(
    registry: Optional[MetricsRegistry] = None,
    namespace: str = DEFAULT_NAMESPACE,
) -> str:
    """Render a registry (default: the process-wide one) — one atomic
    snapshot, then pure formatting."""
    reg = registry if registry is not None else get_metrics()
    return render_snapshot(reg.snapshot(), namespace=namespace)


# --------------------------------------------------------------- strict parse
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r" (?P<value>\S+)$"
)


def _parse_labels(raw: str, line: str) -> Dict[str, str]:
    """Parse the ``k="v",...`` label body with escape handling; raises
    ``ValueError`` on any deviation from the exposition grammar."""
    labels: Dict[str, str] = {}
    i = 0
    n = len(raw)
    while i < n:
        m = re.match(r'([a-zA-Z_][a-zA-Z0-9_]*)="', raw[i:])
        if m is None:
            raise ValueError(f"malformed label body at {raw[i:]!r} in {line!r}")
        key = m.group(1)
        i += m.end()
        value_chars: List[str] = []
        while True:
            if i >= n:
                raise ValueError(f"unterminated label value in {line!r}")
            c = raw[i]
            if c == "\\":
                if i + 1 >= n:
                    raise ValueError(f"dangling escape in {line!r}")
                nxt = raw[i + 1]
                if nxt == "n":
                    value_chars.append("\n")
                elif nxt in ("\\", '"'):
                    value_chars.append(nxt)
                else:
                    raise ValueError(f"illegal escape \\{nxt} in {line!r}")
                i += 2
            elif c == '"':
                i += 1
                break
            else:
                value_chars.append(c)
                i += 1
        if key in labels:
            raise ValueError(f"duplicate label {key!r} in {line!r}")
        labels[key] = "".join(value_chars)
        if i < n:
            if raw[i] != ",":
                raise ValueError(f"expected ',' between labels in {line!r}")
            i += 1
    return labels


def parse_prometheus_text(text: str) -> Dict[str, Dict[str, Any]]:
    """Strict parser for the exposition this module renders.

    Returns ``{family: {"type", "help", "samples": [(labels, value)]}}``.
    Raises ``ValueError`` on: missing trailing newline, samples before
    their ``# TYPE``, interleaved (non-contiguous) families, malformed
    names/labels/escapes, duplicate samples, or non-finite values — the
    test-suite contract that keeps the renderer honest."""
    if text and not text.endswith("\n"):
        raise ValueError("exposition must end with a newline")
    families: Dict[str, Dict[str, Any]] = {}
    closed: set = set()
    current: Optional[str] = None
    for line in text.splitlines():
        if not line:
            raise ValueError("blank line inside exposition")
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            if not _NAME_OK.match(name):
                raise ValueError(f"illegal family name in {line!r}")
            if name in families or name in closed:
                raise ValueError(f"duplicate HELP for {name!r}")
            if current is not None:
                closed.add(current)
            families[name] = {"type": None, "help": help_text, "samples": []}
            current = name
            continue
        if line.startswith("# TYPE "):
            rest = line[len("# TYPE "):]
            name, _, mtype = rest.partition(" ")
            if name != current:
                raise ValueError(f"TYPE for {name!r} outside its block: {line!r}")
            if mtype not in ("counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"unknown metric type in {line!r}")
            families[name]["type"] = mtype
            continue
        if line.startswith("#"):
            continue  # comments are legal exposition
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed sample line {line!r}")
        name = m.group("name")
        base = name
        # counter samples carry the family name verbatim (_total included)
        if base not in families:
            raise ValueError(f"sample {name!r} before its HELP/TYPE block")
        if base != current:
            raise ValueError(f"family {base!r} is not contiguous at {line!r}")
        if families[base]["type"] is None:
            raise ValueError(f"sample for {base!r} before its TYPE line")
        labels = _parse_labels(m.group("labels") or "", line) if m.group("labels") else {}
        try:
            value = float(m.group("value"))
        except ValueError:
            raise ValueError(f"unparseable value in {line!r}")
        if value != value or value in (float("inf"), float("-inf")):
            raise ValueError(f"non-finite value in {line!r}")
        key = tuple(sorted(labels.items()))
        if any(tuple(sorted(l.items())) == key for l, _ in families[base]["samples"]):
            raise ValueError(f"duplicate sample {line!r}")
        families[base]["samples"].append((labels, value))
    return families


# ------------------------------------------------------------------- serving
class ExporterServer:
    """Standalone HTTP exporter: ``GET /metrics`` renders ``fetch()``.

    ``fetch`` returns the exposition string per scrape — the local
    registry by default, or a bridge closure that polls a fleet peer's
    ``obs_snapshot``. A fetch failure answers 503 with the error text
    (a scraper marks the target down instead of ingesting garbage).
    """

    def __init__(
        self,
        port: int,
        fetch: Optional[Callable[[], str]] = None,
        host: str = "127.0.0.1",
    ):
        self.fetch = fetch if fetch is not None else render_registry
        exporter = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (stdlib API name)
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                try:
                    body = exporter.fetch().encode("utf-8")
                except Exception as e:
                    msg = f"scrape failed: {type(e).__name__}: {e}\n".encode()
                    self.send_response(503)
                    self.send_header("Content-Type", "text/plain; charset=utf-8")
                    self.send_header("Content-Length", str(len(msg)))
                    self.end_headers()
                    self.wfile.write(msg)
                    return
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt: str, *args: Any) -> None:
                logger.debug("exporter: " + fmt, *args)

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return int(self._httpd.server_address[1])

    def start(self) -> "ExporterServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="obs-exporter"
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def close(self) -> None:
        # only a background start() needs the cross-thread shutdown
        # handshake; shutting down a server that never served would block
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd.server_close()


def snapshot_fetcher(uri: str, timeout: float = 5.0) -> Callable[[], str]:
    """A fetch closure bridging a fleet peer: each scrape calls the
    peer's ``obs_snapshot`` RPC and renders its metrics section."""
    # CLI-only import: the obs substrate never pulls in the RPC transport
    from hpbandster_tpu_torch.parallel.rpc import RPCProxy

    def fetch() -> str:
        snap = RPCProxy(uri, timeout=timeout).call("obs_snapshot")
        metrics = (snap or {}).get("metrics")
        if not isinstance(metrics, dict):
            raise ValueError(f"obs_snapshot from {uri} has no metrics section")
        return render_snapshot(metrics)

    return fetch


def serve(
    port: int,
    snapshot_uri: Optional[str] = None,
    host: str = "127.0.0.1",
) -> ExporterServer:
    """Build + start a background :class:`ExporterServer`; the CLI's
    foreground mode calls ``serve_forever`` on the returned object."""
    fetch = snapshot_fetcher(snapshot_uri) if snapshot_uri else None
    return ExporterServer(port, fetch=fetch, host=host).start()
