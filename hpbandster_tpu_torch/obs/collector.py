"""Fleet observatory: poll every health endpoint into a time series.

Ported from ``hpbandster_tpu/obs/collector.py`` (a copy).

PRs 2–5 made each fleet process individually legible — ``obs_snapshot``
answers *what is this process doing right now*, the Prometheus exporter
answers *what do its counters read this instant*. Nothing answered the
fleet-level questions the scale-out arc needs: is device memory balanced
across the mesh, are workers churning, is the queue draining, is XLA
compiling more than it should — *over time*.

:class:`FleetCollector` is that aggregation tier. It polls a set of
``obs_snapshot`` endpoints (master, dispatcher, every worker) on an
interval, folds each round into

* an on-disk **series file** — one strict-JSON line per poll round
  (``fleet_sample`` schema), written through the same rotating
  :class:`~hpbandster_tpu_torch.obs.journal.JsonlJournal` machinery as run
  journals, so disk stays bounded however long the fleet runs;
* a bounded **in-memory window** (the newest ``window`` samples) that
  the ``obs top`` dashboard and trend math read;
* **derived fleet gauges** republished through the shared metrics
  registry (``fleet.*``), so the Prometheus exporter and the anomaly
  detector's ``fleet_imbalance`` / ``worker_churn`` rules see them with
  zero extra wiring:

  - ``fleet.endpoints`` / ``fleet.endpoints_ok`` / ``fleet.endpoints_stale``
  - ``fleet.workers_alive`` / ``fleet.queue_depth`` / ``fleet.jobs_in_flight``
  - ``fleet.device_mem_utilization`` — bytes in use / limit, fleet-wide
  - ``fleet.device_mem_skew`` — (max - min)/max over per-device busy
    bytes: the balance number the mesh-sharding arc reads
  - ``fleet.device_compute_skew`` — worst per-endpoint (max - min)/max
    over per-device sharded-sweep config counts
    (``sweep.device.<i>.configs``, published by
    ``parallel.multihost.publish_device_balance``; counts are only
    comparable within one sweep, so endpoints are judged separately and
    the fleet gauge is the worst of them): the compute-balance sibling
    of the memory skew — on an SPMD mesh all devices step in lockstep,
    so row-count imbalance IS step-time imbalance. The gauge describes
    each endpoint's MOST RECENT sharded sweep
  - ``fleet.worker_churn_per_min`` — worker drops + endpoint losses
  - ``fleet.queue_depth_trend_per_min`` — signed queue drain/growth rate
  - ``fleet.compile_rate_per_min`` — fresh XLA compiles across the fleet

Failure containment is the design center: every endpoint is polled with
its own socket timeout, so a dead or *hung* peer costs one bounded
timeout, never a stalled loop; the failed endpoint's row records the
gap (``ok=False`` + ``stale_s``) and its disappearance counts into the
churn rate. The collector never raises out of its poll loop.

One poll round also emits one ``fleet_sample`` event onto the bus, so a
configured journal retains the fleet story and the streaming anomaly
detector sees the derived gauges the moment they are computed —
:func:`~hpbandster_tpu_torch.obs.anomaly.scan_records` over a series file
replays the same rules offline (tested parity).

Like ``health.py``, this module is transport-lazy: ``parallel/rpc.py``
imports only inside the default fetcher, so the obs substrate stays
stdlib-only at import.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

from hpbandster_tpu_torch.obs import events as E
from hpbandster_tpu_torch.obs.device_metrics import device_metric_fields
from hpbandster_tpu_torch.obs.journal import JsonlJournal
from hpbandster_tpu_torch.obs.metrics import MetricsRegistry, get_metrics

__all__ = [
    "EndpointState",
    "FleetCollector",
    "derive_fleet",
    "format_fleet_table",
    "read_series",
    "read_series_tail",
    "tenant_counters",
]

logger = E.logger


def _rpc_fetch(uri: str, timeout: float) -> Dict[str, Any]:
    """Default snapshot fetcher: one ``obs_snapshot`` RPC with its own
    socket timeout (connect and read both bounded — a hung peer costs
    ``timeout`` seconds, not a stalled collector)."""
    # lazy: the obs substrate never pulls in the RPC transport at import
    from hpbandster_tpu_torch.parallel.rpc import RPCProxy

    snap = RPCProxy(uri, timeout=timeout).call("obs_snapshot")
    if not isinstance(snap, dict):
        raise ValueError(f"obs_snapshot from {uri} returned {type(snap).__name__}")
    return snap


class EndpointState:
    """Per-endpoint staleness bookkeeping (one instance per known URI)."""

    __slots__ = (
        "name", "uri", "ok", "ever_ok", "last_ok_mono", "last_error",
        "consecutive_failures", "last_snapshot", "last_counters",
    )

    def __init__(self, name: str, uri: str):
        self.name = name
        self.uri = uri
        self.ok = False
        self.ever_ok = False
        self.last_ok_mono: Optional[float] = None
        self.last_error: Optional[str] = None
        self.consecutive_failures = 0
        self.last_snapshot: Optional[Dict[str, Any]] = None
        #: counters cut at the last successful poll (rate math)
        self.last_counters: Dict[str, float] = {}

    def stale_s(self, now_mono: float) -> Optional[float]:
        """Seconds since the last successful poll; None if never polled
        successfully (a peer that has not come up yet is not *stale*)."""
        if self.last_ok_mono is None:
            return None
        return max(now_mono - self.last_ok_mono, 0.0)


def _num(x: Any) -> Optional[float]:
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        return None
    return float(x) if math.isfinite(x) else None


def tenant_counters(
    counters: Mapping[str, Any], field: str = "configs_done"
) -> Dict[str, Any]:
    """``{tenant: value}`` for every ``serve.tenant.<t>.<field>`` counter
    — the ONE parser of the serving tier's per-tenant metric names
    (serve/pool.py emits them; this module and summarize's watch line
    both read them)."""
    prefix, suffix = "serve.tenant.", f".{field}"
    out: Dict[str, Any] = {}
    for name, value in counters.items():
        if name.startswith(prefix) and name.endswith(suffix):
            tenant = name[len(prefix):-len(suffix)]
            if tenant:
                out[tenant] = value
    return out


def lane_gauges(gauges: Mapping[str, Any]) -> Dict[str, Any]:
    """``{field: value}`` for the continuous-batching lane gauges
    (``serve/continuous.py``): ``total``/``occupied``/``starved`` from
    ``serve.lanes.*``, ``occupancy`` from ``serve.lane_occupancy``, and
    ``warm_age_s`` = the OLDEST family's program-warm age (plus
    ``families``, the resident-program count) from the
    ``serve.family.<f>.warm_age_s`` family. THE one parser of these
    names — the ``top`` lane line and ``watch --snapshot``'s lanes part
    both read through it."""
    out: Dict[str, Any] = {}
    ages = []
    for name, value in (gauges or {}).items():
        if not isinstance(name, str):
            continue
        v = _num(value)
        if v is None:
            continue
        if name == "serve.lane_occupancy":
            out["occupancy"] = v
        elif name.startswith("serve.lanes."):
            out[name[len("serve.lanes."):]] = v
        elif name.startswith("serve.family.") and name.endswith(
            ".warm_age_s"
        ):
            ages.append(v)
    if ages:
        out["warm_age_s"] = max(ages)
        out["families"] = len(ages)
    return out


def slo_gauges(gauges: Mapping[str, Any]) -> Dict[str, Any]:
    """``{worst_burn_rate, firing, slos}`` from the SLO gauge plane
    (``obs/alerts.py`` publishes ``slo.<name>.{burn_rate,
    budget_remaining,state}``): worst burn rate across specs, count of
    specs currently firing (state >= 2 per ``alerts.STATE_CODES``), and
    the spec census. THE one parser of these names — the ``top`` fleet
    SLO line, ``watch --snapshot``'s slo column, and the endpoint row
    all read through it. Empty dict when the endpoint runs no
    AlertManager, so SLO-free fleets render exactly as before."""
    worst: Optional[float] = None
    firing = 0
    slos = 0
    for name, value in (gauges or {}).items():
        if not isinstance(name, str) or not name.startswith("slo."):
            continue
        v = _num(value)
        if v is None:
            continue
        if name.endswith(".state"):
            slos += 1
            if v >= 2:
                firing += 1
        elif name.endswith(".burn_rate"):
            if worst is None or v > worst:
                worst = v
    if slos == 0 and worst is None:
        return {}
    return {"worst_burn_rate": worst, "firing": firing, "slos": slos}


def _endpoint_row(snap: Dict[str, Any]) -> Dict[str, Any]:
    """Distill one ``obs_snapshot`` into the per-endpoint series row: the
    handful of fields fleet aggregation and ``top`` actually read."""
    metrics = snap.get("metrics") or {}
    gauges = metrics.get("gauges") or {}
    counters = metrics.get("counters") or {}
    runtime = snap.get("runtime") or {}
    compile_led = runtime.get("compile") or {}
    devices = (runtime.get("devices") or {}).get("devices") or {}
    dev_rows = {}
    for i, d in devices.items():
        if isinstance(d, dict):
            dev_rows[str(i)] = {
                k: d.get(k)
                for k in ("bytes_in_use", "bytes_limit", "live_bytes")
                if d.get(k) is not None
            }
    alerts = snap.get("alerts") or {}
    # serving-tier census (serve/pool.py): per-tenant configs_done
    # counters fold into one {tenant: done} map per endpoint — what the
    # fleet fairness ratio and the `top` tenant column aggregate
    tenants: Dict[str, float] = {}
    for tenant, value in tenant_counters(counters).items():
        v = _num(value)
        if v is not None:
            tenants[tenant] = v
    # sharded-sweep balance census (parallel/multihost.py
    # publish_device_balance): per-device config counts fold into
    # {device: {configs, pad_rows}} — what fleet.device_compute_skew
    # aggregates across endpoints
    sweep_devices: Dict[str, Dict[str, float]] = {}
    for name, value in gauges.items():
        if not name.startswith("sweep.device."):
            continue
        dev, _, field = name[len("sweep.device."):].partition(".")
        v = _num(value)
        if dev and field and v is not None:
            sweep_devices.setdefault(dev, {})[field] = v
    # device metrics plane (obs/device_metrics.py): the last sweep's
    # decoded in-trace telemetry totals — what `top` renders as the
    # device-telemetry line and watch --snapshot appends per row (ONE
    # gauge-name parser, shared with the watch renderer)
    device_metrics = device_metric_fields(gauges)
    # continuous-batching lane census (serve/continuous.py): occupancy,
    # starved lanes and program-warm age — the `top` lane line and the
    # watch lanes part (ONE parser, lane_gauges)
    lanes = lane_gauges(gauges)
    # SLO plane (obs/alerts.py): worst burn rate + firing count per
    # endpoint — what the fleet verdict rolls up (ONE parser, slo_gauges)
    slo = slo_gauges(gauges)
    return {
        "component": snap.get("component"),
        "uptime_s": _num(snap.get("uptime_s")),
        "in_flight": snap.get("in_flight"),
        "workers_alive": _num(gauges.get("dispatcher.workers_alive")),
        "queue_depth": _num(gauges.get("dispatcher.queue_depth")),
        "jobs_in_flight": _num(gauges.get("dispatcher.jobs_in_flight")),
        "workers_dropped": _num(counters.get("dispatcher.workers_dropped")),
        "compiles": _num(counters.get("runtime.compiles"))
        or _num(compile_led.get("total_compiles")),
        "top_recompilers": _top_recompilers(compile_led),
        "devices": dev_rows,
        "sweep_devices": sweep_devices,
        "device_metrics": device_metrics,
        "lanes": lanes,
        "slo": slo,
        "alerts_total": _num(alerts.get("total")),
        "tenants": tenants,
    }


def _top_recompilers(compile_led: Dict[str, Any], k: int = 3) -> List[Dict[str, Any]]:
    fns = compile_led.get("functions") or {}
    rows = [
        {"fn": fn, "compiles": int(slot.get("compiles") or 0)}
        for fn, slot in fns.items()
        if isinstance(slot, dict)
    ]
    rows.sort(key=lambda r: (-r["compiles"], r["fn"]))
    return rows[:k]


def _device_balance(
    rows: Mapping[str, Dict[str, Any]]
) -> Tuple[Optional[float], Optional[float]]:
    """(utilization, skew) over every device of every polled endpoint.

    Utilization is fleet bytes-in-use / bytes-limit where the backend
    reports memory stats (TPU/GPU). Skew is (max-min)/max over each
    device's *busy* bytes — ``bytes_in_use`` when available, else the
    ``live_bytes`` census (the CPU-visible signal) — the imbalance
    number a config-sharded mesh must hold near zero.
    """
    in_use_total = 0.0
    limit_total = 0.0
    busy: List[float] = []
    for row in rows.values():
        for d in (row.get("devices") or {}).values():
            iu = _num(d.get("bytes_in_use"))
            lim = _num(d.get("bytes_limit"))
            lv = _num(d.get("live_bytes"))
            if iu is not None and lim:
                in_use_total += iu
                limit_total += lim
            b = iu if iu is not None else lv
            if b is not None:
                busy.append(b)
    utilization = (in_use_total / limit_total) if limit_total else None
    skew = None
    if busy:
        hi = max(busy)
        skew = 0.0 if hi <= 0 else (hi - min(busy)) / hi
    return utilization, skew


def _compute_balance(rows: Mapping[str, Dict[str, Any]]) -> Optional[float]:
    """Worst PER-ENDPOINT (max-min)/max over per-device sharded-sweep
    config counts — the compute-balance sibling of
    :func:`_device_balance`'s memory skew.

    Config counts are only comparable WITHIN one sweep: pooling absolute
    counts across endpoints would read two perfectly balanced sweeps of
    different sizes (a 1M run next to a 10k run) as severe imbalance. So
    the skew is computed per endpoint (each endpoint's gauges describe
    its own most recent sharded sweep) and the fleet gauge is the worst
    of them. SPMD meshes step in lockstep, so row-count imbalance is
    step-time imbalance; None when no endpoint has published sweep
    balance gauges."""
    worst: Optional[float] = None
    for row in rows.values():
        configs = [
            c
            for dv in (row.get("sweep_devices") or {}).values()
            if (c := _num(dv.get("configs"))) is not None
        ]
        if not configs:
            continue
        hi = max(configs)
        skew = 0.0 if hi <= 0 else (hi - min(configs)) / hi
        worst = skew if worst is None else max(worst, skew)
    return worst


def derive_fleet(
    rows: Mapping[str, Dict[str, Any]],
    ok: int,
    stale: int,
    lost: int,
    churn_events: int,
) -> Dict[str, Any]:
    """Fold per-endpoint rows into the derived fleet gauges of one round.

    Pure function of its inputs (no clocks, no registry) so the offline
    scan and the tests compute exactly what the live collector publishes;
    rate/trend fields are filled in by the collector, which owns the
    window."""
    utilization, skew = _device_balance(rows)
    compute_skew = _compute_balance(rows)

    def _sum(field: str) -> Optional[float]:
        vals = [_num(r.get(field)) for r in rows.values()]
        vals = [v for v in vals if v is not None]
        return sum(vals) if vals else None

    # the dispatcher's workers_alive gauge is ping-loop-paced (can lag a
    # whole ping_interval behind); the endpoint census itself is the
    # fallback truth — every ok endpoint announcing component=worker
    workers_alive = _sum("workers_alive")
    if workers_alive is None and rows:
        workers_alive = float(sum(
            1 for r in rows.values()
            if r.get("ok") and r.get("component") == "worker"
        ))

    # multi-tenant fairness (serve/pool.py): cumulative configs_done per
    # tenant summed over every endpoint; the max/min ratio is the fleet's
    # one-number fairness gauge (1.0 = perfectly even service; None with
    # <2 tenants or before the slowest tenant's first delivery — a ratio
    # over a zero denominator would read as infinite unfairness during
    # warmup, which is noise, not signal)
    tenant_done: Dict[str, float] = {}
    for r in rows.values():
        for tenant, done in (r.get("tenants") or {}).items():
            v = _num(done)
            if v is not None:
                tenant_done[tenant] = tenant_done.get(tenant, 0.0) + v
    ratio = None
    if len(tenant_done) >= 2 and min(tenant_done.values()) > 0:
        ratio = round(
            max(tenant_done.values()) / min(tenant_done.values()), 4
        )
    # the ratio's None-during-warmup blind spot must not hide PERMANENT
    # starvation: tenants stuck at zero while others progress get their
    # own count, so an alert can fire on exactly the case the ratio
    # cannot express
    starved = None
    if tenant_done:
        starved = (
            sum(1 for v in tenant_done.values() if v == 0)
            if any(v > 0 for v in tenant_done.values()) else 0
        )

    # fleet SLO verdict: worst burn rate across every endpoint's specs,
    # total firing count — one number pair that says whether the fleet
    # is inside its objectives (None when no endpoint runs SLOs)
    slo_worst: Optional[float] = None
    slo_firing: Optional[float] = None
    for r in rows.values():
        s = r.get("slo") or {}
        w = _num(s.get("worst_burn_rate"))
        if w is not None and (slo_worst is None or w > slo_worst):
            slo_worst = w
        f = _num(s.get("firing"))
        if f is not None:
            slo_firing = (slo_firing or 0.0) + f

    return {
        "endpoints": len(rows),
        "ok": ok,
        "stale": stale,
        "lost": lost,
        "churn_events": churn_events,
        "workers_alive": workers_alive,
        "queue_depth": _sum("queue_depth"),
        "jobs_in_flight": _sum("jobs_in_flight"),
        "compiles": _sum("compiles"),
        "device_mem_utilization": (
            round(utilization, 4) if utilization is not None else None
        ),
        "device_mem_skew": round(skew, 4) if skew is not None else None,
        "device_compute_skew": (
            round(compute_skew, 4) if compute_skew is not None else None
        ),
        "tenants": len(tenant_done) if tenant_done else None,
        "tenants_starved": starved,
        "tenant_throughput_ratio": ratio,
        "slo_worst_burn_rate": (
            round(slo_worst, 4) if slo_worst is not None else None
        ),
        "slo_firing": int(slo_firing) if slo_firing is not None else None,
    }


EndpointSpec = Union[
    Sequence[str],
    Mapping[str, str],
    Callable[[], Mapping[str, str]],
]


class FleetCollector:
    """Poll ``obs_snapshot`` endpoints into a windowed fleet time series.

    ``endpoints`` is a list of URIs, a ``{name: uri}`` mapping, or a
    zero-arg callable returning one — the callable form is how the
    master tracks an *elastic* fleet (workers join and leave between
    rounds; the collector re-reads the listing every round and keeps
    staleness state per URI).

    ``poll_once()`` runs one round synchronously (tests and the ``top``
    CLI drive it directly); ``start()`` spawns the daemon poll thread.
    Every round is bounded: each endpoint gets its own ``timeout_s``
    socket timeout, failures are recorded as the gap they are, and
    nothing propagates out of the loop.
    """

    def __init__(
        self,
        endpoints: EndpointSpec,
        interval_s: float = 2.0,
        series_path: Optional[str] = None,
        timeout_s: Optional[float] = None,
        window: int = 256,
        stale_after_s: Optional[float] = None,
        churn_window_s: float = 600.0,
        lost_after_failures: int = 2,
        registry: Optional[MetricsRegistry] = None,
        bus: Optional[E.EventBus] = None,
        series_max_bytes: int = 16 * 1024 * 1024,
        series_max_files: int = 3,
        fetch: Optional[Callable[[str, float], Dict[str, Any]]] = None,
    ):
        self.interval_s = max(float(interval_s), 0.05)
        #: per-endpoint socket timeout; defaults to the poll interval
        #: (capped at 5 s) so one hung peer cannot eat multiple rounds
        self.timeout_s = (
            float(timeout_s) if timeout_s is not None
            else min(max(self.interval_s, 0.5), 5.0)
        )
        #: an endpoint unpolled this long is *stale* even if the last
        #: attempt nominally succeeded (default: 3 poll intervals)
        self.stale_after_s = (
            float(stale_after_s) if stale_after_s is not None
            else 3.0 * self.interval_s
        )
        self.churn_window_s = float(churn_window_s)
        #: consecutive failed polls before a once-ok endpoint counts as a
        #: churn event — one missed round is routinely a GIL stall (the
        #: peer's reply thread blocked behind an XLA compile), not a death
        self.lost_after_failures = max(int(lost_after_failures), 1)
        self._endpoints_spec = endpoints
        self._registry = registry
        self._bus = bus
        self._fetch = fetch if fetch is not None else _rpc_fetch
        self._lock = threading.Lock()
        self._states: Dict[str, EndpointState] = {}
        self._window: collections.deque = collections.deque(
            maxlen=max(int(window), 2)
        )
        #: monotonic stamps of churn events (drops + endpoint losses)
        self._churn_times: collections.deque = collections.deque(maxlen=1024)
        self._seq = 0
        self._journal: Optional[JsonlJournal] = None
        if series_path is not None:
            self._journal = JsonlJournal(
                series_path, max_bytes=series_max_bytes,
                max_files=series_max_files,
            )
        self.series_path = series_path
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pool: Optional[Any] = None

    # ------------------------------------------------------------- endpoints
    def _resolve_endpoints(self) -> Dict[str, str]:
        spec = self._endpoints_spec
        try:
            listing = spec() if callable(spec) else spec
        except Exception:
            # an elastic listing source mid-teardown must not kill the loop
            logger.exception("fleet collector endpoint listing failed")
            with self._lock:
                return {name: st.uri for name, st in self._states.items()}
        if isinstance(listing, Mapping):
            return {str(k): str(v) for k, v in listing.items()}
        return {str(u): str(u) for u in (listing or ())}

    # ----------------------------------------------------------------- round
    def poll_once(self) -> Dict[str, Any]:
        """One poll round; returns (and retains) the ``fleet_sample``
        record that was written/emitted."""
        now_mono = time.monotonic()
        listing = self._resolve_endpoints()
        unlisted_lost = 0
        with self._lock:
            for name, uri in listing.items():
                st = self._states.get(name)
                if st is None or st.uri != uri:
                    # a same-name listing whose URI moved is a restart:
                    # the old endpoint is gone, which is churn exactly
                    # like an unlisted one (a worker flapping onto a
                    # fresh port each cycle must not read as zero churn)
                    if st is not None and st.ever_ok:
                        self._churn_times.append(now_mono)
                        unlisted_lost += 1
                    self._states[name] = EndpointState(name, uri)
            # unlisted endpoints are forgotten — an elastic fleet shrinks;
            # a vanished-but-once-ok endpoint counts as churn (tallied
            # into this round's lost/churn_events below, so the sample's
            # fields agree with the rate they feed)
            for name in list(self._states):
                if name not in listing:
                    st = self._states.pop(name)
                    if st.ever_ok:
                        self._churn_times.append(now_mono)
                        unlisted_lost += 1
            targets = list(self._states.values())

        rows: Dict[str, Dict[str, Any]] = {}
        ok = stale = streak_lost = 0
        drops_delta = 0.0
        # endpoints poll CONCURRENTLY: N unreachable peers cost one
        # socket timeout of wall clock, not N serial ones — the round
        # stays bounded however much of the fleet is down (each endpoint
        # has exactly one poller thread; state writes don't race)
        if len(targets) > 1:
            results = list(self._ensure_pool().map(
                self._poll_endpoint, targets))
        else:
            results = [self._poll_endpoint(st) for st in targets]
        for st, (row, churned, drop_delta) in zip(targets, results):
            rows[st.name] = row
            if row["ok"]:
                ok += 1
            if churned:
                streak_lost += 1
            drops_delta += drop_delta
            stale_s = row.get("stale_s")
            if stale_s is not None and stale_s > self.stale_after_s:
                stale += 1
        # losses this round = endpoints unlisted (stamped above) +
        # failure streaks; worker drops observed by the dispatcher count
        # into the same churn stream (one monotonic stamp per event —
        # unlisted stamps were already appended in the listing block)
        lost = unlisted_lost + streak_lost
        churn_events = lost + int(drops_delta)
        now_mono = time.monotonic()
        with self._lock:
            for _ in range(int(drops_delta) + streak_lost):
                self._churn_times.append(now_mono)
            churn_per_min = self._churn_per_min_locked(now_mono)

        fleet = derive_fleet(rows, ok=ok, stale=stale, lost=lost,
                             churn_events=churn_events)
        fleet["worker_churn_per_min"] = churn_per_min
        sample = {
            "event": "fleet_sample",
            "t_wall": time.time(),
            "t_mono": now_mono,
            "seq": self._seq,
            "fleet": fleet,
            "endpoints": {name: rows[name] for name in sorted(rows)},
        }
        self._seq += 1
        with self._lock:
            self._window.append(sample)
            trend, compile_rate = self._trends_locked()
        fleet["queue_depth_trend_per_min"] = trend
        fleet["compile_rate_per_min"] = compile_rate
        self._publish(fleet)
        if self._journal is not None:
            try:
                # sort_keys: two collectors over the same fleet state
                # produce byte-identical lines (modulo clocks) — the
                # determinism bar the series readers rely on
                self._journal.write_record(_sorted_record(sample))
            except Exception:
                logger.exception("fleet series write failed")
        bus = self._bus if self._bus is not None else E.get_bus()
        bus.emit(E.FLEET_SAMPLE, **_flat_fields(sample))
        return sample

    def _poll_endpoint(
        self, st: EndpointState
    ) -> Tuple[Dict[str, Any], bool, float]:
        """Poll one endpoint; returns (series row, lost-this-round,
        dispatcher worker-drop delta). Never raises."""
        snap: Optional[Dict[str, Any]] = None
        distilled: Optional[Dict[str, Any]] = None
        t0 = time.monotonic()
        try:
            snap = self._fetch(st.uri, self.timeout_s)
            # distilling INSIDE the try: a version-skewed peer answering
            # with an unexpected structure is a gap, not a collector
            # crash — the 'never raises' contract covers both steps
            distilled = _endpoint_row(snap)
        except Exception as e:
            st.ok = False
            st.consecutive_failures += 1
            st.last_error = f"{type(e).__name__}: {e}"
        drop_delta = 0.0
        if distilled is not None:
            st.ok = True
            st.ever_ok = True
            st.consecutive_failures = 0
            st.last_error = None
            st.last_ok_mono = time.monotonic()
            st.last_snapshot = snap
        now_mono = time.monotonic()
        row: Dict[str, Any] = {
            "uri": st.uri,
            "ok": st.ok,
            "poll_s": round(now_mono - t0, 6),
            "stale_s": (
                round(st.stale_s(now_mono), 3)
                if st.stale_s(now_mono) is not None else None
            ),
            "consecutive_failures": st.consecutive_failures,
            "error": st.last_error,
        }
        if distilled is not None:
            dropped = _num(distilled.get("workers_dropped"))
            if dropped is not None:
                prev = st.last_counters.get("workers_dropped")
                if prev is not None and dropped > prev:
                    drop_delta = dropped - prev
                st.last_counters["workers_dropped"] = dropped
            row.update(distilled)
        # a churn event fires once per failure STREAK, and only after
        # lost_after_failures consecutive misses of a once-ok endpoint
        # (one missed round is routinely a peer GIL-stalled in a compile)
        lost = (
            st.ever_ok
            and st.consecutive_failures == self.lost_after_failures
        )
        return row, lost, drop_delta

    # ------------------------------------------------------------- windows
    def _churn_per_min_locked(self, now_mono: float) -> float:
        while self._churn_times and now_mono - self._churn_times[0] > self.churn_window_s:
            self._churn_times.popleft()
        # fixed-window denominator: events / churn_window_s — a freshly
        # started collector must not report one early drop as a storm
        return round(len(self._churn_times) * 60.0 / self.churn_window_s, 4)

    def _trends_locked(self) -> Tuple[Optional[float], Optional[float]]:
        """(queue-depth slope per minute, compile rate per minute) over
        the in-memory window — newest minus oldest over elapsed time,
        which is robust to missed rounds in a way per-round deltas are
        not."""
        if len(self._window) < 2:
            return None, None
        first, last = self._window[0], self._window[-1]
        dt = last["t_mono"] - first["t_mono"]
        if dt <= 0:
            return None, None

        def rate(field: str, monotone: bool) -> Optional[float]:
            a = _num(first["fleet"].get(field))
            b = _num(last["fleet"].get(field))
            if a is None or b is None:
                return None
            delta = b - a
            if monotone and delta < 0:
                # a counter went backwards: an endpoint restarted — treat
                # the window as unmeasurable rather than report negative
                return None
            return round(delta * 60.0 / dt, 4)

        return rate("queue_depth", False), rate("compiles", True)

    def _publish(self, fleet: Dict[str, Any]) -> None:
        reg = self._registry if self._registry is not None else get_metrics()
        for field, gauge in (
            ("endpoints", "fleet.endpoints"),
            ("ok", "fleet.endpoints_ok"),
            ("stale", "fleet.endpoints_stale"),
            ("workers_alive", "fleet.workers_alive"),
            ("queue_depth", "fleet.queue_depth"),
            ("jobs_in_flight", "fleet.jobs_in_flight"),
            ("device_mem_utilization", "fleet.device_mem_utilization"),
            ("device_mem_skew", "fleet.device_mem_skew"),
            ("device_compute_skew", "fleet.device_compute_skew"),
            ("worker_churn_per_min", "fleet.worker_churn_per_min"),
            ("queue_depth_trend_per_min", "fleet.queue_depth_trend_per_min"),
            ("compile_rate_per_min", "fleet.compile_rate_per_min"),
            ("tenants", "fleet.tenants"),
            ("tenants_starved", "fleet.tenants_starved"),
            ("tenant_throughput_ratio", "fleet.tenant_throughput_ratio"),
            ("slo_worst_burn_rate", "fleet.slo_worst_burn_rate"),
            ("slo_firing", "fleet.slo_firing"),
        ):
            v = _num(fleet.get(field))
            if v is not None:
                reg.gauge(gauge).set(v)
            else:
                # a gauge whose source became unmeasurable must be
                # dropped, not frozen: a dead dispatcher's last
                # queue_depth would otherwise serve as live forever
                reg.remove(gauge)
        reg.counter("fleet.poll_rounds").inc()

    def _ensure_pool(self) -> Any:
        """The persistent poller pool: threads are reused across rounds
        (per-round executor spawn/join would tax every 2 s duty cycle
        for the life of the sweep). Capacity 16 caps the concurrent
        socket count; threads only materialize on demand."""
        with self._lock:
            if self._pool is None:
                import concurrent.futures

                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=16, thread_name_prefix="obs-fleet-poll"
                )
            return self._pool

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "FleetCollector":
        """Spawn the daemon poll thread (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="obs-fleet-collector"
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                self.poll_once()
            except Exception:
                # the observatory must never take the fleet down
                logger.exception("fleet collector poll round failed")
            # drift-free cadence: the round's own cost comes out of the
            # wait, so the effective period stays ~interval_s even when
            # part of the fleet is timing out
            elapsed = time.monotonic() - t0
            if self._stop.wait(max(self.interval_s - elapsed, 0.05)):
                return

    def stop(self) -> None:
        """Stop the poll thread and close the series file (idempotent)."""
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
            pool, self._pool = self._pool, None
        if thread is not None:
            thread.join(timeout=max(2 * self.timeout_s, 5.0))
        if pool is not None:
            # don't block on a hung peer's in-flight poll; its thread is
            # daemon-irrelevant once the loop is down
            pool.shutdown(wait=False)
        if self._journal is not None:
            self._journal.close()

    def __enter__(self) -> "FleetCollector":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # ----------------------------------------------------------- inspection
    def window(self) -> List[Dict[str, Any]]:
        """Oldest-first copy of the in-memory sample window."""
        with self._lock:
            return list(self._window)

    def last_sample(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._window[-1] if self._window else None

    def last_snapshots(self) -> Dict[str, Optional[Dict[str, Any]]]:
        """Newest full ``obs_snapshot`` per endpoint (None before the
        first success) — what ``watch --snapshot`` renders per row."""
        with self._lock:
            return {
                name: st.last_snapshot
                for name, st in sorted(self._states.items())
            }

    def endpoint_states(self) -> Dict[str, Dict[str, Any]]:
        """Staleness view per endpoint (the ``watch --snapshot`` merge)."""
        now = time.monotonic()
        with self._lock:
            return {
                name: {
                    "uri": st.uri,
                    "ok": st.ok,
                    "stale_s": st.stale_s(now),
                    "consecutive_failures": st.consecutive_failures,
                    "error": st.last_error,
                }
                for name, st in sorted(self._states.items())
            }


def _sorted_record(x: Any) -> Any:
    """Recursively key-sort dicts so a series line's byte layout is a
    function of its content only."""
    if isinstance(x, dict):
        return {k: _sorted_record(x[k]) for k in sorted(x)}
    if isinstance(x, (list, tuple)):
        return [_sorted_record(v) for v in x]
    return x


def _flat_fields(sample: Dict[str, Any]) -> Dict[str, Any]:
    """The bus-event form of one sample: derived fleet gauges flattened
    to top-level fields (what the anomaly rules key on) plus the compact
    endpoint census."""
    fleet = sample["fleet"]
    return {
        "seq": sample["seq"],
        **{k: v for k, v in fleet.items()},
        "endpoint_names": sorted(sample["endpoints"]),
    }


def read_series(path: str) -> List[Dict[str, Any]]:
    """Read a (possibly rotated) series file, oldest first — the same
    reader contract as run journals (corrupt lines skipped)."""
    from hpbandster_tpu_torch.obs.journal import read_journal

    return [r for r in read_journal(path) if r.get("event") == "fleet_sample"]


def read_series_tail(
    path: str, max_scan_bytes: int = 1 << 20
) -> Optional[Dict[str, Any]]:
    """Newest ``fleet_sample`` without parsing the whole rotated set —
    a refreshing dashboard needs one frame per tick, not the history.
    Scans only the live file's final bytes; falls back to the full
    :func:`read_series` when the live file holds no complete sample
    (e.g. freshly rotated)."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(size - max_scan_bytes, 0))
            chunk = f.read()
    except OSError:
        chunk = b""
    for line in reversed(chunk.splitlines()):
        try:
            rec = json.loads(line)
        except ValueError:
            # a truncated first line of the scan window, or a corrupt
            # line — same skip contract as read_journal
            continue
        if isinstance(rec, dict) and rec.get("event") == "fleet_sample":
            return rec
    recs = read_series(path)
    return recs[-1] if recs else None


# ------------------------------------------------------------------ top view
def _fmt(v: Any, nd: int = 0, dash: str = "-") -> str:
    if v is None:
        return dash
    if isinstance(v, float):
        return f"{v:.{nd}f}" if nd else f"{v:g}"
    return str(v)


def format_fleet_table(
    sample: Dict[str, Any], tenant: Optional[str] = None
) -> str:
    """Render one ``fleet_sample`` as the ``obs top`` fleet table.

    ``tenant`` narrows the view to endpoints serving that tenant; the
    per-endpoint ``tenants`` column then shows the tenant's own
    ``configs_done`` instead of the serving tenant count.
    """
    fleet = sample.get("fleet") or {}
    lines = [
        "fleet: endpoints {}/{} ok ({} stale)  workers={}  queue={}  "
        "in_flight={}".format(
            _fmt(fleet.get("ok")), _fmt(fleet.get("endpoints")),
            _fmt(fleet.get("stale")), _fmt(fleet.get("workers_alive")),
            _fmt(fleet.get("queue_depth")), _fmt(fleet.get("jobs_in_flight")),
        ),
        "       mem_util={}  mem_skew={}  compute_skew={}  churn/min={}  "
        "queue_trend/min={}  compiles/min={}".format(
            _fmt(fleet.get("device_mem_utilization"), 3),
            _fmt(fleet.get("device_mem_skew"), 3),
            _fmt(fleet.get("device_compute_skew"), 3),
            _fmt(fleet.get("worker_churn_per_min"), 2),
            _fmt(fleet.get("queue_depth_trend_per_min"), 2),
            _fmt(fleet.get("compile_rate_per_min"), 2),
        ),
    ]
    if fleet.get("tenants") is not None or tenant is not None:
        lines.append(
            "       tenants={}  throughput_ratio={}{}".format(
                _fmt(fleet.get("tenants")),
                _fmt(fleet.get("tenant_throughput_ratio"), 2),
                f"  [filter: tenant={tenant}]" if tenant else "",
            )
        )
    # device-telemetry section: aggregate the per-endpoint last-sweep
    # in-trace counters (obs/device_metrics.py) — present only when at
    # least one endpoint published them, so telemetry-free fleets render
    # exactly as before
    dm_rows = [
        row.get("device_metrics")
        for row in (sample.get("endpoints") or {}).values()
        if row.get("device_metrics")
    ]
    if dm_rows:
        evals = sum(int(r.get("evaluations", 0)) for r in dm_rows)
        crashes = sum(int(r.get("crashes", 0)) for r in dm_rows)
        rounds = sum(int(r.get("rounds", 0)) for r in dm_rows)
        fits = sum(int(r.get("model_fits", 0)) for r in dm_rows)
        lines.append(
            "       device_telemetry: evals={}  crashed={}{}  rounds={}  "
            "model_fits={}".format(
                evals, crashes,
                " ({:.2f}%)".format(100.0 * crashes / evals)
                if evals else "",
                rounds, fits,
            )
        )
    # continuous-batching lane line (serve/continuous.py gauges):
    # present only when an endpoint serves resident lane programs, so
    # lane-free fleets render exactly as before
    lane_rows = [
        row.get("lanes")
        for row in (sample.get("endpoints") or {}).values()
        if row.get("lanes")
    ]
    if lane_rows:
        total = sum(int(r.get("total", 0)) for r in lane_rows)
        occupied = sum(int(r.get("occupied", 0)) for r in lane_rows)
        starved = sum(int(r.get("starved", 0)) for r in lane_rows)
        ages = [
            r.get("warm_age_s") for r in lane_rows
            if isinstance(r.get("warm_age_s"), (int, float))
        ]
        lines.append(
            "       lanes: occupied={}/{}  starved={}  warm_age_s={}"
            .format(
                occupied, total, starved,
                _fmt(max(ages), 1) if ages else "-",
            )
        )
    # SLO verdict line (obs/alerts.py gauges via slo_gauges): present
    # only when an endpoint runs an AlertManager, so SLO-free fleets
    # render exactly as before
    if (
        fleet.get("slo_worst_burn_rate") is not None
        or fleet.get("slo_firing") is not None
    ):
        lines.append(
            "       slo: worst_burn={}  firing={}".format(
                _fmt(fleet.get("slo_worst_burn_rate"), 2),
                _fmt(fleet.get("slo_firing")),
            )
        )
    lines.append("")
    header = (
        f"{'endpoint':<18} {'comp':<10} {'ok':<3} {'up_s':>8} "
        f"{'stale_s':>8} {'inflight':<14} {'alerts':>6} {'compiles':>8} "
        f"{'tenants':>8}  top_recompilers"
    )
    lines.append(header)
    lines.append("-" * len(header))
    for name, row in sorted((sample.get("endpoints") or {}).items()):
        tenants = row.get("tenants") or {}
        if tenant is not None and tenant not in tenants:
            continue
        in_flight = row.get("in_flight")
        if isinstance(in_flight, dict):
            in_flight = ",".join(
                f"{k}={v}" for k, v in sorted(in_flight.items())
                if not isinstance(v, (list, dict))
            ) or "busy"
        recomp = " ".join(
            f"{r['fn']}x{r['compiles']}"
            for r in (row.get("top_recompilers") or [])
        )
        tenant_cell = (
            _fmt(tenants.get(tenant)) if tenant is not None
            else (_fmt(len(tenants)) if tenants else "-")
        )
        lines.append(
            f"{name[:18]:<18} {str(row.get('component') or '?')[:10]:<10} "
            f"{'y' if row.get('ok') else 'N':<3} "
            f"{_fmt(row.get('uptime_s'), 1):>8} "
            f"{_fmt(row.get('stale_s'), 1):>8} "
            f"{str(in_flight if in_flight is not None else '-')[:14]:<14} "
            f"{_fmt(row.get('alerts_total')):>6} "
            f"{_fmt(row.get('compiles')):>8} "
            f"{tenant_cell:>8}  {recomp}"
        )
    return "\n".join(lines)
