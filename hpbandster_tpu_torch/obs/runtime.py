"""Runtime telemetry: the capture ledger, transfer counters and the
device sampler.

Ported from ``hpbandster_tpu/obs/runtime.py`` (a copy: the port imports
nothing of the JAX package). Three instruments, all landing in the shared
:mod:`~hpbandster_tpu_torch.obs.metrics` registry and on the event bus:

* :class:`CompileTracker` — the ledger of the port's compiled programs.
  Eager PyTorch compiles nothing, so the port has no ``tracked_jit``: its
  compiled programs are CUDA graphs, and every capture
  (``ops/graphs.py`` ``RoundGraph``) records one entry: the graph's name
  as the label, a shape signature, and ``compile_s`` = capture +
  instantiate seconds. Each record journals the reference's
  ``xla_compile`` event with the reference's fields, so either package
  reads the other's journals; the XLA cost analysis has no counterpart
  and its fields (``flops``, ``bytes_accessed``) are null.
* :func:`note_transfer` — host<->device transfer counters incremented at
  the port's own transfer choke points (the sweep's warm upload and fetch,
  the batched backend's upload and fetch, the bucket, megabatch and lane
  programs' uploads and fetches), counted in the reference's units: bytes,
  and buffers as the reference counts them.
* :class:`DeviceSampler` — a periodic daemon thread publishing per-card
  gauges from the CUDA caching allocator.
"""

from __future__ import annotations

import collections
import logging
import math
import threading
import time
from typing import Any, Dict, List, Optional

from hpbandster_tpu_torch.obs import events as E
from hpbandster_tpu_torch.obs.metrics import MetricsRegistry, get_metrics

__all__ = [
    "CompileTracker",
    "DeviceSampler",
    "compile_stats_from_records",
    "get_compile_tracker",
    "note_transfer",
    "publish_sweep_transfers",
    "runtime_snapshot",
    "start_device_sampler",
    "transfer_counters",
]

logger = logging.getLogger("hpbandster_tpu_torch.obs")


# ------------------------------------------------------------ capture ledger
class CompileTracker:
    """Per-label ledger of compiled programs (on the port: CUDA-graph
    captures).

    Aggregation is by *label* on purpose: a loop that keeps capturing
    fresh graphs of the same program shows up as one label compiling over
    and over. The ledger also keeps one row per (label, signature), the
    input of :func:`~hpbandster_tpu_torch.obs.profile.roofline_report`.
    """

    #: bound on retained program rows: a shape-churning pathology must not
    #: grow the roofline table without limit
    MAX_PROGRAMS = 256

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: label -> {"compiles", "compile_s", "last_signature",
        #: "last_compile_s"}
        self._fns: Dict[str, Dict[str, Any]] = {}
        #: (label, signature) -> {"compiles", "compile_s"}
        self._programs: "collections.OrderedDict" = collections.OrderedDict()

    def record(
        self,
        label: str,
        signature: str,
        seconds: float,
        registry: Optional[MetricsRegistry] = None,
        bus: Optional[E.EventBus] = None,
    ) -> int:
        """Count one fresh compilation (capture) of ``label``; returns its
        cumulative count. Updates ``runtime.compiles``,
        ``runtime.compiles.<label>`` and ``runtime.compile_seconds`` and
        emits one ``xla_compile`` event, whose cost fields are null: a
        CUDA graph reports no FLOPs or bytes."""
        with self._lock:
            slot = self._fns.get(label)
            if slot is None:
                slot = self._fns[label] = {"compiles": 0, "compile_s": 0.0}
            slot["compiles"] += 1
            slot["compile_s"] += float(seconds)
            slot["last_signature"] = signature
            slot["last_compile_s"] = float(seconds)
            n = slot["compiles"]
            key = (label, signature)
            prog = self._programs.pop(key, None)
            if prog is None:
                prog = {"compiles": 0, "compile_s": 0.0}
            prog["compiles"] += 1
            prog["compile_s"] = round(prog["compile_s"] + float(seconds), 6)
            self._programs[key] = prog  # re-insert: LRU-newest
            while len(self._programs) > self.MAX_PROGRAMS:
                self._programs.popitem(last=False)
        reg = registry if registry is not None else get_metrics()
        reg.counter("runtime.compiles").inc()
        reg.counter(f"runtime.compiles.{label}").inc()
        reg.gauge("runtime.compile_seconds").inc(float(seconds))
        target = bus if bus is not None else E.get_bus()
        target.emit(
            E.XLA_COMPILE,
            fn=label,
            signature=signature,
            compile_s=round(float(seconds), 6),
            compiles=n,
            recompiles=n - 1,
            flops=None,
            bytes_accessed=None,
        )
        return n

    def programs(self) -> List[Dict[str, Any]]:
        """Every program in the ledger, insertion order: the roofline
        report's input rows."""
        with self._lock:
            return [
                {"fn": label, "signature": signature, **dict(prog)}
                for (label, signature), prog in self._programs.items()
            ]

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable ledger: totals + per-label breakdown."""
        with self._lock:
            functions = {
                label: {
                    "compiles": slot["compiles"],
                    "compile_s": round(slot["compile_s"], 6),
                    "recompiles": slot["compiles"] - 1,
                    "last_signature": slot.get("last_signature"),
                }
                for label, slot in sorted(self._fns.items())
            }
        return {
            "total_compiles": sum(f["compiles"] for f in functions.values()),
            "total_compile_s": round(
                sum(f["compile_s"] for f in functions.values()), 6
            ),
            "functions": functions,
        }

    def reset(self) -> None:
        """Drop the ledger (test isolation)."""
        with self._lock:
            self._fns.clear()
            self._programs.clear()


_TRACKER = CompileTracker()


def get_compile_tracker() -> CompileTracker:
    """The process-wide ledger every CUDA-graph capture feeds."""
    return _TRACKER


# ---------------------------------------------------------- transfer counters
def note_transfer(
    direction: str,
    nbytes: int,
    buffers: int = 1,
    registry: Optional[MetricsRegistry] = None,
) -> None:
    """Count one host<->device transfer at a choke point of the port.

    ``direction`` is ``"h2d"`` or ``"d2h"``. PyTorch exposes no transfer
    counters, so the port counts its own transfer sites, the set whose
    round trips dominate a sweep's host surface."""
    if direction not in ("h2d", "d2h"):
        raise ValueError(f"direction must be 'h2d' or 'd2h', not {direction!r}")
    reg = registry if registry is not None else get_metrics()
    reg.counter(f"runtime.transfers_{direction}").inc(int(buffers))
    reg.counter(f"runtime.transfer_bytes_{direction}").inc(max(int(nbytes), 0))


#: the four process-lifetime host-link counters :func:`note_transfer`
#: advances
_TRANSFER_COUNTER_KEYS = (
    "transfers_h2d", "transfers_d2h",
    "transfer_bytes_h2d", "transfer_bytes_d2h",
)


def transfer_counters(
    registry: Optional[MetricsRegistry] = None,
) -> Dict[str, int]:
    """Current values of the host-link transfer counters (0 where never
    advanced): snapshot one before a sweep, diff it with
    :func:`publish_sweep_transfers` after."""
    reg = registry if registry is not None else get_metrics()
    counters = reg.snapshot().get("counters") or {}
    return {
        k: int(counters.get(f"runtime.{k}", 0) or 0)
        for k in _TRANSFER_COUNTER_KEYS
    }


def publish_sweep_transfers(
    before: Dict[str, int],
    registry: Optional[MetricsRegistry] = None,
) -> Dict[str, int]:
    """Per-sweep host-link accounting: diff the transfer counters against
    a :func:`transfer_counters` snapshot taken at sweep start, publish the
    result as gauges and return the deltas.

    Gauges: ``sweep.transfer_bytes.h2d`` / ``sweep.transfer_bytes.d2h``,
    the bytes the host link carried for the last sweep, and
    ``sweep.host_syncs``, the transferred buffers in both directions (the
    unit every :func:`note_transfer` site counts in)."""
    reg = registry if registry is not None else get_metrics()
    now = transfer_counters(reg)
    delta = {k: now[k] - int(before.get(k, 0)) for k in now}
    reg.gauge("sweep.transfer_bytes.h2d").set(float(delta["transfer_bytes_h2d"]))
    reg.gauge("sweep.transfer_bytes.d2h").set(float(delta["transfer_bytes_d2h"]))
    reg.gauge("sweep.host_syncs").set(
        float(delta["transfers_h2d"] + delta["transfers_d2h"])
    )
    return delta


# ------------------------------------------------------------- device sampler
class DeviceSampler:
    """Periodic per-card memory census -> gauges.

    ``sample()`` runs one census (tests call it directly); ``start()``
    spawns a daemon thread sampling every ``interval_s`` until ``stop()``.
    Gauges published per CUDA device index ``i``:

    * ``runtime.device.<i>.bytes_in_use`` — the caching allocator's
      allocated bytes (``torch.cuda.memory_stats(i)
      ["allocated_bytes.all.current"]``);
    * ``runtime.device.<i>.bytes_limit`` — the card's total memory
      (``torch.cuda.mem_get_info(i)[1]``);
    * ``runtime.device.<i>.live_buffers`` / ``.live_bytes`` — the
      allocator's active blocks and their bytes (torch has no census of
      live arrays, so the allocator's blocks stand in for them);

    plus ``runtime.device_count``. Without CUDA the census holds the CPU as
    one device with no memory fields, as the reference reports a CPU.
    """

    def __init__(
        self,
        interval_s: float = 10.0,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.interval_s = max(float(interval_s), 0.05)
        self._registry = registry
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last: Optional[Dict[str, Any]] = None

    def sample(self) -> Dict[str, Any]:
        """One census; returns (and retains) the JSON-serializable result."""
        import torch

        reg = self._registry if self._registry is not None else get_metrics()
        per_dev: Dict[int, Dict[str, Any]] = {}
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(i)
                slot = per_dev[i] = {
                    "kind": torch.cuda.get_device_name(i),
                    "platform": "gpu",
                    "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
                    "bytes_limit": int(torch.cuda.mem_get_info(i)[1]),
                    "live_buffers": int(stats.get("active.all.current", 0)),
                    "live_bytes": int(stats.get("active_bytes.all.current", 0)),
                }
                for field in ("bytes_in_use", "bytes_limit", "live_buffers", "live_bytes"):
                    reg.gauge(f"runtime.device.{i}.{field}").set(slot[field])
        else:
            per_dev[0] = {"kind": "cpu", "platform": "cpu"}
        reg.gauge("runtime.device_count").set(len(per_dev))
        census = {
            "t_wall": time.time(),
            "device_count": len(per_dev),
            "devices": {str(i): per_dev[i] for i in sorted(per_dev)},
        }
        with self._lock:
            self._last = census
        return census

    def last_sample(self) -> Optional[Dict[str, Any]]:
        """The newest census, or None before the first sample."""
        with self._lock:
            return dict(self._last) if self._last is not None else None

    def start(self) -> "DeviceSampler":
        """Spawn the daemon sampling thread (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="obs-device-sampler"
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sample()
            except Exception:
                # telemetry must never kill its host process's thread
                logger.exception("device sampler pass failed")
            if self._stop.wait(self.interval_s):
                return

    def stop(self) -> None:
        """Stop the sampling thread (idempotent; safe if never started)."""
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)


#: the sampler started via start_device_sampler, for runtime_snapshot()
_SAMPLER: Optional[DeviceSampler] = None
_SAMPLER_LOCK = threading.Lock()


def start_device_sampler(
    interval_s: float = 10.0,
    registry: Optional[MetricsRegistry] = None,
) -> DeviceSampler:
    """Start (or return) the process-wide device sampler;
    ``obs.configure(device_sampler=...)`` wires it into the sinks'
    lifecycle."""
    global _SAMPLER
    with _SAMPLER_LOCK:
        if _SAMPLER is None:
            _SAMPLER = DeviceSampler(interval_s=interval_s, registry=registry)
            _SAMPLER.start()
        return _SAMPLER


def _clear_device_sampler(sampler: DeviceSampler) -> None:
    """Forget the process-wide sampler if it is ``sampler`` (close path)."""
    global _SAMPLER
    with _SAMPLER_LOCK:
        if _SAMPLER is sampler:
            _SAMPLER = None


def compile_stats_from_records(
    records: List[Dict[str, Any]],
    window_s: float,
    top_k: int = 5,
) -> Dict[str, Any]:
    """Offline aggregation of ``xla_compile`` journal records: per-label
    compile counts and seconds, the compile share of the journal's
    wall-clock window, and the ``top_k`` recompilers. Deterministic."""
    per_fn: Dict[str, Dict[str, float]] = {}
    for rec in records:
        if rec.get("event") != E.XLA_COMPILE:
            continue
        fn = str(rec.get("fn") or "?")
        slot = per_fn.setdefault(fn, {"compiles": 0, "compile_s": 0.0})
        slot["compiles"] += 1
        cs = rec.get("compile_s")
        if isinstance(cs, (int, float)) and not isinstance(cs, bool) and math.isfinite(cs):
            slot["compile_s"] += float(cs)
    total = sum(s["compiles"] for s in per_fn.values())
    total_s = sum(s["compile_s"] for s in per_fn.values())
    return {
        "compiles": int(total),
        "compile_s": round(total_s, 6),
        "compile_share_of_wall": (
            round(min(total_s / window_s, 1.0), 4)
            if window_s > 0 and total else None
        ),
        "top_recompilers": [
            {
                "fn": fn,
                "compiles": int(slot["compiles"]),
                "compile_s": round(slot["compile_s"], 6),
                "recompiles": int(slot["compiles"]) - 1,
            }
            for fn, slot in sorted(
                per_fn.items(),
                key=lambda kv: (-kv[1]["compiles"], -kv[1]["compile_s"], kv[0]),
            )[:top_k]
        ],
    }


def runtime_snapshot() -> Dict[str, Any]:
    """The capture ledger plus the newest device census (None until a
    :class:`DeviceSampler` has run: this never touches the device
    itself)."""
    with _SAMPLER_LOCK:
        sampler = _SAMPLER
    return {
        "compile": _TRACKER.snapshot(),
        "devices": sampler.last_sample() if sampler is not None else None,
    }
