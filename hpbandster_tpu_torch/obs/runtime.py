"""Runtime telemetry: the capture ledger with its cost counter, transfer
counters and the device sampler.

Ported from ``hpbandster_tpu/obs/runtime.py`` (a copy: the port imports
nothing of the JAX package). Four instruments, all landing in the shared
:mod:`~hpbandster_tpu_torch.obs.metrics` registry and on the event bus:

* :class:`CompileTracker` — the ledger of the port's compiled programs.
  Eager PyTorch compiles nothing, so the port has no ``tracked_jit``: its
  compiled programs are CUDA graphs, and every capture
  (``ops/graphs.py`` ``RoundGraph``) records one entry: the graph's name
  as the label, a shape signature, ``compile_s`` = capture + instantiate
  seconds, and the capture's counted cost. Each record journals the
  reference's ``xla_compile`` event with the reference's fields, so either
  package reads the other's journals.
* :func:`count_cost` — the counterpart of the reference's
  ``_extract_cost`` (XLA's cost analysis of a compiled program): a
  thread-local window that counts the FLOPs and bytes of every aten op
  it dispatches, by XLA's ``HloCostAnalysis`` conventions, plus the
  hand-written kernels' shape-only costs (:func:`kernel_cost`).
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
import contextlib
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
    "count_cost",
    "get_compile_tracker",
    "kernel_cost",
    "UniformSteps",
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
    and over. The ledger also keeps one row per (label, signature) with
    the program's counted cost, the input of
    :func:`~hpbandster_tpu_torch.obs.profile.roofline_report`.
    """

    #: bound on retained program rows: a shape-churning pathology must not
    #: grow the roofline table without limit
    MAX_PROGRAMS = 256

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: label -> {"compiles", "compile_s", "last_signature",
        #: "last_compile_s"}
        self._fns: Dict[str, Dict[str, Any]] = {}
        #: (label, signature) -> {"compiles", "compile_s"[, "flops",
        #: "bytes_accessed"]}
        self._programs: "collections.OrderedDict" = collections.OrderedDict()

    def record(
        self,
        label: str,
        signature: str,
        seconds: float,
        registry: Optional[MetricsRegistry] = None,
        bus: Optional[E.EventBus] = None,
        cost: Optional[Dict[str, float]] = None,
    ) -> int:
        """Count one fresh compilation (capture) of ``label``; returns its
        cumulative count. Updates ``runtime.compiles``,
        ``runtime.compiles.<label>`` and ``runtime.compile_seconds`` and
        emits one ``xla_compile`` event. ``cost`` is the program's counted
        cost (``{"flops", "bytes_accessed"}``, :func:`count_cost`): kept on
        its (label, signature) row for the roofline report, republished as
        the ``runtime.flops.<label>`` / ``runtime.bytes_accessed.<label>``
        counters and carried on the event. An uncosted record journals the
        cost fields as null."""
        fields = {k: float(cost[k]) for k in ("flops", "bytes_accessed")
                  if cost and cost.get(k) is not None}
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
            prog.update(fields)
            self._programs[key] = prog  # re-insert: LRU-newest
            while len(self._programs) > self.MAX_PROGRAMS:
                self._programs.popitem(last=False)
        reg = registry if registry is not None else get_metrics()
        reg.counter("runtime.compiles").inc()
        reg.counter(f"runtime.compiles.{label}").inc()
        reg.gauge("runtime.compile_seconds").inc(float(seconds))
        for field, v in fields.items():
            reg.counter(f"runtime.{field}.{label}").inc(int(v))
        target = bus if bus is not None else E.get_bus()
        target.emit(
            E.XLA_COMPILE,
            fn=label,
            signature=signature,
            compile_s=round(float(seconds), 6),
            compiles=n,
            recompiles=n - 1,
            flops=fields.get("flops"),
            bytes_accessed=fields.get("bytes_accessed"),
        )
        return n

    def programs(self) -> List[Dict[str, Any]]:
        """Every program in the ledger, costed or not, insertion order."""
        with self._lock:
            return [
                {"fn": label, "signature": signature, **dict(prog)}
                for (label, signature), prog in self._programs.items()
            ]

    def program_costs(self) -> List[Dict[str, Any]]:
        """Every costed program in the ledger, insertion order: the
        roofline report's input rows."""
        return [p for p in self.programs() if "flops" in p or "bytes_accessed" in p]

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


# ---------------------------------------------------------------- cost count
# What a program costs, counted op by op as it is dispatched, by XLA's
# HloCostAnalysis conventions so that a straight-line program counts as the
# reference's cost analysis counts it:
#   * matrix products, convolutions and attention: torch's flop formulas
#     (2 M N K a product, and their backward formulas); the bias of
#     addmm / baddbmm adds one FLOP per output element (XLA: a dot and an add);
#   * pointwise arithmetic: one FLOP per output element; transcendentals
#     (exp, log, tanh, pow, sqrt, ...) none, as XLA counts them apart;
#   * a reduction of n elements: n - 1 FLOPs per output;
#   * sort, top-k, gather, scatter, indexing, copies and fills: none;
#   * bytes: each op's tensor operands and outputs, numel x element size
#     of the view; views and metadata ops move none. Nothing is fused, so
#     this is what a graph of eager kernels moves, at or above XLA's count;
#   * the hand-written kernels, whose launches no dispatch sees: their
#     shape-only formulas (kernel_cost), with every buffer row live.
# Loops run in Python, so a loop body counts once per iteration, where XLA
# counts a while loop's body once. The count is of the work dispatched, not
# of the work the function needs: a rewrite that adds or fuses ops moves it.
# The dispatch hook costs host time at every op, so a loop whose steps are
# alike (UniformSteps: a training loop) counts its first step op by op and
# adds that count for every later step with the hook out of the way.

#: base names (``aten.<name>``, an in-place variant's trailing ``_`` dropped)
#: of the pointwise ops XLA counts as transcendentals: no FLOPs
_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sigmoid", "logit",
    "tanh", "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh",
    "asinh", "acosh", "atanh", "sqrt", "rsqrt", "pow", "float_power", "erf",
    "erfc", "erfinv", "lgamma", "digamma",
})
#: pointwise-tagged ops that only move or fill values: no FLOPs
_ZERO_FLOP = frozenset({
    "clone", "copy", "fill", "zero", "masked_fill", "lift_fresh_copy",
    "detach_copy", "alias_copy",
})
#: ops that allocate or relabel memory without moving any: no bytes
_NO_TRAFFIC = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_unsafe_view", "_reshape_alias", "resize", "set", "record_stream",
})
#: products whose flop formula leaves out an added input: one FLOP an output
_BIASED = frozenset({"addmm", "baddbmm"})

#: this thread's open counting windows, innermost last
_COST_WINDOWS = threading.local()
#: per aten overload: (kind, FLOP formula or None, out-argument names)
_OP_RULES: Dict[Any, Any] = {}
_MODE_CLASS = None
#: ``torch.Tensor`` and torch's mode-stack helpers, bound with the mode class
_TENSOR: Any = None
_MODE_STACK: Any = None
_NO_MODES: Any = None
_NO_SCOPE = contextlib.nullcontext()


class _CostWindow:
    """One :func:`count_cost` window's running totals, by kind of op."""

    __slots__ = ("flops", "bytes", "kinds", "suspended", "reuse_steps")

    def __init__(self, reuse_steps: bool = True) -> None:
        self.flops = 0
        self.bytes = 0
        #: kind -> [flops, bytes, ops]
        self.kinds: Dict[str, List[int]] = {}
        #: > 0 inside a hand-written kernel's entry point: its plain
        #: version's ops are not this window's
        self.suspended = 0
        #: whether a UniformSteps loop may add its first step's count for
        #: the later steps (False: every step counts op by op)
        self.reuse_steps = reuse_steps

    def add(self, kind: str, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes
        slot = self.kinds.get(kind)
        if slot is None:
            slot = self.kinds[kind] = [0, 0, 0]
        slot[0] += flops
        slot[1] += nbytes
        slot[2] += 1

    def merge(self, kinds: Dict[str, List[int]]) -> None:
        """Add a recorded ``kind -> [flops, bytes, ops]`` count."""
        for kind, (f, b, n) in kinds.items():
            self.flops += f
            self.bytes += b
            slot = self.kinds.get(kind)
            if slot is None:
                slot = self.kinds[kind] = [0, 0, 0]
            slot[0] += f
            slot[1] += b
            slot[2] += n

    def result(self) -> Dict[str, Any]:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes,
            "by_kind": {k: {"flops": f, "bytes_accessed": b, "ops": n}
                        for k, (f, b, n) in sorted(self.kinds.items())},
        }


def _windows() -> List[_CostWindow]:
    stack = getattr(_COST_WINDOWS, "stack", None)
    if stack is None:
        stack = _COST_WINDOWS.stack = []
    return stack


def _tensor_bytes(x) -> int:
    """Bytes of the tensors in ``x`` (nested lists and tuples), numel x
    element size of each view."""
    if isinstance(x, _TENSOR):
        return x.nbytes
    n = 0
    if isinstance(x, (list, tuple)):
        for v in x:
            if isinstance(v, _TENSOR):
                n += v.nbytes
            elif isinstance(v, (list, tuple)):
                n += _tensor_bytes(v)
    return n


def _first_tensor(x):
    if isinstance(x, _TENSOR):
        return x
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def _op_rule(func):
    """How ``func`` (an aten overload) counts: ``(kind, flop formula,
    out-argument names, whether a bias adds to the formula)``, kind one of
    ``free`` (no bytes), ``matmul``, ``pointwise``, ``transcendental``,
    ``reduction``, ``other``."""
    import torch
    from torch.utils.flop_counter import flop_registry

    packet = func.overloadpacket
    name = packet.__name__
    base = name[:-1] if name.endswith("_") and not name.endswith("__") else name
    tags = set(func.tags)
    reduction_tag = getattr(torch.Tag, "reduction", None)
    outs = frozenset(a.name for a in func._schema.arguments if getattr(a, "is_out", False))
    formula = None
    if func.is_view or torch.Tag.inplace_view in tags or base in _NO_TRAFFIC:
        kind = "free"
    elif packet in flop_registry:
        kind, formula = "matmul", flop_registry[packet]
    elif reduction_tag is not None and reduction_tag in tags:
        kind = "reduction"
    elif torch.Tag.pointwise in tags:
        kind = ("transcendental" if base in _TRANSCENDENTAL
                else "other" if base in _ZERO_FLOP else "pointwise")
    else:
        kind = "other"
    rule = _OP_RULES[func] = (kind, formula, outs, base in _BIASED)
    return rule


def _count_op(window: _CostWindow, func, args, kwargs, out) -> None:
    rule = _OP_RULES.get(func)
    if rule is None:
        rule = _op_rule(func)
    kind, formula, outs, biased = rule
    if kind == "free":
        return
    nbytes = _tensor_bytes(args) + _tensor_bytes(out)
    if kwargs:
        for k, v in kwargs.items():
            if k not in outs:
                nbytes += _tensor_bytes(v)
    flops = 0
    if kind == "pointwise":
        first = out if isinstance(out, _TENSOR) else _first_tensor(out)
        flops = 0 if first is None else first.numel()
    elif kind == "matmul":
        flops = int(formula(*args, **kwargs, out_val=out))
        if biased:
            flops += _first_tensor(out).numel()
    elif kind == "reduction":
        src, first = _first_tensor(args), _first_tensor(out)
        if src is not None and first is not None:
            flops = max(src.numel() - first.numel(), 0)
    window.add(kind, flops, nbytes)


def _cost_mode(window: _CostWindow):
    """A ``TorchDispatchMode`` that counts every aten op it sees into
    ``window`` (the class is made at first use: importing this module
    imports no torch)."""
    global _MODE_CLASS, _TENSOR, _MODE_STACK, _NO_MODES
    if _MODE_CLASS is None:
        import torch
        from torch.utils._python_dispatch import (
            TorchDispatchMode,
            _disable_current_modes,
            _get_current_dispatch_mode_stack,
        )

        _TENSOR = torch.Tensor
        _MODE_STACK = _get_current_dispatch_mode_stack
        _NO_MODES = _disable_current_modes

        class _CostMode(TorchDispatchMode):
            @classmethod
            def _should_skip_dynamo(cls) -> bool:
                # nothing in the window compiles: left unwrapped, the
                # dispatch hook neither imports torch._dynamo at its first
                # op nor pays the wrapper at every op
                return False

            def __init__(self, win: _CostWindow) -> None:
                super().__init__()
                self.window = win

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **kwargs) if kwargs else func(*args)
                if not self.window.suspended:
                    _count_op(self.window, func, args, kwargs, out)
                return out

        _MODE_CLASS = _CostMode
    return _MODE_CLASS(window)


@contextlib.contextmanager
def count_cost(reuse_steps: bool = True):
    """Count what the ``with`` block costs on this thread: yields a dict
    that holds, once the block ends, ``{"flops", "bytes_accessed",
    "by_kind"}`` (``by_kind``: per kind of op, or per hand-written kernel,
    its ``flops``, ``bytes_accessed`` and ``ops``). Every aten op the block
    dispatches counts, the backward ops of ``torch.autograd.grad``
    included, by the conventions above. The count reads shapes and dtypes
    only: no sync, no allocation, no launch. With the obs layer off
    (``obs.set_enabled(False)``) nothing is counted and the dict stays
    empty. Windows nest; each counts the whole of its block.
    ``reuse_steps=False`` counts every step of a :class:`UniformSteps`
    loop op by op, where by default the later steps add the first's count:
    the same total, at the hook's full cost (what checks the reuse)."""
    cost: Dict[str, Any] = {}
    if not E._ENABLED:
        yield cost
        return
    window = _CostWindow(reuse_steps)
    stack = _windows()
    stack.append(window)
    try:
        with _cost_mode(window):
            yield cost
    finally:
        stack.remove(window)
    cost.update(window.result())


class _KernelScope:
    """The body of a hand-written kernel's entry point inside open windows:
    its cost counted once, the ops dispatched meanwhile not at all."""

    __slots__ = ("_stack",)

    def __init__(self, stack: List[_CostWindow]) -> None:
        self._stack = list(stack)

    def __enter__(self) -> None:
        for w in self._stack:
            w.suspended += 1

    def __exit__(self, *exc) -> None:
        for w in self._stack:
            w.suspended -= 1


def kernel_cost(name: str, cost_fn, *shape):
    """Context manager for a hand-written kernel's entry point: in every
    :func:`count_cost` window open on this thread, ``cost_fn(*shape)``
    (with ``flops`` and ``bytes_accessed``) counts once under ``name``, and
    whatever the block dispatches (its plain version on the CPU, the
    launch's own tensor ops on a card) does not count, so a program counts
    the same on both. A call nested in another entry point adds nothing.
    Without an open window it costs one attribute read."""
    stack = getattr(_COST_WINDOWS, "stack", None)
    if not stack:
        return _NO_SCOPE
    live = [w for w in stack if not w.suspended]
    if live:
        c = cost_fn(*shape)
        for w in live:
            w.add(name, int(c.flops), int(c.bytes_accessed))
    return _KernelScope(stack)


class UniformSteps:
    """A loop whose steps all dispatch the same ops on the same shapes (a
    training loop's steps: the same minibatch and parameter shapes). Each
    step runs inside ``with steps.step():``. In open :func:`count_cost`
    windows the first step counts op by op and every later step adds that
    count, with the dispatch hook out of the way for its ops: what counting
    costs a long loop is then one step's worth. A window opened with
    ``reuse_steps=False``, or a dispatch mode other than the count's on the
    stack, counts every step op by op. Without an open window a step costs
    one attribute read."""

    __slots__ = ("_kinds",)

    def __init__(self) -> None:
        #: the first step's count, kind -> [flops, bytes, ops]
        self._kinds: Optional[Dict[str, List[int]]] = None

    def step(self):
        stack = getattr(_COST_WINDOWS, "stack", None)
        if not stack:
            return _NO_SCOPE
        live = [w for w in stack if not w.suspended]
        if not live or not all(w.reuse_steps for w in live):
            return _NO_SCOPE
        if self._kinds is None:
            return _FirstStep(self, live[-1])
        if not all(isinstance(m, _MODE_CLASS) for m in _MODE_STACK()):
            return _NO_SCOPE
        return _ReusedStep(self._kinds, live)


class _FirstStep:
    """Counts the step op by op and keeps what ``window`` gained."""

    __slots__ = ("_steps", "_window", "_before")

    def __init__(self, steps: UniformSteps, window: _CostWindow) -> None:
        self._steps, self._window = steps, window

    def __enter__(self) -> None:
        self._before = {k: list(v) for k, v in self._window.kinds.items()}

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is not None:
            return
        gained = {}
        for kind, now in self._window.kinds.items():
            was = self._before.get(kind, (0, 0, 0))
            diff = [a - b for a, b in zip(now, was)]
            if any(diff):
                gained[kind] = diff
        self._steps._kinds = gained


class _ReusedStep:
    """Runs the step with the count's dispatch modes off the stack and adds
    the first step's count to every live window."""

    __slots__ = ("_kinds", "_live", "_off")

    def __init__(self, kinds: Dict[str, List[int]], live: List[_CostWindow]) -> None:
        self._kinds, self._live = kinds, live

    def __enter__(self) -> None:
        self._off = _NO_MODES()
        self._off.__enter__()

    def __exit__(self, exc_type, *exc) -> None:
        self._off.__exit__(exc_type, *exc)
        if exc_type is None:
            for w in self._live:
                w.merge(self._kinds)


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
