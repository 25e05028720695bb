"""Device programs captured once as CUDA graphs and replayed.

New in the port, with no counterpart in ``hpbandster_tpu``: where the
reference compiles one XLA program and calls it (a resident sweep's round
under ``lax.scan``, a bucket's bracket, a serving lane program), the port
captures the program's device work once into a ``torch.cuda.CUDAGraph``
and replays it, so the host issues one launch per call instead of every
small op.

A replay runs against the addresses captured, so whatever a program reads
or carries from one replay to the next (observation buffers and counts,
the incumbent, the metrics, the round index, static input and output
buffers, a lane carry) lives in tensors made before the capture and
updated in place. A program may draw from ``torch.Generator`` objects
registered with the graph: each replay takes the generator's offset at
replay time and advances it by the program's total, so the replays draw
what eager calls would, and eager work after the replays continues the
same stream.

Captures run on the card's one side stream in CUDA's thread-local capture
mode, one at a time in the process (``CAPTURE_LOCK``): other host threads may launch
kernels, allocate and fetch while a graph is captured (the serving tier
captures in the background while tenants sample), and only the capturing
thread must keep to capture-safe calls. A resident round has no warm-up
(capture records without running anything, and the kernels' libraries and
the moments kernel's ticket counter are made ready beforehand,
``cuda_kde.prepare_capture``); a program without side effects may run
once eagerly first (``warmup=True``), which readies the libraries and the
objective's device constants on the capturing thread. A capture or a
replay that fails raises; nothing falls back to running eagerly.

A graph is re-armable: its owner may replay it in later calls, after
writing new inputs into the captured buffers with ``copy_`` and resetting
what the program carries, and reseeding the registered generators
(``manual_seed``, which also resets their offsets), so a replay draws what
a fresh capture under that seed would. Every capture is recorded in the capture ledger
(``obs/runtime.py``): the graph's name as the label, its shape signature,
the capture and instantiate seconds, and the FLOPs and bytes of one replay,
counted op by op while the body is captured (``obs.runtime.count_cost``;
the hand-written kernels by their shape-only formulas).
"""

from __future__ import annotations

import collections
import gc
import threading
import time
from typing import Callable, Dict, List, Sequence

import torch

from hpbandster_tpu_torch.obs.runtime import count_cost, get_compile_tracker
from hpbandster_tpu_torch.ops import cuda_kde

__all__ = ["RoundGraph", "CAPTURE_LOCK", "CAPTURES", "shape_signature"]

#: one capture at a time in the process
CAPTURE_LOCK = threading.Lock()

#: graphs captured in this process, by program name
CAPTURES: Dict[str, int] = collections.Counter()

#: replays whose device times a graph keeps (the latest ones)
_KEPT_REPLAYS = 4096

#: one capture stream per card, shared by every capture (they run one at a
#: time, under ``CAPTURE_LOCK``)
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The card's capture stream (call under ``CAPTURE_LOCK``). cuBLAS and
    cuBLASLt keep a workspace per stream, made at the stream's first matmul
    and kept for the process: made inside a capture, it would come from
    that graph's memory pool and pin the pool's segment after the graph is
    gone, so the stream's first matmuls run here, outside any capture."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = _CAPTURE_STREAMS.get(index)
    if stream is None:
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            for dtype in (torch.float32, torch.bfloat16):
                a = torch.ones((16, 16), dtype=dtype, device=device)
                torch.addmm(a, a, a)
        # once per card and process, under the capture lock or a program's
        # build lock: every caller is about to capture on this stream and
        # must wait for its warm-up either way
        stream.synchronize()  # graftlint: disable=lock-blocking — one-off warm-up of the capture stream
        _CAPTURE_STREAMS[index] = stream
    return stream

_DTYPES = {torch.float32: "f32", torch.int64: "i64", torch.int32: "i32", torch.bool: "bool"}


def shape_signature(*tensors: torch.Tensor) -> str:
    """``f32[64,6], i64[5]``: the shapes and dtypes of a program's inputs,
    the signature its captures are recorded under."""
    return ", ".join(f"{_DTYPES.get(t.dtype, str(t.dtype))}[{','.join(map(str, t.shape))}]"
                     for t in tensors)


class RoundGraph:
    """``body()``'s CUDA work on ``device``, captured once.

    ``generators`` are the ``torch.Generator`` objects ``body`` draws from
    besides the default one. ``warmup=True`` runs ``body()`` once eagerly
    on the capture stream first (only for a body whose eager run changes
    nothing that matters). :meth:`replay` runs the captured program and
    counts its kernel launches in ``cuda_kde.LAUNCHES``; the capture
    itself launches nothing. ``name`` keys the process's ``CAPTURES``
    count and, with ``signature``, the capture's ledger record. ``cost``
    is what one replay costs, counted during the capture (``flops``,
    ``bytes_accessed`` and ``by_kind``; empty with the obs layer off).
    Times: ``capture_s`` and ``instantiate_s`` on the host clock (the
    capture's with the counting), :meth:`replay_ms` from CUDA events around
    each replay."""

    def __init__(self, body: Callable[[], None], device,
                 generators: Sequence[torch.Generator] = (),
                 warmup: bool = False, name: str = "fused_sweep_resident",
                 signature: str = ""):
        device = torch.device(device)
        self.name, self.signature = name, signature
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.generators = tuple(generators)
        for gen in self.generators:
            self.graph.register_generator_state(gen)
        with CAPTURE_LOCK:
            stream = _capture_stream(device)
            # the process's first capture builds the kernels (nvcc, once); a
            # capture cannot run without them, so other captures wait anyway
            cuda_kde.prepare_capture(device, stream)  # graftlint: disable=lock-blocking — first-use kernel build
            stream.wait_stream(torch.cuda.current_stream(device))
            if warmup:
                with torch.cuda.stream(stream):
                    body()
            t0 = time.perf_counter()
            # no garbage collection inside the capture: a collection may
            # destroy another graph that only a dead reference cycle still
            # holds, and destroying a graph while this thread captures is
            # not permitted (it invalidates the capture)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with cuda_kde.counting_capture() as captured:
                    with torch.cuda.graph(self.graph, stream=stream,
                                          capture_error_mode="thread_local"):
                        # the body's ops only: the capture's own prologue
                        # resets the registered generators' seed and offset
                        # tensors
                        with count_cost() as cost:  # graftlint: disable=obs-emit-in-capture,capture-escape — counts the ops once, at capture: one replay's cost; emits nothing
                            body()
            finally:
                if collecting:
                    gc.enable()
            self.capture_s = time.perf_counter() - t0
            self.cost = cost
            #: kernel launches one replay makes, per kernel name
            self.launches = dict(captured)
            t0 = time.perf_counter()
            self.graph.instantiate()
            self.instantiate_s = time.perf_counter() - t0
            CAPTURES[name] += 1
        torch.cuda.current_stream(device).wait_stream(stream)
        self._events: collections.deque = collections.deque(maxlen=_KEPT_REPLAYS)
        get_compile_tracker().record(name, signature, self.capture_s + self.instantiate_s,
                                     cost=cost)

    def replay(self) -> None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        self._events.append((start, end))
        cuda_kde.add_launches(self.launches)

    def replay_ms(self) -> List[float]:
        """Device milliseconds of each replay kept so far (waits for the
        last)."""
        events = list(self._events)
        if events:
            events[-1][1].synchronize()
        return [s.elapsed_time(e) for s, e in events]
