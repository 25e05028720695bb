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

Captures run on a side stream in CUDA's thread-local capture mode, one at
a time in the process (``CAPTURE_LOCK``): other host threads may launch
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
what the program carries, and :meth:`RoundGraph.reseed` reseeds the
registered generators, so a replay draws what a fresh capture under that
seed would. Every capture is recorded in the capture ledger
(``obs/runtime.py``): the graph's name as the label, its shape signature,
and the capture and instantiate seconds.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Sequence

import torch

from hpbandster_tpu_torch.obs.runtime import get_compile_tracker
from hpbandster_tpu_torch.ops import cuda_kde

__all__ = ["RoundGraph", "CAPTURE_LOCK", "CAPTURES", "shape_signature"]

#: one capture at a time in the process
CAPTURE_LOCK = threading.Lock()

#: graphs captured in this process, by program name
CAPTURES: Dict[str, int] = collections.Counter()

#: replays whose device times a graph keeps (the latest ones)
_KEPT_REPLAYS = 4096

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
    count and, with ``signature``, the capture's ledger record. Times:
    ``capture_s`` and ``instantiate_s`` on the host clock, :meth:`replay_ms`
    from CUDA events around each replay."""

    def __init__(self, body: Callable[[], None], device,
                 generators: Sequence[torch.Generator] = (),
                 warmup: bool = False, name: str = "resident_round",
                 signature: str = ""):
        device = torch.device(device)
        stream = torch.cuda.Stream(device)
        cuda_kde.prepare_capture(device, stream)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.generators = tuple(generators)
        for gen in self.generators:
            self.graph.register_generator_state(gen)
        with CAPTURE_LOCK:
            stream.wait_stream(torch.cuda.current_stream(device))
            if warmup:
                with torch.cuda.stream(stream):
                    body()
            t0 = time.perf_counter()
            with cuda_kde.counting_capture() as captured:
                with torch.cuda.graph(self.graph, stream=stream,
                                      capture_error_mode="thread_local"):
                    body()
            self.capture_s = time.perf_counter() - t0
            #: kernel launches one replay makes, per kernel name
            self.launches = dict(captured)
            t0 = time.perf_counter()
            self.graph.instantiate()
            self.instantiate_s = time.perf_counter() - t0
            CAPTURES[name] += 1
        torch.cuda.current_stream(device).wait_stream(stream)
        self._events: collections.deque = collections.deque(maxlen=_KEPT_REPLAYS)
        get_compile_tracker().record(name, signature, self.capture_s + self.instantiate_s)

    def reseed(self, seed: int) -> None:
        """Seed every registered generator with ``seed`` (offset 0): the
        next replay draws what a fresh capture seeded with ``seed``
        would."""
        for gen in self.generators:
            gen.manual_seed(int(seed))

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
