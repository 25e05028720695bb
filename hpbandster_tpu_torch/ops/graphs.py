"""One round of the resident sweep as a CUDA graph, replayed round after
round.

New in the port, with no counterpart in ``hpbandster_tpu``: where the
reference traces one HyperBand rotation round and drives it with
``lax.scan`` inside one compiled program, the port captures the round's
device work once into a ``torch.cuda.CUDAGraph`` and replays it
``n_rounds`` times, so the host issues one launch per round instead of
every small op of every bracket.

A replay runs against the addresses captured, so whatever the round
carries from one replay to the next (observation buffers and counts, the
incumbent, the metrics, the round index, the per-round output buffers)
lives in tensors made before the capture and updated in place. The round
draws from a ``torch.Generator`` registered with the graph: each replay
takes the generator's offset at replay time and advances it by the
round's total, so the replayed rounds draw what eager rounds would, and
eager work after the replays continues the same stream.

There is no warm-up round: capture records without running anything, and
the kernels' libraries and the moments kernel's ticket counter are made
ready beforehand (``cuda_kde.prepare_capture``). A capture or a replay
that fails raises; nothing falls back to running the round eagerly.
"""

from __future__ import annotations

import time
from typing import Callable, List, Sequence

import torch

from hpbandster_tpu_torch.ops import cuda_kde

__all__ = ["RoundGraph"]


class RoundGraph:
    """``body()``'s CUDA work on ``device``, captured once.

    ``generators`` are the ``torch.Generator`` objects ``body`` draws from
    besides the default one. :meth:`replay` runs the captured round and
    counts its kernel launches in ``cuda_kde.LAUNCHES``; the capture itself
    launches nothing. Times: ``capture_s`` and ``instantiate_s`` on the
    host clock, :meth:`replay_ms` from CUDA events around each replay."""

    def __init__(self, body: Callable[[], None], device,
                 generators: Sequence[torch.Generator] = ()):
        device = torch.device(device)
        stream = torch.cuda.Stream(device)
        cuda_kde.prepare_capture(device, stream)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in generators:
            self.graph.register_generator_state(gen)
        before = dict(cuda_kde.CAPTURED)
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, stream=stream):
            body()
        self.capture_s = time.perf_counter() - t0
        #: kernel launches one replay makes, per kernel name
        self.launches = {k: cuda_kde.CAPTURED[k] - before[k] for k in before}
        t0 = time.perf_counter()
        self.graph.instantiate()
        self.instantiate_s = time.perf_counter() - t0
        self._events: List[tuple] = []

    def replay(self) -> None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        self._events.append((start, end))
        for name, n in self.launches.items():
            cuda_kde.LAUNCHES[name] += n

    def replay_ms(self) -> List[float]:
        """Device milliseconds of each replay so far (waits for the last)."""
        if self._events:
            self._events[-1][1].synchronize()
        return [s.elapsed_time(e) for s, e in self._events]
