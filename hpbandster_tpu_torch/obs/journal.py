"""Run-journal sinks: rotating JSONL files + an in-memory ring buffer.

Ported from ``hpbandster_tpu/obs/journal.py`` (a copy). The record format
is the reference's exactly, so either package reads the other's journals.

:class:`JsonlJournal` is the durable sink — one JSON object per line,
size-based rotation (``journal.jsonl`` -> ``journal.jsonl.1`` -> ``.2``
...), so a long sweep's telemetry is bounded on disk and the newest
events are always in the live file. :class:`RingBuffer` is the
post-mortem sink — the last N events stay in memory even when no journal
is configured, which is what the dispatcher's dead-letter path and crash
analysis read.

Rotation semantics (pinned by ``tests/test_obs.py``): a write that would
push the live file PAST ``max_bytes`` rotates first, so every rotated
file is <= ``max_bytes`` — unless a single line alone exceeds it, which
is written whole to a fresh file (a journal must never split a line).
No line is ever dropped by rotation itself; only files older than
``max_files`` rotations are deleted.

Writes are batched: encoded lines accumulate in an in-process buffer
(``buffer_bytes``, 0 = write-through) and hit the file in one
write+flush when the buffer fills, when a lifecycle-boundary record
arrives (chunk span closes, job results, alerts, fleet samples —
``_FLUSH_EVENTS``), on rotation, and on ``flush()``/``close()``. The
per-record syscall pair was the critical-path attribution floor trailing
every span (each emit paid a synchronous write+flush inside the sink);
batching amortizes it across a chunk's worth of micro-spans while the
boundary set keeps live tails (``watch``, the collector series) at most
one chunk stale and pins the records a post-mortem cannot lose. Size
accounting happens at buffer time, so rotate-before-exceed semantics are
byte-identical to the write-through path.
"""

from __future__ import annotations

import collections
import json
import math
import os
import socket
import threading
from typing import Any, Dict, List, Optional, Tuple

from hpbandster_tpu_torch.obs.events import Event
from hpbandster_tpu_torch.obs import events as E

__all__ = [
    "JsonlJournal", "RingBuffer", "journal_paths", "read_journal",
    "read_journal_ex", "process_identity",
]


def _jsonable(x: Any) -> Any:
    """Best-effort coercion for event fields (numpy scalars, tuples...)."""
    try:
        return float(x)
    except (TypeError, ValueError):
        return str(x)


def _definite(x: Any) -> Any:
    """Recursively replace non-finite floats with None (the slow path of
    write_record): a journal line must be STRICT JSON — bare NaN/Infinity
    (e.g. a diverged run's inf loss inside a promotion_decision's losses
    list) breaks jq/JS readers of the very post-mortem they exist for."""
    if isinstance(x, dict):
        return {k: _definite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_definite(v) for v in x]
    if isinstance(x, float):  # np.float64 subclasses float; covered
        return x if math.isfinite(x) else None
    if x is None or isinstance(x, (str, int, bool)):
        return x
    y = _jsonable(x)
    if isinstance(y, float) and not math.isfinite(y):
        return None
    return y


def event_to_record(ev: Event) -> Dict[str, Any]:
    """The on-disk schema: event name + stamps flattened with the fields
    (field names never collide — ``event``/``t_wall``/``t_mono``, plus the
    identity/trace stamps ``host``/``pid``/``trace_id``, are reserved,
    docs/observability.md)."""
    rec = {"event": ev.name, "t_wall": ev.t_wall, "t_mono": ev.t_mono}
    rec.update(ev.fields)
    return rec


def process_identity(**extra: Any) -> Dict[str, Any]:
    """The standard per-process identity stamp for
    ``JsonlJournal(static_fields=...)``: ``{host, pid}`` plus any
    caller-specific fields (``worker_id``, ``component``, ...). Merged
    journals from many hosts stay attributable record by record."""
    ident: Dict[str, Any] = {"host": socket.gethostname(), "pid": os.getpid()}
    ident.update(extra)
    return ident


class RingBuffer:
    """Keep the newest ``capacity`` items; usable directly as a bus sink."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._items: collections.deque = collections.deque(maxlen=self.capacity)

    def __call__(self, event: Event) -> None:
        self.append(event)

    def append(self, item: Any) -> None:
        with self._lock:
            self._items.append(item)

    def snapshot(self) -> List[Any]:
        """Oldest-first copy of the current contents."""
        with self._lock:
            return list(self._items)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


#: records that drain the write buffer the moment they are journaled:
#: chunk-span closes (the sweep/serve heartbeat — keeps live tails at
#: most one chunk stale), per-job results and worker incidents (the
#: dispatcher post-mortem evidence), checkpoints, alerts, and fleet
#: samples (the collector series is tailed while live)
_FLUSH_EVENTS = frozenset({
    "sweep_chunk", "serve_chunk",
    E.JOB_FINISHED, E.JOB_FAILED,
    E.WORKER_DROPPED, E.WORKER_QUARANTINED,
    E.CHECKPOINT_WRITTEN, E.CHAOS_FAULT,
    E.ALERT, E.SLO_ALERT,
    E.FLEET_SAMPLE, E.DEVICE_TELEMETRY,
})


class JsonlJournal:
    """Rotating JSONL event sink; subscribe it to a bus, or call directly."""

    def __init__(
        self,
        path: str,
        max_bytes: int = 16 * 1024 * 1024,
        max_files: int = 3,
        static_fields: Optional[Dict[str, Any]] = None,
        buffer_bytes: int = 64 * 1024,
    ):
        if max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        self.path = path
        self.max_bytes = int(max_bytes)
        self.max_files = max(int(max_files), 1)
        #: write-buffer threshold; 0 restores write-through (one
        #: write+flush per record)
        self.buffer_bytes = max(int(buffer_bytes), 0)
        #: identity stamp merged into every record (record keys win) —
        #: see :func:`process_identity`
        self.static_fields = dict(static_fields) if static_fields else None
        self._lock = threading.Lock()
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        self._fh = open(path, "a", encoding="utf-8")
        self._size = os.path.getsize(path)
        self.rotations = 0
        self._pending: List[str] = []
        self._pending_bytes = 0
        #: physical write+flush count — a batched run's flushes stay far
        #: below its record count (asserted by the timeline e2e test)
        self.flushes = 0

    # --------------------------------------------------------------- writing
    def __call__(self, event: Event) -> None:
        self.write_record(event_to_record(event))

    def write_record(self, record: Dict[str, Any]) -> None:
        if self.static_fields:
            record = dict(record)
            for k, v in self.static_fields.items():
                record.setdefault(k, v)
        try:
            line = json.dumps(record, default=_jsonable, allow_nan=False) + "\n"
        except ValueError:
            # non-finite float somewhere in the record: sanitize to null
            # (strict-JSON guarantee; the fast path above stays one dumps)
            line = json.dumps(
                _definite(record), default=_jsonable, allow_nan=False
            ) + "\n"
        data = line.encode("utf-8")
        with self._lock:
            if self._fh is None:
                return  # closed: late emits from draining threads are dropped
            # _size counts buffered bytes too, so rotate-before-exceed
            # judges exactly what WILL be in the file once flushed —
            # byte-identical to the write-through path
            if self._size > 0 and self._size + len(data) > self.max_bytes:
                self._rotate_locked()
            self._pending.append(line)
            self._pending_bytes += len(data)
            self._size += len(data)
            if (
                self._pending_bytes >= self.buffer_bytes
                or record.get("event") in _FLUSH_EVENTS
            ):
                self._flush_locked()

    def _flush_locked(self) -> None:
        # callers hold self._lock (write_record / _rotate_locked /
        # flush / close)
        if not self._pending:
            return
        self._fh.write("".join(self._pending))  # graftlint: disable=lock-coverage — caller holds self._lock
        self._fh.flush()  # graftlint: disable=lock-coverage — caller holds self._lock
        self._pending.clear()
        self._pending_bytes = 0  # graftlint: disable=lock-coverage — caller holds self._lock
        self.flushes += 1

    def flush(self) -> None:
        """Drain the write buffer to disk now."""
        with self._lock:
            if self._fh is not None:
                self._flush_locked()

    def _rotate_locked(self) -> None:
        # sole caller is write_record, inside `with self._lock:`
        self._flush_locked()  # buffered lines belong to the OLD file
        self._fh.close()  # graftlint: disable=lock-coverage — caller holds self._lock
        oldest = f"{self.path}.{self.max_files}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for k in range(self.max_files - 1, 0, -1):
            src = f"{self.path}.{k}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{k + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._fh = open(self.path, "a", encoding="utf-8")  # graftlint: disable=lock-coverage — caller holds self._lock
        self._size = 0  # graftlint: disable=lock-coverage — caller holds self._lock
        self.rotations += 1

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._flush_locked()
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "JsonlJournal":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


# ---------------------------------------------------------------- reading
def journal_paths(path: str) -> List[str]:
    """Every on-disk file of one journal, oldest first: ``path.N`` down to
    ``path.1``, then the live ``path``."""
    rotated = []
    k = 1
    while os.path.exists(f"{path}.{k}"):
        rotated.append(f"{path}.{k}")
        k += 1
    out = list(reversed(rotated))
    if os.path.exists(path):
        out.append(path)
    return out


def read_journal_ex(path: str) -> "Tuple[List[Dict[str, Any]], int]":
    """All records of a (possibly rotated) journal, oldest first, plus
    the number of unparseable/non-object lines that were skipped.

    Skipping (a crash mid-write tears the final line) is deliberate — a
    post-mortem reader must survive the crash it documents — but the
    count is reported so the CLI can WARN instead of silently narrowing
    the evidence.
    """
    records: List[Dict[str, Any]] = []
    skipped = 0
    for fn in journal_paths(path):
        with open(fn, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    skipped += 1
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
                else:
                    skipped += 1
    return records, skipped


def read_journal(path: str) -> List[Dict[str, Any]]:
    """:func:`read_journal_ex` without the skip count."""
    return read_journal_ex(path)[0]
