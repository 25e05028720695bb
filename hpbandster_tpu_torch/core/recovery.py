"""Crash recovery: write-ahead result journal + exactly-once replay.

Ported from ``hpbandster_tpu/core/recovery.py``, a copy; a WAL either
package writes, the other reads.

The elastic fleet loses processes, not work (docs/fault_tolerance.md):

* **Idempotency keys** — every job carries one stable key,
  :func:`idempotency_key` of its ``(config_id, budget)``. A job requeued
  onto another worker, a late dead-letter arrival, and a worker's
  delivery retry racing a slow ack all compute the SAME logical result,
  so the key is what lets every ingest point recognize "already have it".
* **:class:`ExactlyOnceGate`** — the thread-safe seen-set those ingest
  points share: ``admit(key)`` is True exactly once per key, so one
  result is registered into the bracket exactly once no matter how many
  copies arrive.
* **:class:`ResultWAL`** — a write-ahead JSONL journal of terminal
  results. The Master appends each result BEFORE bracket bookkeeping
  consumes it; after a crash, the WAL tail covers everything the last
  periodic checkpoint missed. Appends are line-atomic (a crash mid-write
  truncates at most the final line, which replay tolerates), first
  record per key wins.
* **:class:`DeadLetterBox`** — the dispatcher's bounded retention of
  results that arrived for unknown jobs, keyed so a resubmitted job can
  :meth:`~DeadLetterBox.take` its stranded payload and join it back
  exactly once. Overflow is COUNTED (``dispatcher.dead_letters_dropped``)
  instead of silent.
* **:func:`resume_master`** — crash-restart: restore the checkpoint into
  a fresh optimizer, replay the WAL tail into the restored brackets
  (only records matching a still-QUEUED datum at its current budget are
  eligible), and return the stats. A subsequent ``run()`` re-dispatches
  ONLY the configs with no recorded terminal result.

Everything here is host-side stdlib: no torch.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.core.iteration import Status
from hpbandster_tpu_torch.core.job import Job

__all__ = [
    "idempotency_key",
    "ExactlyOnceGate",
    "ResultWAL",
    "DeadLetterBox",
    "replay_wal_into_master",
    "ingested_keys",
    "resume_master",
]

logger = logging.getLogger("hpbandster_tpu_torch.recovery")


def idempotency_key(config_id: Iterable[Any], budget: Any) -> str:
    """Stable exactly-once identity of one logical evaluation.

    Keyed by what makes the result a duplicate — the ``(config_id,
    budget)`` pair — NOT by dispatch attempt: a requeue re-computes the
    same logical result, and the second copy to arrive must be
    recognized. ``%g`` budget formatting matches the journal readers'
    (``9`` and ``9.0`` are one rung).
    """
    cid = "-".join(str(int(x)) for x in config_id)
    return f"{cid}@{float(budget):g}"


class ExactlyOnceGate:
    """Thread-safe admit-once set over idempotency keys."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seen: Set[str] = set()

    def admit(self, key: str) -> bool:
        """True the first time ``key`` is presented, False ever after."""
        with self._lock:
            if key in self._seen:
                return False
            self._seen.add(key)
            return True

    def seen(self, key: str) -> bool:
        with self._lock:
            return key in self._seen

    def mark(self, keys: Iterable[str]) -> None:
        """Pre-admit ``keys`` (restore path: results the checkpoint or WAL
        already accounted for must read as duplicates from now on)."""
        with self._lock:
            self._seen.update(keys)

    def __len__(self) -> int:
        with self._lock:
            return len(self._seen)


class ResultWAL:
    """Append-only JSONL write-ahead journal of terminal results.

    One line per result, written (and flushed) BEFORE the in-memory
    bracket state consumes it — so the crash window between "result
    arrived" and "checkpoint wrote it" loses nothing. First record per
    idempotency key wins; duplicates are not re-written.

    ``fsync=True`` additionally fsyncs per append (durability against
    host power loss, at measurable cost); the default flush survives
    process death, which is the failure the fleet actually has.

    ``run_id`` stamps every record: idempotency keys restart at
    ``(0,0,0)@1`` for every run, so a wal_path reused across
    INDEPENDENT runs would otherwise suppress the new run's journaling
    (stale keys pre-seeding the dedup set) and replay the previous
    run's losses after a crash. With the stamp, a foreign run's leftover
    records neither pre-seed dedup nor replay (and a loud warning names
    them); records without a stamp (legacy WALs) keep the old behavior.
    """

    def __init__(
        self, path: str, fsync: bool = False, run_id: Optional[str] = None
    ):
        self.path = path
        self.fsync = bool(fsync)
        self.run_id = run_id
        self._lock = threading.Lock()
        self._seen: Set[str] = set()
        directory = os.path.dirname(path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        # a reopened WAL continues its dedup set from disk: a restarted
        # master appending to the same path cannot double-record a key.
        # Only THIS run's (or unstamped legacy) records count — another
        # run's leftovers must not suppress this run's journaling.
        foreign = 0
        for rec in self.read(path):
            if _run_matches(rec, run_id):
                self._seen.add(rec["key"])
            else:
                foreign += 1
        if foreign:
            logger.warning(
                "WAL %s holds %d record(s) from another run (reused "
                "path?); they will not dedup or replay into run %r",
                path, foreign, run_id,
            )
        self._fh = open(path, "a", encoding="utf-8")

    def append(
        self,
        key: str,
        config_id: Iterable[Any],
        budget: float,
        result: Optional[Dict[str, Any]],
        exception: Optional[str],
        timestamps: Optional[Dict[str, float]] = None,
    ) -> bool:
        """Record one terminal result; False if ``key`` was already
        recorded (first wins). Strict JSON — non-finite floats inside
        ``result`` would poison replay, so they are nulled recursively.
        """
        rec = {
            "key": key,
            "config_id": [int(x) for x in config_id],
            "budget": float(budget),
            "result": result,
            "exception": exception,
            "timestamps": dict(timestamps or {}),
        }
        if self.run_id is not None:
            rec["run_id"] = self.run_id
        try:
            line = json.dumps(rec, allow_nan=False)
        except (ValueError, TypeError):
            # the journal's strict-JSON slow path: recursive non-finite
            # nulling + non-JSON-type coercion (numpy scalars in a
            # result dict), one sanitizer for every JSONL surface
            from hpbandster_tpu_torch.obs.journal import _definite, _jsonable

            line = json.dumps(
                _definite(rec), default=_jsonable, allow_nan=False
            )
        with self._lock:
            if key in self._seen:
                return False
            if self._fh.closed:
                return False
            self._seen.add(key)
            self._fh.write(line + "\n")
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
        obs.get_metrics().counter("recovery.wal_records").inc()
        return True

    def keys(self) -> Set[str]:
        with self._lock:
            return set(self._seen)

    def truncate(self) -> None:
        """Drop every record (called right after a successful checkpoint:
        the checkpoint now carries this state, the WAL restarts empty)."""
        with self._lock:
            self._fh.close()
            self._fh = open(self.path, "w", encoding="utf-8")
            self._seen.clear()

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    @staticmethod
    def read(path: str) -> List[Dict[str, Any]]:
        """Replay records from disk, oldest first, first-per-key wins.
        A truncated final line (crash mid-append) is tolerated; corrupt
        interior lines are skipped with a warning."""
        records: List[Dict[str, Any]] = []
        seen: Set[str] = set()
        try:
            fh = open(path, "r", encoding="utf-8")
        except FileNotFoundError:
            return records
        with fh:
            for lineno, line in enumerate(fh, start=1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    logger.warning(
                        "WAL %s line %d unreadable (crash mid-write?); "
                        "skipped", path, lineno,
                    )
                    continue
                key = rec.get("key")
                if not isinstance(key, str) or key in seen:
                    continue
                seen.add(key)
                records.append(rec)
        return records


def _run_matches(rec: Dict[str, Any], run_id: Optional[str]) -> bool:
    """A WAL record belongs to ``run_id`` when either side is unstamped
    (legacy records / callers) or the stamps agree."""
    rec_run = rec.get("run_id")
    return rec_run is None or run_id is None or rec_run == run_id


class DeadLetterBox:
    """Bounded keyed retention of results that arrived for unknown jobs.

    The dispatcher's replacement for its old anonymous ring: same
    ``snapshot()`` surface (the health endpoint's ring tail), plus
    :meth:`take` — a resubmitted job can claim its stranded payload by
    idempotency key and join it back exactly once — and a drop COUNTER
    (``dispatcher.dead_letters_dropped``) where overflow used to be
    silent.
    """

    def __init__(self, capacity: int = 64):
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._items: "List[Dict[str, Any]]" = []
        self.dropped = 0

    def append(self, item: Dict[str, Any]) -> None:
        key = item.get("key")
        with self._lock:
            if key is not None and any(
                i.get("key") == key for i in self._items
            ):
                # a second copy of the same stranded result (chaos
                # duplicate frames, delivery retries): one payload is
                # enough to replay — retaining both would let garbage
                # copies evict OTHER jobs' genuine payloads
                duplicate = True
            else:
                duplicate = False
                self._items.append(item)
            overflow = len(self._items) - self.capacity
            if overflow > 0:
                del self._items[:overflow]
                self.dropped += overflow
        if duplicate:
            obs.get_metrics().counter("recovery.duplicates_dropped").inc()
            logger.info(
                "duplicate dead letter for key %s dropped (payload already "
                "retained)", key,
            )
        if overflow > 0:
            obs.get_metrics().counter(
                "dispatcher.dead_letters_dropped"
            ).inc(overflow)
            logger.warning(
                "dead-letter box overflow: %d oldest payload(s) dropped "
                "(capacity %d)", overflow, self.capacity,
            )

    def take(self, key: str) -> Optional[Dict[str, Any]]:
        """Remove and return the oldest retained record whose ``key``
        matches, or None."""
        with self._lock:
            for i, item in enumerate(self._items):
                if item.get("key") == key:
                    return self._items.pop(i)
        return None

    def snapshot(self) -> List[Dict[str, Any]]:
        """Oldest-first copy (HealthEndpoint ring contract)."""
        with self._lock:
            return list(self._items)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


# --------------------------------------------------------------- replay
def _eligible_datum(master, cid: Tuple[int, ...], budget: float):
    """The restored datum a WAL record may replay into: still QUEUED, at
    exactly this budget (a record for an already-promoted or
    already-recorded rung is stale — the checkpoint got there first)."""
    if not (0 <= cid[0] < len(master.iterations)):
        return None
    it = master.iterations[cid[0]]
    d = it.data.get(cid)
    if d is None or d.status != Status.QUEUED:
        return None
    if float(d.budget) != float(budget):
        return None
    return it


def replay_wal_into_master(master, wal_path: str) -> Dict[str, int]:
    """Join WAL records back into a restored Master exactly once.

    Each eligible record becomes a finished :class:`Job` pushed through
    ``master.job_callback`` — the same funnel live results take, so
    result logging, model updates, bracket advancement, and audit events
    all happen exactly as if the result had arrived normally. Records
    whose datum is not QUEUED at the recorded budget are skipped (the
    checkpoint already holds them, or the rung moved on).
    """
    stats = {"replayed": 0, "skipped": 0}
    run_id = getattr(master, "run_id", None)
    foreign = 0
    for rec in ResultWAL.read(wal_path):
        if not _run_matches(rec, run_id):
            # another run's leftovers in a reused wal_path: its keys
            # collide with this run's ((0,0,0)@1 restarts every run) but
            # its LOSSES belong to a different sweep — joining them
            # would silently corrupt the brackets
            foreign += 1
            stats["skipped"] += 1
            continue
        cid = tuple(int(x) for x in rec.get("config_id", ()))
        budget = rec.get("budget")
        if len(cid) != 3 or not isinstance(budget, (int, float)):
            stats["skipped"] += 1
            continue
        with master.thread_cond:
            it = _eligible_datum(master, cid, float(budget))
            if it is None:
                stats["skipped"] += 1
                continue
            d = it.data[cid]
            job = Job(
                cid, config=d.config, budget=float(budget),
                working_directory=getattr(master, "working_directory", "."),
            )
            job.result = rec.get("result")
            job.exception = rec.get("exception")
            for which, t in (rec.get("timestamps") or {}).items():
                if isinstance(t, (int, float)):
                    job.timestamps[which] = float(t)
            # register_result requires RUNNING; the replay IS the run
            d.status = Status.RUNNING
            it.num_running += 1
            master.num_running_jobs += 1
        master.job_callback(job)
        obs.emit(
            obs.RESULT_REPLAYED,
            config_id=list(cid), budget=float(budget),
            source="wal", key=rec.get("key"),
        )
        obs.get_metrics().counter("recovery.replayed_results").inc()
        stats["replayed"] += 1
    if foreign:
        logger.warning(
            "WAL %s: %d record(s) from another run ignored during replay "
            "into run %r (reused path?)", wal_path, foreign, run_id,
        )
    if stats["replayed"]:
        logger.info(
            "WAL replay: %d result(s) joined back, %d stale record(s) "
            "skipped", stats["replayed"], stats["skipped"],
        )
    return stats


def ingested_keys(master) -> Set[str]:
    """Every idempotency key the master's restored bracket state already
    holds a recorded result for (one per ``Datum.results`` rung entry)."""
    keys: Set[str] = set()
    for it in master.iterations:
        for cid, d in it.data.items():
            for b in d.results:
                keys.add(idempotency_key(cid, b))
    return keys


def resume_master(
    master, checkpoint_path: str, wal_path: Optional[str] = None
) -> Dict[str, int]:
    """Crash-restart a fresh optimizer: checkpoint + WAL tail.

    Restores ``checkpoint_path`` (mid-bracket state; interrupted RUNNING
    configs roll back to QUEUED), then replays ``wal_path`` so every
    result that arrived AFTER the last checkpoint re-joins without
    re-running its evaluation. The next ``run(n_iterations=<same
    total>)`` dispatches only genuinely unfinished configs.

    If the executor carries an exactly-once gate (the dispatcher does),
    it is pre-seeded with every key the restored state accounts for —
    a first-life worker that survived the crash and rediscovered the
    new pool must have its late re-delivery read as a duplicate, not a
    fresh unknown result.
    """
    master.load_checkpoint(checkpoint_path)
    stats = (
        replay_wal_into_master(master, wal_path)
        if wal_path is not None else {"replayed": 0, "skipped": 0}
    )
    gate = getattr(master.executor, "_gate", None)
    if isinstance(gate, ExactlyOnceGate):
        gate.mark(ingested_keys(master))
    return stats
