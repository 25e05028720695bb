"""Chaos harness — seeded fault injection at the RPC boundary.

Ported from ``hpbandster_tpu/parallel/chaos.py``, a copy.

The elastic-recovery machinery (``core/recovery.py``,
``parallel/dispatcher.py``, docs/fault_tolerance.md) claims the fleet
survives worker death, preemption, network partitions, and duplicate
deliveries without losing or double-counting work. This module is how
that claim is *exercised* instead of assumed:

* :class:`ChaosSchedule` — a seeded stream of per-call fault decisions
  (kill / delay / partition / duplicate, rate-weighted). Same seed, same
  call sequence -> same fault sequence, so a chaos test is a regression
  test, not a flake generator.
* :class:`ChaosProxy` — a TCP relay interposed in front of a real
  ``parallel/rpc.py`` server (a worker, a dispatcher). Every RPC frame
  passes through it and may be delayed, dropped mid-connection (the
  client sees the peer vanish — a partition), duplicated (the backend
  serves the SAME request twice — the exactly-once gate's worst case),
  or trigger a **kill**: the proxy stops listening, so the process
  behind it looks dead to every caller (pings fail, the dispatcher
  drops it, jobs requeue) until :meth:`~ChaosProxy.revive` — a
  preempted card coming back.
* :class:`ChaosMonkey` — the fleet-level driver: a seeded background
  thread that kills a fraction of the interposed workers at each tick
  and revives them after a configurable outage, producing the sustained
  churn the ``chaos`` bench tier measures throughput retention under.

Every injected fault is observable: a ``chaos_fault`` event on the bus
(``obs.CHAOS_FAULT``) and ``chaos.faults`` / ``chaos.faults_<kind>``
counters, so a post-mortem can line injected causes up against the
recovery events they provoked.

Determinism caveat: the schedule's *decision stream* is seeded, but when
many RPCs race, which call consumes which decision depends on thread
interleaving. Single-threaded call sequences replay exactly; concurrent
harness runs are statistically, not bytewise, reproducible.

Host-side stdlib only: no torch.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.parallel.rpc import (
    RPCProxy,
    _read_frame,
    format_uri,
    parse_uri,
)

__all__ = [
    "KILL",
    "DELAY",
    "PARTITION",
    "DUPLICATE",
    "ChaosSchedule",
    "ChaosProxy",
    "ChaosMonkey",
]

logger = logging.getLogger("hpbandster_tpu_torch.chaos")

#: fault kinds — the values travel in ``chaos_fault`` events and metric
#: names, so they are part of the observable vocabulary
KILL = "kill"
DELAY = "delay"
PARTITION = "partition"
DUPLICATE = "duplicate"


def _note_fault(kind: str, method: str, target: str) -> None:
    obs.emit(obs.CHAOS_FAULT, kind=kind, method=method, target=target)
    obs.get_metrics().counter("chaos.faults").inc()
    obs.get_metrics().counter(f"chaos.faults_{kind}").inc()


class ChaosSchedule:
    """Seeded per-call fault decisions.

    One RNG draw per consulted call keeps the decision stream a pure
    function of the seed and the call sequence. Rates are cumulative
    probability bands: with ``kill_rate=0.01, delay_rate=0.1`` a draw in
    ``[0, 0.01)`` kills, ``[0.01, 0.11)`` delays, the rest pass clean.

    ``methods`` restricts injection to named RPC methods (e.g. only
    ``register_result`` to hammer the exactly-once gate); None injects
    on every method except the ones chaos must not break by fiat:
    ``obs_snapshot`` (the post-mortem channel stays clean).
    """

    def __init__(
        self,
        seed: int = 0,
        kill_rate: float = 0.0,
        delay_rate: float = 0.0,
        partition_rate: float = 0.0,
        duplicate_rate: float = 0.0,
        delay_s: float = 0.05,
        methods: Optional[Tuple[str, ...]] = None,
    ):
        import random

        total = kill_rate + delay_rate + partition_rate + duplicate_rate
        if total > 1.0:
            raise ValueError(f"fault rates sum to {total} > 1")
        self.kill_rate = float(kill_rate)
        self.delay_rate = float(delay_rate)
        self.partition_rate = float(partition_rate)
        self.duplicate_rate = float(duplicate_rate)
        self.delay_s = float(delay_s)
        self.methods = tuple(methods) if methods is not None else None
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        #: every decision that injected a fault: (seq, method, kind) —
        #: the test-side ledger to line up against recovery events
        self.log: List[Tuple[int, str, str]] = []
        self._seq = 0

    def next_fault(self, method: str) -> Optional[str]:
        """The seeded decision for one call: a fault kind or None."""
        with self._lock:
            self._seq += 1
            if method == "obs_snapshot":
                return None
            if self.methods is not None and method not in self.methods:
                return None
            r = self._rng.random()
            for kind, rate in (
                (KILL, self.kill_rate),
                (PARTITION, self.partition_rate),
                (DUPLICATE, self.duplicate_rate),
                (DELAY, self.delay_rate),
            ):
                if r < rate:
                    self.log.append((self._seq, method, kind))
                    return kind
                r -= rate
            return None


class ChaosProxy:
    """A fault-injecting TCP relay in front of one RPC server.

    Callers are pointed at :attr:`uri` instead of the backend's own
    address (for a worker: re-register its nameserver entry via
    :meth:`interpose`). Frames relay verbatim — the proxy is invisible
    until the schedule says otherwise. :meth:`kill` closes the listener
    (the port stays reserved for :meth:`revive`), so every caller sees
    exactly what a dead process looks like: connection refused.
    """

    def __init__(
        self,
        backend_uri: str,
        schedule: Optional[ChaosSchedule] = None,
        host: str = "127.0.0.1",
        timeout: float = 30.0,
    ):
        self.backend_uri = backend_uri
        self.backend_addr = parse_uri(backend_uri)
        self.schedule = schedule or ChaosSchedule()
        self.timeout = float(timeout)
        self._lock = threading.Lock()
        self._listener: Optional[socket.socket] = None
        self._shutdown_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.host = host
        self.port = 0
        self.kills = 0

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "ChaosProxy":
        # port is assigned once here (before any concurrent reader exists)
        # and immutable afterwards — kill/revive rebind the same number
        listener = self._bind(self.port)
        self.port = listener.getsockname()[1]
        with self._lock:
            self._listener = listener
        self._thread = threading.Thread(
            target=self._serve, daemon=True, name=f"chaos-proxy-{self.port}"
        )
        self._thread.start()
        return self

    def _bind(self, port: int) -> socket.socket:
        family = socket.AF_INET6 if ":" in self.host else socket.AF_INET
        s = socket.socket(family, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, port))
        s.listen(16)
        # accept() must wake up to notice kill/shutdown flags
        s.settimeout(0.1)
        return s

    @property
    def uri(self) -> str:
        return format_uri(self.host, self.port)

    @property
    def alive(self) -> bool:
        with self._lock:
            return self._listener is not None

    def kill(self, reason: str = "chaos") -> None:
        """Make the backend look dead: stop listening (callers get
        connection-refused) until :meth:`revive`. Idempotent."""
        with self._lock:
            listener, self._listener = self._listener, None
            if listener is None:
                return
            self.kills += 1
        listener.close()
        _note_fault(KILL, reason, self.backend_uri)
        logger.info("chaos: killed %s (%s)", self.backend_uri, reason)

    def revive(self) -> None:
        """Rebind the SAME port — the preempted process restarting with
        its registration still valid. No-op while alive.

        The bind retries under a monotonic deadline: the accept loop's
        in-flight poll keeps the killed listener's fd alive for up to one
        accept timeout after :meth:`kill` closes it, and binding into
        that window is EADDRINUSE, not a dead port.
        """
        deadline = time.monotonic() + 2.0
        while True:
            with self._lock:
                if self._listener is not None or self._shutdown_event.is_set():
                    return
                try:
                    self._listener = self._bind(self.port)
                    break
                except OSError:
                    if time.monotonic() >= deadline:
                        raise
            time.sleep(0.02)
        logger.info("chaos: revived %s at %s", self.backend_uri, self.uri)

    def shutdown(self) -> None:
        self._shutdown_event.set()
        with self._lock:
            listener, self._listener = self._listener, None
        if listener is not None:
            listener.close()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def interpose(
        self, nameserver: str, nameserver_port: int, name: str
    ) -> None:
        """Point ``name``'s nameserver registration at this proxy — from
        here on the dispatcher discovers the proxied URI and every RPC to
        that worker runs the schedule's gauntlet."""
        RPCProxy(format_uri(nameserver, nameserver_port)).call(
            "register", name=name, uri=self.uri
        )

    # ----------------------------------------------------------------- relay
    def _serve(self) -> None:
        while not self._shutdown_event.is_set():
            with self._lock:
                listener = self._listener
            if listener is None:  # killed: play dead until revive()
                time.sleep(0.02)
                continue
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                continue  # listener closed under us (kill/shutdown race)
            threading.Thread(
                target=self._relay, args=(conn,), daemon=True
            ).start()

    def _relay(self, conn: socket.socket) -> None:
        try:
            with conn:
                conn.settimeout(self.timeout)
                raw = _read_frame(conn)
                if not raw:
                    return
                try:
                    method = json.loads(raw.decode("utf-8")).get("method", "")
                except (ValueError, UnicodeDecodeError):
                    method = ""
                fault = self.schedule.next_fault(method)
                if fault == KILL:
                    # the process dies mid-request: the in-flight call is
                    # lost AND the port goes dark
                    self.kill(reason=method)
                    return
                if fault == PARTITION:
                    _note_fault(PARTITION, method, self.backend_uri)
                    return  # close without reply: peer-vanished
                if fault == DELAY:
                    _note_fault(DELAY, method, self.backend_uri)
                    time.sleep(self.schedule.delay_s)
                reply = self._forward(raw)
                if reply is None:
                    return
                conn.sendall(reply)
                if fault == DUPLICATE:
                    # the backend genuinely serves the request AGAIN —
                    # exactly the wire-level double delivery the
                    # dispatcher's idempotency gate exists for
                    _note_fault(DUPLICATE, method, self.backend_uri)
                    self._forward(raw)
        except (OSError, ValueError) as e:
            logger.debug("chaos relay error: %r", e)

    def _forward(self, raw: bytes) -> Optional[bytes]:
        try:
            with socket.create_connection(
                self.backend_addr, timeout=self.timeout
            ) as backend:
                backend.sendall(raw)
                return _read_frame(backend)
        except (OSError, ValueError) as e:
            logger.debug("chaos forward to %s failed: %r", self.backend_uri, e)
            return None


class ChaosMonkey:
    """Seeded background churn over a set of :class:`ChaosProxy` targets.

    Each ``interval_s`` tick, every *alive* target is killed with
    probability ``kill_fraction`` (seeded RNG — a 10%-churn bench run is
    replayable); killed targets revive after ``outage_s``. ``max_dead``
    caps simultaneous corpses so the pool never reaches zero workers
    (a fleet with every slice preempted is an outage, not churn).
    """

    def __init__(
        self,
        targets: Dict[str, ChaosProxy],
        seed: int = 0,
        interval_s: float = 0.2,
        kill_fraction: float = 0.1,
        outage_s: float = 0.5,
        max_dead: Optional[int] = None,
    ):
        import random

        self.targets = dict(targets)
        self.interval_s = float(interval_s)
        self.kill_fraction = float(kill_fraction)
        self.outage_s = float(outage_s)
        self.max_dead = (
            max(len(self.targets) - 1, 1) if max_dead is None else int(max_dead)
        )
        self._rng = random.Random(seed)
        self._revive_at: Dict[str, float] = {}  # name -> monotonic deadline
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: (monotonic_t, name, action) trail for post-run correlation
        self.log: List[Tuple[float, str, str]] = []

    def start(self) -> "ChaosMonkey":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="chaos-monkey"
        )
        self._thread.start()
        return self

    def stop(self, revive_all: bool = True) -> None:
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        if revive_all:
            for name, proxy in self.targets.items():
                self._revive(name, proxy)

    def _revive(self, name: str, proxy: ChaosProxy) -> bool:
        """Guarded revive: a failed rebind (the freed ephemeral port was
        claimed during the outage) must neither kill the churn thread —
        silently turning a "10% churn" bench into a mostly-clean run —
        nor propagate out of stop() past the caller's remaining cleanup.
        The target just stays dead, loudly."""
        try:
            proxy.revive()
            return True
        except Exception as e:
            obs.get_metrics().counter("chaos.revive_failures").inc()
            logger.warning(
                "chaos: revive of %s failed (%r); target stays dead",
                name, e,
            )
            return False

    def _run(self) -> None:
        while not self._stop_event.wait(self.interval_s):
            now = time.monotonic()
            for name, deadline in list(self._revive_at.items()):
                if now >= deadline:
                    revived = self._revive(name, self.targets[name])
                    self._revive_at.pop(name, None)
                    self.log.append(
                        (now, name, "revive" if revived else "revive_failed")
                    )
            # census by actual liveness, not the pending-revive ledger: a
            # target whose revive failed is dead without a deadline, and
            # max_dead must still count it
            dead = sum(1 for p in self.targets.values() if not p.alive)
            # sorted(): dict order is insertion order already, but the
            # explicit sort makes the seeded victim sequence independent
            # of how the caller built the mapping
            for name in sorted(self.targets):
                if dead >= self.max_dead:
                    break
                proxy = self.targets[name]
                if not proxy.alive or name in self._revive_at:
                    continue
                if self._rng.random() < self.kill_fraction:
                    proxy.kill(reason="chaos_monkey")
                    self._revive_at[name] = now + self.outage_s
                    self.log.append((now, name, "kill"))
                    dead += 1
