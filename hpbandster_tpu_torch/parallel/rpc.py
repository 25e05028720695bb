"""Minimal JSON-over-TCP RPC — the transport under the host worker pool.

Ported from ``hpbandster_tpu/parallel/rpc.py``, a copy: the same newline-
framed JSON, so a port process and a reference process talk to each other.

Replaces the reference's Pyro4 + serpent substrate (SURVEY.md §2 L0/L1)
with a dependency-free stdlib implementation: one connection per call,
newline-delimited JSON frames, exceptions marshalled back as error strings.
Connection-per-call keeps liveness detection trivial (a vanished peer is a
``ConnectionError``), which the dispatcher's elastic worker handling relies
on — the same failure surface Pyro4's ``CommunicationError`` gave the
reference.

Trace and tenant context (``hpbandster_tpu_torch.obs.trace``) ride every call
as an optional ``_obs`` field beside ``method``/``params``: the proxy
injects the caller's current trace (and, in the serving tier, the current
tenant id), the server runs the handler under them. Peers that predate
the field — or the ``tenant`` key inside it — ignore it
(``.get``-based parsing), so the wire format stays backward compatible
in both directions.
"""

from __future__ import annotations

import json
import logging
import socket
import socketserver
import threading
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

from hpbandster_tpu_torch.obs import events as obs_events
from hpbandster_tpu_torch.obs import get_metrics
from hpbandster_tpu_torch.obs.trace import (
    WIRE_FIELD,
    current_wire,
    extract_tenant,
    extract_wire,
    use_tenant,
    use_trace,
)

__all__ = ["RPCServer", "RPCProxy", "RPCError", "CommunicationError", "parse_uri", "format_uri"]

logger = logging.getLogger("hpbandster_tpu_torch.rpc")


def _count(name: str) -> None:
    # looked up per call (one dict access under the registry lock, noise
    # next to a TCP round-trip) rather than cached at import: a cached
    # instrument would be orphaned by MetricsRegistry.reset()
    get_metrics().counter(name).inc()

_MAX_FRAME = 64 * 1024 * 1024  # 64 MiB per message


def parse_uri(uri: str) -> Tuple[str, int]:
    """``host:port`` -> ``(host, port)``, RFC 3986 bracket form included.

    ``[::1]:9090`` parses to ``('::1', 9090)`` — a plain ``rsplit(':')``
    would split inside the address. Bare IPv6 without brackets is rejected
    (ambiguous: every colon is a candidate separator).
    """
    if uri.startswith("["):
        host, sep, port = uri[1:].rpartition("]:")
        if not sep or not port:
            raise ValueError(f"malformed bracketed uri {uri!r}")
        return host, int(port)
    host, sep, port = uri.rpartition(":")
    if not sep or ":" in host:
        raise ValueError(f"malformed uri {uri!r} (bracket IPv6 hosts: '[::1]:9090')")
    return host, int(port)


def format_uri(host: str, port: int) -> str:
    """Inverse of :func:`parse_uri`: brackets IPv6 hosts."""
    return f"[{host}]:{port}" if ":" in host else f"{host}:{port}"


class RPCError(Exception):
    """The remote method raised; carries the remote traceback string."""


class CommunicationError(Exception):
    """The peer is unreachable / vanished (connect or read failure)."""


def _read_frame(sock: socket.socket) -> Optional[bytes]:
    chunks = []
    total = 0
    while True:
        chunk = sock.recv(65536)
        if not chunk:
            if chunks:
                # the peer closed mid-frame: surface it as the transport
                # failure it is, not as the json.JSONDecodeError the
                # partial payload would later raise
                raise CommunicationError(
                    f"truncated frame: peer closed after {total} bytes"
                )
            return None
        chunks.append(chunk)
        total += len(chunk)
        if total > _MAX_FRAME:
            raise CommunicationError("frame too large")
        if chunk.endswith(b"\n"):
            return b"".join(chunks)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        server: "RPCServer" = self.server  # type: ignore[assignment]
        try:
            raw = _read_frame(self.request)
            if not raw:
                return
            msg = json.loads(raw.decode("utf-8"))
            method = msg.get("method", "")
            params = msg.get("params", {})
            _count("rpc.server_requests")
            fn = server.methods.get(method)
            if fn is None:
                _count("rpc.server_unknown_method")
                reply = {"error": f"unknown method {method!r}"}
            else:
                try:
                    # run the handler under the caller's trace AND tenant
                    # context (the optional _obs envelope beside
                    # method/params); a missing or malformed envelope is
                    # simply no trace / no tenant
                    wire = msg.get(WIRE_FIELD)
                    with use_trace(extract_wire(wire)), use_tenant(
                        extract_tenant(wire)
                    ):
                        reply = {"result": fn(**params)}
                except Exception:
                    _count("rpc.server_handler_errors")
                    reply = {"error": traceback.format_exc()}
            self.request.sendall(json.dumps(reply).encode("utf-8") + b"\n")
        except (CommunicationError, ConnectionError, OSError, json.JSONDecodeError) as e:
            logger.debug("rpc handler error: %r", e)


class _ThreadingTCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class _ThreadingTCP6Server(_ThreadingTCPServer):
    address_family = socket.AF_INET6


class RPCServer:
    """Serve a dict of callables over TCP; one daemon thread per connection.

    IPv6 hosts (any host containing ':') bind an AF_INET6 socket and render
    their :attr:`uri` in bracket form, round-tripping through
    :func:`parse_uri` on the proxy side.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.methods: Dict[str, Callable[..., Any]] = {}
        server_cls = _ThreadingTCP6Server if ":" in host else _ThreadingTCPServer
        self._server = server_cls((host, port), _Handler)
        self._server.methods = self.methods  # type: ignore[attr-defined]
        self.host, self.port = self._server.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def register(self, name: str, fn: Callable[..., Any]) -> None:
        self.methods[name] = fn

    def register_instance(self, obj: Any, prefix: str = "") -> None:
        """Expose every public method of ``obj`` (Pyro4 'expose' analog)."""
        for name in dir(obj):
            if name.startswith("_"):
                continue
            fn = getattr(obj, name)
            if callable(fn):
                self.methods[prefix + name] = fn

    @property
    def uri(self) -> str:
        return format_uri(self.host, self.port)

    def start(self) -> "RPCServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name=f"rpc-server-{self.port}",
        )
        self._thread.start()
        return self

    def shutdown(self) -> None:
        # socketserver's shutdown() waits for serve_forever to return: on
        # a server never started it would wait forever
        if self._thread is not None:
            self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)


class RPCProxy:
    """Call methods on a remote RPCServer; connection per call."""

    def __init__(self, uri: str, timeout: float = 10.0):
        self.addr: Tuple[str, int] = parse_uri(uri)
        self.uri = uri
        self.timeout = timeout

    def call(self, method: str, **params: Any) -> Any:
        msg: Dict[str, Any] = {"method": method, "params": params}
        wire = current_wire()  # one ContextVar read when no trace is active
        if wire is not None:
            msg[WIRE_FIELD] = wire
        payload = json.dumps(msg).encode("utf-8")
        _count("rpc.client_calls")
        try:
            # the flight-recorder hop span (obs/timeline.py renders it as
            # the RPC-phase slice of a trace's row): span() is near-free
            # when no sink listens — no clock reads, no event. peer rides
            # the record so the rpc_retry_rate SLO's journal evidence can
            # be cut per endpoint post-hoc.
            with obs_events.span(
                obs_events.RPC_CLIENT_CALL, method=method, peer=self.uri
            ):
                with socket.create_connection(
                    self.addr, timeout=self.timeout
                ) as sock:
                    sock.sendall(payload + b"\n")
                    raw = _read_frame(sock)
        except CommunicationError:
            # _read_frame's own failures (truncated / oversized frame) are
            # communication errors too — count them like every other one
            _count("rpc.client_comm_errors")
            raise
        except (ConnectionError, OSError) as e:
            _count("rpc.client_comm_errors")
            raise CommunicationError(f"cannot reach {self.uri}: {e!r}") from e
        if not raw:
            _count("rpc.client_comm_errors")
            raise CommunicationError(f"{self.uri} closed the connection")
        # bytes on the wire, both ways (the host tier's transfer volume)
        metrics = get_metrics()
        metrics.counter("rpc.client_bytes_sent").inc(len(payload) + 1)
        metrics.counter("rpc.client_bytes_received").inc(len(raw))
        reply = json.loads(raw.decode("utf-8"))
        if "error" in reply:
            _count("rpc.client_remote_errors")
            raise RPCError(reply["error"])
        return reply.get("result")

    def __getattr__(self, name: str) -> Callable[..., Any]:
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda **params: self.call(name, **params)
