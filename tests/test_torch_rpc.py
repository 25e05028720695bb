"""The port's TCP RPC transport (``hpbandster_tpu_torch/parallel/rpc.py``)
and its network helpers, on the CPU.

The cases of the reference's ``tests/test_rpc.py``, run on the port; then
the port against the reference over real sockets: a port ``RPCProxy``
calling a reference ``RPCServer`` and the reverse get the same replies,
an ``RPCError`` carrying the remote traceback, NaN and +/-inf intact and
the caller's trace id (exact: the frames are the same JSON)."""

import math
import socket
import threading

import pytest

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.parallel import rpc as port_rpc

from hpbandster_tpu_torch.parallel.rpc import (
    CommunicationError,
    RPCError,
    RPCProxy,
    RPCServer,
    format_uri,
    parse_uri,
)
from tests.test_torch_harness import ref, ref_host  # noqa: F401


@pytest.fixture
def server():
    srv = RPCServer("127.0.0.1", 0)
    srv.register("echo", lambda x: x)
    srv.register("add", lambda a, b: a + b)

    def boom():
        raise ValueError("kaboom")

    srv.register("boom", boom)
    srv.start()
    yield srv
    srv.shutdown()


class TestRPC:
    def test_basic_call(self, server):
        proxy = RPCProxy(server.uri)
        assert proxy.call("echo", x={"nested": [1, 2.5, "s", None]}) == {
            "nested": [1, 2.5, "s", None]
        }
        assert proxy.call("add", a=2, b=3) == 5
        # attribute-style sugar
        assert proxy.add(a=1, b=1) == 2

    def test_unknown_method(self, server):
        with pytest.raises(RPCError, match="unknown method"):
            RPCProxy(server.uri).call("nope")

    def test_remote_exception_carries_traceback(self, server):
        with pytest.raises(RPCError, match="kaboom"):
            RPCProxy(server.uri).call("boom")

    def test_dead_peer_is_communication_error(self, server):
        uri = server.uri
        server.shutdown()
        with pytest.raises(CommunicationError):
            RPCProxy(uri, timeout=1).call("echo", x=1)

    def test_concurrent_calls(self, server):
        results, errors = [], []

        def hammer(i):
            try:
                results.append(RPCProxy(server.uri).call("add", a=i, b=i))
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=hammer, args=(i,)) for i in range(20)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        assert sorted(results) == [2 * i for i in range(20)]

    def test_register_instance(self):
        class Service:
            def ping(self):
                return "pong"

            def _private(self):  # must not be exposed
                return "secret"

        srv = RPCServer("127.0.0.1", 0)
        srv.register_instance(Service())
        srv.start()
        try:
            assert RPCProxy(srv.uri).call("ping") == "pong"
            with pytest.raises(RPCError, match="unknown method"):
                RPCProxy(srv.uri).call("_private")
        finally:
            srv.shutdown()


def _ipv6_loopback_available() -> bool:
    if not socket.has_ipv6:
        return False
    try:
        s = socket.socket(socket.AF_INET6, socket.SOCK_STREAM)
        try:
            s.bind(("::1", 0))
        finally:
            s.close()
        return True
    except OSError:
        return False


class TestURIParsing:
    def test_ipv4(self):
        assert parse_uri("127.0.0.1:9090") == ("127.0.0.1", 9090)

    def test_hostname(self):
        assert parse_uri("worker-3.local:80") == ("worker-3.local", 80)

    def test_bracketed_ipv6(self):
        assert parse_uri("[::1]:9090") == ("::1", 9090)
        assert parse_uri("[fe80::a:b]:1234") == ("fe80::a:b", 1234)

    def test_roundtrip_through_format(self):
        for host, port in [("::1", 9090), ("10.0.0.2", 80), ("fe80::1", 1)]:
            assert parse_uri(format_uri(host, port)) == (host, port)

    def test_bare_ipv6_rejected(self):
        # every colon is a candidate separator — must be bracketed
        with pytest.raises(ValueError, match="bracket"):
            parse_uri("::1:9090")

    def test_malformed_bracket_rejected(self):
        with pytest.raises(ValueError, match="malformed"):
            parse_uri("[::1]")

    def test_proxy_parses_bracketed_uri(self):
        proxy = RPCProxy("[::1]:9090", timeout=1)
        assert proxy.addr == ("::1", 9090)

    def test_internal_uri_builders_bracket_ipv6(self):
        # every internal nameserver-URI construction must round-trip IPv6
        # through format_uri (a bare f"{host}:{port}" would build '::1:9090',
        # which parse_uri rightly rejects)
        from hpbandster_tpu_torch.parallel.dispatcher import Dispatcher

        d = Dispatcher(run_id="uri6", nameserver="::1", nameserver_port=9090)
        assert d.nameserver_uri == "[::1]:9090"
        assert parse_uri(d.nameserver_uri) == ("::1", 9090)

    @pytest.mark.skipif(
        not _ipv6_loopback_available(), reason="no IPv6 loopback on this host"
    )
    def test_ipv6_end_to_end(self):
        srv = RPCServer("::1", 0)
        srv.register("echo", lambda x: x)
        srv.start()
        try:
            assert srv.uri.startswith("[::1]:")
            assert RPCProxy(srv.uri).call("echo", x=42) == 42
        finally:
            srv.shutdown()


class TestUtils:
    def test_nic_name_to_host(self):
        from hpbandster_tpu_torch.utils import nic_name_to_host

        import sys

        assert nic_name_to_host(None) == "127.0.0.1"
        # loopback interface resolves via SIOCGIFADDR, a linux-only ioctl;
        # other platforms take the gethostbyname fallback
        if sys.platform == "linux":
            assert nic_name_to_host("lo") == "127.0.0.1"
        host = nic_name_to_host("definitely-not-a-nic")
        assert isinstance(host, str) and host

    def test_start_local_nameserver(self):
        from hpbandster_tpu_torch.utils import start_local_nameserver

        ns, host, port = start_local_nameserver()
        try:
            from hpbandster_tpu_torch.parallel.rpc import RPCProxy

            assert RPCProxy(f"{host}:{port}").call("ping") == "pong"
        finally:
            ns.shutdown()


# ------------------------------------------------------ against the reference
def _serve(rpc_module, obs_module):
    """An RPC server of one package with the same handlers: echo, a
    non-finite payload, a raising method, and the trace id and tenant the
    handler runs under (read through ``obs_module``)."""
    srv = rpc_module.RPCServer("127.0.0.1", 0)
    srv.register("echo", lambda x: x)
    srv.register("nonfinite", lambda: [math.nan, math.inf, -math.inf, 1.5])

    def boom():
        raise ValueError("kaboom")

    def context():
        tc = obs_module.current_trace()
        return {"trace_id": tc.trace_id if tc is not None else None,
                "tenant": obs_module.current_tenant()}

    srv.register("boom", boom)
    srv.register("context", context)
    return srv.start()


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_frames_cross_packages(ref_host, direction):  # noqa: F811
    """A proxy of one package against a server of the other: replies equal
    to the same-package call, the remote traceback in ``RPCError``, NaN and
    +/-inf intact, the trace id and tenant carried in the envelope."""
    port_side = (port_rpc, obs)
    ref_side = (ref_host.rpc, ref_host.obs)
    (client_rpc, client_obs), (server_rpc, server_obs) = (
        (port_side, ref_side) if direction == "port_to_reference" else (ref_side, port_side))
    srv = _serve(server_rpc, server_obs)
    same = _serve(client_rpc, client_obs)
    try:
        for target in (srv, same):
            proxy = client_rpc.RPCProxy(target.uri, timeout=5)
            assert proxy.call("echo", x={"a": [1, 2.5, "s", None]}) == {"a": [1, 2.5, "s", None]}
            nan, pinf, ninf, x = proxy.call("nonfinite")
            assert math.isnan(nan) and pinf == math.inf and ninf == -math.inf and x == 1.5
            with pytest.raises(client_rpc.RPCError) as err:
                proxy.call("boom")
            assert "ValueError: kaboom" in str(err.value)
            assert "Traceback" in str(err.value)
            with pytest.raises(client_rpc.RPCError, match="unknown method"):
                proxy.call("nope")
            trace = client_obs.new_trace("cross")
            with client_obs.use_trace(trace), client_obs.use_tenant("acme"):
                got = proxy.call("context")
            assert got == {"trace_id": trace.trace_id, "tenant": "acme"}
            assert proxy.call("context") == {"trace_id": None, "tenant": None}
    finally:
        srv.shutdown()
        same.shutdown()


def test_uri_helpers_equal_reference(ref_host):  # noqa: F811
    for uri in ("127.0.0.1:9090", "host.example:1", "[::1]:9090", "[fe80::1%eth0]:5"):
        assert parse_uri(uri) == ref_host.rpc.parse_uri(uri)
    for host, port in (("127.0.0.1", 1), ("::1", 2), ("name", 3)):
        assert format_uri(host, port) == ref_host.rpc.format_uri(host, port)
    for bad in ("::1:9090", "[::1]9090", "nocolon"):
        with pytest.raises(ValueError):
            parse_uri(bad)
        with pytest.raises(ValueError):
            ref_host.rpc.parse_uri(bad)


def test_shutdown_of_a_server_never_started_returns():
    """``shutdown`` closes a server that was bound but never started (the
    reference's waits for a serve loop that never ran); the port is then
    free and a call to it is a ``CommunicationError``."""
    srv = RPCServer("127.0.0.1", 0)
    uri = srv.uri
    done = threading.Event()
    t = threading.Thread(target=lambda: (srv.shutdown(), done.set()), daemon=True)
    t.start()
    assert done.wait(timeout=5)
    with pytest.raises(CommunicationError):
        RPCProxy(uri, timeout=2).call("ping")


def test_bytes_on_the_wire_are_counted():
    """The proxy counts the bytes it sends and receives (the host tier's
    transfer volume): one frame each way, newline included."""
    srv = RPCServer("127.0.0.1", 0)
    srv.register("echo", lambda x: x)
    srv.start()
    m = obs.get_metrics()
    sent0 = m.counter("rpc.client_bytes_sent").value
    recv0 = m.counter("rpc.client_bytes_received").value
    try:
        assert RPCProxy(srv.uri, timeout=5).call("echo", x="abc") == "abc"
    finally:
        srv.shutdown()
    assert m.counter("rpc.client_bytes_sent").value - sent0 == len(
        b'{"method": "echo", "params": {"x": "abc"}}\n')
    assert m.counter("rpc.client_bytes_received").value - recv0 == len(b'{"result": "abc"}\n')
