"""The reference's simulated-transport cases (tests/test_wire_transport.py)
on the port's `rpc` package: encoding round-trips of primitives and of
the port's registered messages, refusal of an unregistered type, a
NetworkRef's round trip through the sim, and the simulated network's
serialize-everything delivery; and its TCP and TLS cases over the
port's `rpc/tcp.py`: a dying connection fails pending requests and a
later one reconnects, a localhost counter service, and mutual TLS with
a rogue certificate refused at the handshake (its 240 s bound kept:
loaded machines starve TLS handshakes); and a TLS connection on
descriptors above FD_SETSIZE."""

import os

import pytest

torch = pytest.importorskip("torch")

import foundationdb_tpu_torch.flow as fl  # noqa: E402
from foundationdb_tpu_torch.rpc import SimNetwork, wire  # noqa: E402
from foundationdb_tpu_torch.server.types import (  # noqa: E402
    CommitRequest, KeySelector, MutationRef, SET_VALUE, TLogCommitRequest,
    TLogPeekReply, TaggedMutation)


def test_roundtrip_primitives_and_messages():
    samples = [
        None, True, False, 0, -1, 1 << 40, -(1 << 70), 3.5, b"", b"abc",
        "héllo", (1, b"x", None), [1, 2, 3], {b"k": (1, 2)},
        MutationRef(SET_VALUE, b"k", b"v"),
        CommitRequest(7, ((b"a", b"b"),), (), (
            MutationRef(SET_VALUE, b"k", b"v"),)),
        TLogCommitRequest(1, 2, (TaggedMutation(
            (0, 3), MutationRef(SET_VALUE, b"k", b"v")),), 5),
        TLogPeekReply(((5, (MutationRef(SET_VALUE, b"a", b"1"),)),), 9, 3),
        KeySelector(b"k", True, -2),
    ]
    for s in samples:
        got = wire.from_bytes(wire.to_bytes(s), None)
        assert got == s, (s, got)


def test_unregistered_type_is_rejected():
    class Sneaky:
        pass

    with pytest.raises(wire.WireError):
        wire.to_bytes(Sneaky())


def test_network_ref_roundtrips_through_sim():
    fl.set_seed(3)
    s = fl.Scheduler(virtual=True)
    fl.set_scheduler(s)
    try:
        net = SimNetwork(s, fl.g_random)
        from foundationdb_tpu_torch.rpc import RequestStream
        proc = net.new_process("svc", machine="m")
        stream = RequestStream(proc)
        ref = stream.ref()
        got = wire.from_bytes(wire.to_bytes(ref), net)
        assert got.endpoint.process is proc
        assert got.endpoint.token == ref.endpoint.token
        # a ref to a vanished process resolves to a dead tombstone
        ghost = wire.from_bytes(wire.to_bytes(ref), net)
        del net.processes["svc"]
        ghost2 = wire.from_bytes(wire.to_bytes(ref), net)
        assert not ghost2.endpoint.process.alive
        assert ghost.endpoint.process.alive  # resolved before the vanish
    finally:
        fl.set_scheduler(None)


def test_sim_delivery_serializes_messages():
    """The simulated network round-trips every request and reply, so a
    mutable object sent by reference CANNOT leak shared state across
    the 'wire'."""
    fl.set_seed(5)
    s = fl.Scheduler(virtual=True)
    fl.set_scheduler(s)
    try:
        net = SimNetwork(s, fl.g_random)
        from foundationdb_tpu_torch.rpc import RequestStream
        server = net.new_process("server", machine="a")
        client = net.new_process("client", machine="b")
        stream = RequestStream(server)

        received = []

        async def serve():
            req, reply = await stream.pop()
            received.append(req)
            reply.send(req)

        async def main():
            t = fl.spawn(serve())
            m = MutationRef(SET_VALUE, b"k", b"v")
            echoed = await stream.ref().get_reply(m, client)
            await t
            assert echoed == m
            assert received[0] == m
            assert received[0] is not m      # a copy crossed the wire
            assert echoed is not received[0]  # and another on the way back
            return True

        t = s.spawn(main())
        assert s.run(until=t, timeout_time=10)
    finally:
        fl.set_scheduler(None)


def test_tcp_connection_death_fails_pending_and_reconnects():
    """A dying server connection fails in-flight requests with
    broken_promise (the sim's closed-connection semantics) and a later
    request transparently reconnects."""
    from foundationdb_tpu_torch.rpc.tcp import TcpRequestStream, TcpTransport

    fl.set_seed(13)
    s = fl.Scheduler(virtual=False)
    fl.set_scheduler(s)
    server = TcpTransport()
    client = TcpTransport()
    try:
        stream = TcpRequestStream(server)
        server.start()
        client.start()

        async def serve():
            while True:
                req, reply = await stream.pop()
                if req == "die":
                    # kill every server-side connection abruptly
                    for c in list(server._conns.values()):
                        c._die()
                    # also close sockets accepted server-side
                    reply.send(None)  # may or may not arrive
                else:
                    reply.send(req)

        async def main():
            fl.spawn(serve())
            ref = client.ref("127.0.0.1", server.port, stream.token)
            assert await ref.get_reply(41) == 41
            # sever from the CLIENT side mid-flight: pending must break
            f = ref.get_reply(42)
            for c in list(client._conns.values()):
                c._die()
            with pytest.raises(fl.FdbError) as ei:
                await f
            assert ei.value.name == "broken_promise"
            # a later request reconnects and succeeds
            assert await ref.get_reply(43) == 43
            return True

        t = s.spawn(main())
        assert s.run(until=t, timeout_time=30)
    finally:
        server.close()
        client.close()
        fl.set_scheduler(None)


def test_tcp_localhost_smoke():
    """A counter service served over REAL localhost TCP sockets with
    the wire format — request/reply framing, protocol handshake, and
    concurrent clients (the production-transport seam)."""
    from foundationdb_tpu_torch.rpc.tcp import TcpRequestStream, TcpTransport

    fl.set_seed(9)
    s = fl.Scheduler(virtual=False)   # wall clock: real sockets
    fl.set_scheduler(s)
    transport = TcpTransport()
    try:
        stream = TcpRequestStream(transport)
        transport.start()
        state = {"n": 0}

        async def serve():
            while True:
                req, reply = await stream.pop()
                if req is None:
                    reply.send(state["n"])
                else:
                    state["n"] += req
                    reply.send(state["n"])

        async def main():
            fl.spawn(serve())
            ref = transport.ref("127.0.0.1", transport.port, stream.token)
            futs = [ref.get_reply(i) for i in range(1, 6)]
            await fl.wait_for_all(futs)
            total = await ref.get_reply(None)
            assert total == 15, total
            # an unknown token breaks like a closed connection
            bad = transport.ref("127.0.0.1", transport.port, 999)
            with pytest.raises(fl.FdbError):
                await bad.get_reply(None)
            return True

        t = s.spawn(main())
        assert s.run(until=t, timeout_time=30)
    finally:
        transport.close()
        fl.set_scheduler(None)


# -- TLS (ref: FDBLibTLS — mutual certificate verification under the
# transport's connect handshake) ---------------------------------------

def _make_cert(tmp_path, name):
    import subprocess
    key = str(tmp_path / f"{name}-key.pem")
    cert = str(tmp_path / f"{name}-cert.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "2",
         "-subj", f"/CN=fdbtpu-{name}"],
        check=True, capture_output=True)
    return cert, key


def test_tcp_tls_mutual_auth(tmp_path):
    """Request/reply over mutually-authenticated TLS; a client with an
    untrusted certificate is rejected at the handshake."""
    from foundationdb_tpu_torch.rpc.tcp import (TcpRequestStream,
                                                TcpTransport, TlsConfig)

    cert, key = _make_cert(tmp_path, "cluster")
    rogue_cert, rogue_key = _make_cert(tmp_path, "rogue")
    tls = TlsConfig(cert, key, cert)

    fl.set_seed(17)
    s = fl.Scheduler(virtual=False)
    fl.set_scheduler(s)
    server = TcpTransport(tls=tls)
    client = TcpTransport(tls=tls)
    # trusts the cluster CA but presents a cert the server won't trust
    rogue = TcpTransport(tls=TlsConfig(rogue_cert, rogue_key, cert))
    try:
        stream = TcpRequestStream(server)
        server.start()
        client.start()
        rogue.start()

        async def serve():
            while True:
                req, reply = await stream.pop()
                reply.send(req * 2)

        async def main():
            fl.spawn(serve())
            ref = client.ref("127.0.0.1", server.port, stream.token)
            assert await ref.get_reply(21) == 42
            bad = rogue.ref("127.0.0.1", server.port, stream.token)
            with pytest.raises(fl.FdbError) as ei:
                await bad.get_reply(1)
            assert ei.value.name == "broken_promise"
            # the trusted client is unaffected by the rejected peer
            assert await ref.get_reply(100) == 200
            return True

        t = s.spawn(main())
        assert s.run(until=t, timeout_time=240)  # loaded machines starve TLS handshakes
    finally:
        server.close()
        client.close()
        rogue.close()
        fl.set_scheduler(None)


def test_tcp_tls_on_a_high_fd(tmp_path):
    """A TLS connection whose sockets lie above FD_SETSIZE (1024) on
    both ends carries requests both ways: the TLS reader and writer
    wait with poll, which takes any descriptor."""
    from foundationdb_tpu_torch.rpc.tcp import (TcpRequestStream,
                                                TcpTransport, TlsConfig)

    cert, key = _make_cert(tmp_path, "cluster")
    tls = TlsConfig(cert, key, cert)
    filler = []
    while not filler or filler[-1] < 1100:
        filler.append(os.open(os.devnull, os.O_RDONLY))
    fl.set_seed(19)
    s = fl.Scheduler(virtual=False)
    fl.set_scheduler(s)
    server = TcpTransport(tls=tls)
    client = TcpTransport(tls=tls)
    try:
        stream = TcpRequestStream(server)
        server.start()
        client.start()
        assert server._srv.fileno() >= 1024

        async def serve():
            while True:
                req, reply = await stream.pop()
                reply.send(req + b"!")

        async def main():
            fl.spawn(serve())
            ref = client.ref("127.0.0.1", server.port, stream.token)
            for i in range(20):
                payload = bytes([i]) * (1 << 16)   # spans TLS records
                assert await ref.get_reply(payload) == payload + b"!"
            conns = list(client._conns.values())
            assert conns and all(c.sock.fileno() >= 1024 for c in conns)
            return True

        t = s.spawn(main())
        assert s.run(until=t, timeout_time=240)
    finally:
        server.close()
        client.close()
        fl.set_scheduler(None)
        for fd in filler:
            os.close(fd)
