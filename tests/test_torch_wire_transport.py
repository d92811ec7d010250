"""The reference's simulated-transport cases (tests/test_wire_transport.py)
on the port's `rpc` package: encoding round-trips of primitives and of
the port's registered messages, refusal of an unregistered type, a
NetworkRef's round trip through the sim, and the simulated network's
serialize-everything delivery. The reference's TCP and TLS cases wait
for the port's `rpc/tcp.py`."""

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
