"""The reference's TLog cases (tests/test_tlog.py) on the port's
`server.tlog`: tag partitioning, lock (epoch end), per-tag pop,
spilling past TLOG_SPILL_THRESHOLD and size-bounded peeks.

Ref: fdbserver/TLogServer.actor.cpp tLogPeekMessages (:1138, per-tag),
tLogPop (:1050), TLogLock / epochEnd
(TagPartitionedLogSystem.actor.cpp:1265).
"""

import pytest

torch = pytest.importorskip("torch")

import foundationdb_tpu_torch.flow as fl  # noqa: E402
from foundationdb_tpu_torch.rpc import SimNetwork  # noqa: E402
from foundationdb_tpu_torch.server.tlog import TLog  # noqa: E402
from foundationdb_tpu_torch.server.types import (MutationRef, SET_VALUE,  # noqa: E402
                                                 TLogCommitRequest,
                                                 TLogLockRequest, TLogPeekRequest,
                                                 TLogPopRequest, TaggedMutation)


def _tm(tag, key, val):
    return TaggedMutation((tag,), MutationRef(SET_VALUE, key, val))


@pytest.fixture
def env():
    fl.set_seed(11)
    s = fl.Scheduler(virtual=True)
    fl.set_scheduler(s)
    net = SimNetwork(s, fl.g_random)
    proc = net.new_process("tlog", machine="m")
    client = net.new_process("client", machine="c")
    tlog = TLog(proc)
    tlog.start()
    yield s, tlog, client
    fl.set_scheduler(None)


def test_per_tag_peek_and_pop(env):
    s, tlog, client = env

    async def main():
        await tlog.commits.ref().get_reply(
            TLogCommitRequest(0, 10, (_tm(0, b"a", b"1"), _tm(1, b"x", b"9"))),
            client)
        await tlog.commits.ref().get_reply(
            TLogCommitRequest(10, 20, (_tm(1, b"y", b"8"),)), client)
        r0 = await tlog.peeks.ref().get_reply(TLogPeekRequest(1, 0), client)
        assert [v for v, _ in r0.entries] == [10]
        assert r0.entries[0][1] == (MutationRef(SET_VALUE, b"a", b"1"),)
        r1 = await tlog.peeks.ref().get_reply(TLogPeekRequest(1, 1), client)
        assert [v for v, _ in r1.entries] == [10, 20]
        # tag 0 pops past everything it has; entries with tag-1 data stay
        tlog.pops.ref().send(TLogPopRequest(20, 0), client)
        await fl.delay(0.05)
        assert [e[0] for e in tlog.entries] == [10, 20]
        tlog.pops.ref().send(TLogPopRequest(10, 1), client)
        await fl.delay(0.05)
        assert [e[0] for e in tlog.entries] == [20]
        tlog.pops.ref().send(TLogPopRequest(20, 1), client)
        await fl.delay(0.05)
        assert tlog.entries == []
        return True

    t = s.spawn(main())
    assert s.run(until=t, timeout_time=30)


def test_lock_waits_for_inflight_fsync(env):
    """A commit accepted but not yet fsynced when the lock arrives must
    be covered by the lock's end_version — otherwise the commit could be
    acked to a client after recovery chose a lower end (acked-data
    loss)."""
    s, tlog, client = env

    async def main():
        f = tlog.commits.ref().get_reply(
            TLogCommitRequest(0, 10, (_tm(0, b"a", b"1"),)), client)
        # lock races the in-flight fsync
        lock = await tlog.locks.ref().get_reply(TLogLockRequest(), client)
        assert lock.end_version == 10
        assert await f == 10  # the ack and the lock agree
        return True

    t = s.spawn(main())
    assert s.run(until=t, timeout_time=30)


def test_lock_wakes_parked_commit_waiter(env):
    """A reordered push parked on queue_version must fail out with
    tlog_stopped when the lock arrives, not hang forever (the
    gap will never be filled by a dead proxy)."""
    s, tlog, client = env

    async def main():
        # later batch arrives first and parks awaiting prev_version=10
        f2 = tlog.commits.ref().get_reply(
            TLogCommitRequest(10, 20, (_tm(0, b"b", b"2"),)), client)
        await fl.delay(0.01)
        await tlog.locks.ref().get_reply(TLogLockRequest(), client)
        with pytest.raises(fl.FdbError) as ei:
            await f2
        assert ei.value.name == "tlog_stopped"
        return True

    t = s.spawn(main())
    assert s.run(until=t, timeout_time=30)


def test_lock_wakes_parked_peek(env):
    """A long-poll peek already parked when the lock arrives returns
    (empty) instead of blocking the storage drain forever."""
    s, tlog, client = env

    async def main():
        f = tlog.peeks.ref().get_reply(TLogPeekRequest(1, 0), client)
        await fl.delay(0.01)
        await tlog.locks.ref().get_reply(TLogLockRequest(), client)
        r = await f
        assert r.entries == ()
        return True

    t = s.spawn(main())
    assert s.run(until=t, timeout_time=30)


def test_lock_stops_commits_keeps_peeks(env):
    s, tlog, client = env

    async def main():
        await tlog.commits.ref().get_reply(
            TLogCommitRequest(0, 10, (_tm(0, b"a", b"1"),)), client)
        lock = await tlog.locks.ref().get_reply(TLogLockRequest(), client)
        assert lock.end_version == 10
        with pytest.raises(fl.FdbError) as ei:
            await tlog.commits.ref().get_reply(
                TLogCommitRequest(10, 20, (_tm(0, b"b", b"2"),)), client)
        assert ei.value.name == "tlog_stopped"
        # peeks still served, and return immediately even past the end
        r = await tlog.peeks.ref().get_reply(TLogPeekRequest(1, 0), client)
        assert [v for v, _ in r.entries] == [10]
        r2 = await tlog.peeks.ref().get_reply(TLogPeekRequest(11, 0), client)
        assert r2.entries == ()
        return True

    t = s.spawn(main())
    assert s.run(until=t, timeout_time=30)


def test_peek_below_popped_stalls_with_error_trace(env):
    """Peeking at/below the tag's freed floor must emit a SevError
    TLogPeekBelowPopped event and reply with the watermark clamped below
    the hole — not crash the peek actor (an
    AttributeError there would kill the safeguard exactly when it
    fires)."""
    s, tlog, client = env

    async def main():
        for i in range(1, 6):
            await tlog.commits.ref().get_reply(
                TLogCommitRequest(i - 1, i, (_tm(0, b"k%d" % i, b"v"),),
                                  i - 1), client)
        tlog.pops.ref().send(TLogPopRequest(3, 0), client)
        await fl.delay(0.05)
        before = fl.trace.g_trace.counts.get("TLogPeekBelowPopped", 0)
        r = await tlog.peeks.ref().get_reply(TLogPeekRequest(2, 0), client)
        # clamped below begin: the reader cannot advance past the hole
        assert r.entries == () and r.committed_version == 1
        assert fl.trace.g_trace.counts.get(
            "TLogPeekBelowPopped", 0) == before + 1
        return True

    t = s.spawn(main())
    assert s.run(until=t, timeout_time=30)


def test_spill_bounds_memory_and_peeks_from_disk():
    """Once payload bytes exceed TLOG_SPILL_THRESHOLD the oldest durable
    entries spill: memory keeps only DiskQueue positions, a lagging
    reader's peek re-reads payloads from disk bit-exactly, pops still
    reclaim, and recovery after a crash still sees everything (ref:
    TLogServer updatePersistentData spill-by-reference)."""
    fl.set_seed(23)
    s = fl.Scheduler(virtual=True)
    fl.set_scheduler(s)
    try:
        net = SimNetwork(s, fl.g_random)
        proc = net.new_process("tlog-spill", machine="ms")
        client = net.new_process("client", machine="mc")
        disk = net.disk("ms")
        fl.SERVER_KNOBS.init("TLOG_SPILL_THRESHOLD", 2000)
        tlog = TLog(proc, disk=disk, name="tlog-sp")
        tlog.start()

        async def main():
            await tlog.recovered()
            val = b"v" * 100
            for i in range(1, 41):   # ~4.6KB of payload >> 2KB threshold
                await tlog.commits.ref().get_reply(
                    TLogCommitRequest(i - 1, i, (_tm(0, b"k%03d" % i, val),),
                                      i - 1), client)
            assert tlog.mem_bytes <= 2000 + 200, tlog.mem_bytes
            spilled = sum(1 for _v, m, _s in tlog.entries if m is None)
            assert spilled >= 20, spilled

            # a reader from the beginning sees every record, including
            # the spilled prefix served from disk
            reply = await tlog.peeks.ref().get_reply(
                TLogPeekRequest(1, 0), client)
            got = [(v, ms[0].param1, ms[0].param2) for v, ms in reply.entries]
            assert got == [(i, b"k%03d" % i, val) for i in range(1, 41)]

            # pops reclaim spilled records too
            tlog.set_expected_replicas({0: ("r1",)})
            tlog.pops.ref().send(TLogPopRequest(20, 0, "r1"), client)
            await fl.delay(0.1)
            assert tlog._versions[0] == 21

            # recover from the durable image alone: 21..40 survive
            tlog2 = TLog(proc, disk=disk, name="tlog-sp")
            tlog2.start()
            await tlog2.recovered()
            reply2 = await tlog2.peeks.ref().get_reply(
                TLogPeekRequest(1, 0), client)
            vs = [v for v, _ms in reply2.entries]
            assert vs[-1] == 40 and 21 in vs
            return True

        t = s.spawn(main())
        assert s.run(until=t, timeout_time=120)
    finally:
        fl.reset_server_knobs()
        fl.set_scheduler(None)


def test_peek_replies_are_size_bounded():
    """DESIRED_TOTAL_BYTES chunks big peeks: a far-behind reader drains
    in multiple rounds, the reply watermark is clamped to what was
    delivered, and no version is ever skipped."""
    fl.set_seed(29)
    s = fl.Scheduler(virtual=True)
    fl.set_scheduler(s)
    try:
        net = SimNetwork(s, fl.g_random)
        proc = net.new_process("tlog-chunk", machine="mc")
        client = net.new_process("client", machine="cc2")
        fl.SERVER_KNOBS.init("DESIRED_TOTAL_BYTES", 500)
        tlog = TLog(proc)
        tlog.start()

        async def main():
            val = b"v" * 100
            for i in range(1, 21):
                await tlog.commits.ref().get_reply(
                    TLogCommitRequest(i - 1, i,
                                      (_tm(0, b"c%03d" % i, val),), i - 1),
                    client)
            got = []
            begin = 1
            rounds = 0
            while True:
                rounds += 1
                reply = await tlog.peeks.ref().get_reply(
                    TLogPeekRequest(begin, 0), client)
                got.extend(v for v, _ms in reply.entries)
                if reply.committed_version >= 20:
                    break
                assert reply.committed_version >= begin - 1
                begin = reply.committed_version + 1
            assert got == list(range(1, 21)), got  # nothing skipped
            assert rounds >= 3, rounds             # actually chunked
            return True

        t = s.spawn(main())
        assert s.run(until=t, timeout_time=60)
    finally:
        fl.reset_server_knobs()
        fl.set_scheduler(None)
