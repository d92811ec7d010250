"""The reference's durability cases (tests/test_durability.py) on the
port: sim files with power-loss semantics, the DiskQueue WAL, and the
memory KV engine (ref: fdbrpc/AsyncFileNonDurable.actor.h,
fdbserver/DiskQueue.actor.cpp, KeyValueStoreMemory.actor.cpp; test
strategy: crash-recovery invariants under randomized kills)."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.rpc import SimNetwork  # noqa: E402
from foundationdb_tpu_torch.server.diskqueue import DiskQueue  # noqa: E402
from foundationdb_tpu_torch.server.kvstore import KeyValueStoreMemory  # noqa: E402


@pytest.fixture
def sim():
    flow.set_seed(0)
    s = flow.Scheduler(virtual=True)
    flow.set_scheduler(s)
    net = SimNetwork(s, flow.g_random)
    yield s, net
    flow.set_scheduler(None)


def drive(s, coro, timeout=60):
    t = s.spawn(coro)
    return s.run(until=t, timeout_time=timeout)


def test_simfile_sync_and_power_loss(sim):
    s, net = sim
    disk = net.disk("m1")

    async def main():
        f = disk.open("f")
        await f.write(0, b"hello")
        await f.sync()
        await f.write(5, b"world")  # unsynced
        assert await f.read(0, 10) == b"helloworld"  # own writes visible
        return True

    assert drive(s, main())
    disk.power_loss(flow.g_random)
    f2 = disk.open("f")

    async def check():
        data = await f2.read(0, 10)
        # synced prefix always survives; the unsynced tail may or may not
        assert data[:5] == b"hello"
        assert data in (b"hello", b"helloworld")
        return True

    assert drive(s, check())


def test_diskqueue_roundtrip_and_pop(sim):
    s, net = sim
    disk = net.disk("m1")

    async def main():
        dq = DiskQueue(disk, "q", file_size_limit=256)
        assert await dq.recover() == []
        for i in range(20):
            await dq.push(b"rec%03d" % i)
        await dq.commit()
        dq.pop(9)  # discard the first 10
        dq2 = DiskQueue(disk, "q", file_size_limit=256)
        got = await dq2.recover()
        # un-popped records must all be there; popped ones may survive
        # until physical reclaim, but the recovered list is a contiguous
        # run ending at the last push
        assert got[-10:] == [b"rec%03d" % i for i in range(10, 20)]
        return True

    assert drive(s, main())


def test_diskqueue_commit_survives_power_loss(sim):
    s, net = sim
    disk = net.disk("m1")

    async def write_phase():
        dq = DiskQueue(disk, "q")
        await dq.recover()
        for i in range(10):
            await dq.push(b"committed%02d" % i)
        await dq.commit()
        for i in range(5):
            await dq.push(b"unsynced%02d" % i)  # never committed
        return True

    assert drive(s, write_phase())
    disk.power_loss(flow.g_random)

    async def recover_phase():
        dq = DiskQueue(disk, "q")
        got = await dq.recover()
        committed = [b"committed%02d" % i for i in range(10)]
        # all committed records survive, in order, as a prefix
        assert got[:10] == committed
        # anything beyond is a contiguous prefix of the unsynced pushes
        assert got[10:] == [b"unsynced%02d" % i for i in range(len(got) - 10)]
        return True

    assert drive(s, recover_phase())


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6])
def test_diskqueue_randomized_crash_recovery(seed):
    """Property: after any crash, recovery yields a contiguous prefix of
    everything pushed that includes at least every committed record."""
    flow.set_seed(seed)
    s = flow.Scheduler(virtual=True)
    flow.set_scheduler(s)
    try:
        net = SimNetwork(s, flow.g_random)
        disk = net.disk("m")
        rng = flow.g_random
        pushed = []
        committed_count = [0]
        popped = [-1]

        async def phase():
            dq = DiskQueue(disk, "q", file_size_limit=512)
            await dq.recover()
            # lost unsynced pushes: their seqs will be reused — forget them
            del pushed[dq.next_seq:]
            committed_count[0] = min(committed_count[0], len(pushed))
            for _ in range(rng.random_int(5, 40)):
                r = rng.random01()
                if r < 0.55:
                    payload = bytes([rng.random_int(65, 90)]) * rng.random_int(1, 40)
                    await dq.push(payload)
                    pushed.append(payload)
                elif r < 0.8:
                    await dq.commit()
                    committed_count[0] = len(pushed)
                elif dq.records:
                    k = rng.random_int(0, len(dq.records))
                    seq = dq.records[k][0]
                    dq.pop(seq)
                    popped[0] = max(popped[0], seq)
            return True

        for _round in range(4):
            t = s.spawn(phase())
            assert s.run(until=t, timeout_time=600)
            disk.power_loss(flow.g_random)  # crash between phases

        async def final_check():
            dq = DiskQueue(disk, "q", file_size_limit=512)
            await dq.recover()
            recs = dq.records
            # every surviving record matches what was pushed at that seq,
            # and seqs are contiguous
            for j, (seq, payload) in enumerate(recs):
                assert seq == recs[0][0] + j, "seq gap in recovery"
                assert payload == pushed[seq], f"payload mismatch at {seq}"
            # every committed, unpopped record survived
            assert dq.next_seq >= committed_count[0], (
                f"lost committed records: next_seq {dq.next_seq}, "
                f"committed {committed_count[0]}")
            if recs:
                assert recs[0][0] <= max(popped[0] + 1, 0)
            return True

        t = s.spawn(final_check())
        assert s.run(until=t, timeout_time=600)
    finally:
        flow.set_scheduler(None)


def test_kvstore_recover_and_snapshot(sim):
    s, net = sim
    disk = net.disk("m1")

    async def main():
        kv = KeyValueStoreMemory(disk, "sq", snapshot_threshold=512)
        await kv.recover()
        for i in range(50):
            kv.set(b"k%03d" % i, b"v%03d" % i)
            await kv.commit()  # many commits -> snapshot threshold crossed
        kv.clear_range(b"k010", b"k020")
        await kv.commit()
        return True

    assert drive(s, main())
    disk.power_loss(flow.g_random)

    async def check():
        kv = KeyValueStoreMemory(disk, "sq")
        await kv.recover()
        assert kv.get(b"k005") == b"v005"
        assert kv.get(b"k015") is None  # cleared
        rng = kv.get_range(b"k", b"l")
        assert len(rng) == 40
        assert kv.get_range(b"k000", b"k003", reverse=True) == [
            (b"k002", b"v002"), (b"k001", b"v001"), (b"k000", b"v000")]
        return True

    assert drive(s, check())
