"""The reference's chaos cases that need no cluster
(tests/test_chaos_storms.py: the torn write at power loss, a send clog
on an in-flight reply, swizzled one-way datagrams) on the port's
`rpc` and `server.diskqueue`, and the port's chaos stations and
format-aware corruption helpers (`server.chaos`), which run without a
cluster: a station fires once, in order, and a corrupted DiskQueue
record is caught at recovery (payload flip) or passes its CRC (value
flip with the CRC recomputed). The scenario storms run on a
`SimCluster`, which comes with the port's cluster."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.rpc import SimNetwork  # noqa: E402
from foundationdb_tpu_torch.server.chaos import (  # noqa: E402
    COMMIT_STATIONS,
    arm_station,
    clear_stations,
    corrupt_record_payload,
    corrupt_value_bytes,
    fire_station,
)


def test_torn_write_recovers_through_crc_cut():
    """With SIM_TORN_WRITE_PROB=1 the write in flight at power loss is
    TORN — only a prefix of it lands. Recovery's checksum scan cuts the
    torn tail (tail damage, NOT mid-log corruption: no checksum_failed,
    no store drop) and every synced record survives."""
    from foundationdb_tpu_torch.flow import coverage
    from foundationdb_tpu_torch.server.diskqueue import DiskQueue
    flow.set_seed(9)
    s = flow.Scheduler(virtual=True)
    flow.set_scheduler(s)
    saved = {n: getattr(flow.SERVER_KNOBS, n) for n in
             ("sim_torn_write_prob", "sim_power_loss_drop_prob")}
    flow.SERVER_KNOBS.set("sim_torn_write_prob", 1.0)
    flow.SERVER_KNOBS.set("sim_power_loss_drop_prob", 0.0)
    try:
        net = SimNetwork(s, flow.g_random)
        disk = net.disk("m")
        before_torn = coverage.hits("disk.torn_write")

        async def main():
            dq = DiskQueue(disk, "torn")
            await dq.recover()
            synced = [b"rec%02d" % i * 8 for i in range(5)]
            for payload in synced:
                await dq.push(payload)
            await dq.commit()
            await dq.push(b"UNSYNCED-IN-FLIGHT" * 16)
            disk.power_loss(flow.g_random)
            assert coverage.hits("disk.torn_write") > before_torn
            assert net.chaos_counters.get("torn_write") == 1
            dq2 = DiskQueue(disk, "torn")
            recovered = await dq2.recover()
            # the torn record is gone, every synced one survives, and
            # nothing was (mis)classified as mid-log corruption
            assert recovered == synced, recovered
            return True

        task = s.spawn(main())
        assert s.run(until=task, timeout_time=60)
    finally:
        for n, v in saved.items():
            flow.SERVER_KNOBS.set(n, v)
        flow.set_scheduler(None)


def _raw_net():
    s = flow.Scheduler(virtual=True)
    flow.set_scheduler(s)
    return s, SimNetwork(s, flow.g_random)


def test_clog_send_delays_inflight_reply():
    """A send clog installed AFTER the request went out still delays
    the answer: reply latency is drawn at reply time."""
    from foundationdb_tpu_torch.rpc import RequestStream
    from foundationdb_tpu_torch.server.types import MutationRef, SET_VALUE
    flow.set_seed(7)
    s, net = _raw_net()
    try:
        server = net.new_process("server", machine="ms")
        client = net.new_process("client", machine="mc")
        stream = RequestStream(server)

        async def serve():
            req, reply = await stream.pop()
            # the request is already here; clog the RESPONDER's sends
            # before answering — the in-flight reply must honor it
            net.clog_send("ms", 5.0)
            reply.send(req)

        async def main():
            t = flow.spawn(serve())
            t0 = s.now()
            await stream.ref().get_reply(
                MutationRef(SET_VALUE, b"k", b"v"), client)
            await t
            return s.now() - t0

        task = s.spawn(main())
        elapsed = s.run(until=task, timeout_time=60)
        assert elapsed >= 5.0, elapsed
        assert net.chaos_counters.get("clog_send") == 1
    finally:
        flow.set_scheduler(None)


def test_swizzle_duplicates_oneway_datagrams():
    """Inside a swizzle window one-way datagrams may deliver twice,
    each copy drawing its own scrambled latency."""
    from foundationdb_tpu_torch.rpc import RequestStream
    from foundationdb_tpu_torch.server.types import MutationRef, SET_VALUE
    flow.set_seed(8)
    s, net = _raw_net()
    flow.SERVER_KNOBS.set("chaos_swizzle_dup_prob", 1.0)
    try:
        server = net.new_process("server", machine="ms")
        client = net.new_process("client", machine="mc")
        stream = RequestStream(server)
        net.swizzle("mc", "ms", 30.0)

        async def main():
            stream.ref().send(MutationRef(SET_VALUE, b"k", b"v"), client)
            got = []
            for _ in range(2):
                req, _reply = await stream.pop()
                got.append(req)
            return got

        task = s.spawn(main())
        got = s.run(until=task, timeout_time=60)
        assert len(got) == 2 and got[0] == got[1]
        assert net.messages_duplicated == 1
        assert net.chaos_counters.get("swizzle") == 1
    finally:
        flow.SERVER_KNOBS.set("chaos_swizzle_dup_prob", 0.25)
        flow.set_scheduler(None)


def test_stations_fire_once_in_arming_order():
    """An armed station fires its callbacks one a pass, first armed
    first, and is free again once they are spent."""
    clear_stations()
    seen = []
    at = COMMIT_STATIONS[4]
    try:
        arm_station(at, lambda loc: seen.append(("a", loc)))
        arm_station(at, lambda loc: seen.append(("b", loc)))
        fire_station(COMMIT_STATIONS[0])
        assert seen == []
        for _ in range(3):
            fire_station(at)
        assert seen == [("a", at), ("b", at)]
    finally:
        clear_stations()


@pytest.mark.parametrize("undetected", [False, True])
def test_corruption_helpers_against_recovery(undetected):
    """A payload flip with the CRC chain intact fails recovery with
    checksum_failed; a flip whose CRC is recomputed recovers, with the
    marker's record changed and every other record intact."""
    from foundationdb_tpu_torch.server.diskqueue import DiskQueue
    flow.set_seed(13)
    s, net = _raw_net()
    try:
        disk = net.disk("m")
        records = [b"rec%02d-" % i + b"payload" * 4 for i in range(6)]
        records[3] = b"rec03-MARKER-" + b"payload" * 3

        async def main():
            dq = DiskQueue(disk, "rot")
            await dq.recover()
            for r in records:
                await dq.push(r)
            await dq.commit()
            f = disk.files["rot.dq0"]
            if undetected:
                assert corrupt_value_bytes(f, b"MARKER", flow.g_random)
            else:
                assert corrupt_record_payload(f, flow.g_random)
            dq2 = DiskQueue(disk, "rot")
            if not undetected:
                with pytest.raises(flow.FdbError) as ei:
                    await dq2.recover()
                assert ei.value.name == "checksum_failed"
                return True
            got = await dq2.recover()
            assert len(got) == len(records)
            diff = [i for i, (a, b) in enumerate(zip(got, records))
                    if a != b]
            assert diff == [3], diff
            return True

        task = s.spawn(main())
        assert s.run(until=task, timeout_time=60)
        kind = ("disk_corruption_undetected" if undetected
                else "disk_corruption")
        assert net.chaos_counters.get(kind) == 1
    finally:
        flow.set_scheduler(None)
