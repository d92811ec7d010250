"""The reference's cases of tests/test_region.py on the port's SimCluster.

Multi-region: LogRouter-style async replication + failover THROUGH
the recovery machinery.

Ref: fdbserver/LogRouter.actor.cpp, TagPartitionedLogSystem remote log
sets (epochEnd recovering from them, :1265), SimulatedCluster
.actor.cpp:790 (region configs), fdbcli force_recovery_with_data_loss.

The contract under test is the fearless-async guarantee plus these
requirements: after a full primary blackout, promotion is a
COORDINATED-STATE RECOVERY (new CC elected over the surviving
coordinator quorum, remote log locked, roles recruited), the promoted
region is sharded like the primary (>= 2 storage shards), every write
the router shipped survives, and a concurrent client rides the
transition on its ordinary retry loop by re-finding the controller
through the coordinators.
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server.dbinfo import FULLY_RECOVERED  # noqa: E402
from foundationdb_tpu_torch.server.region import RemoteRegion  # noqa: E402


def _blackout_primary(c, keep_coordinators=()):
    """Kill every region-A process: workers, CC, and the primary-side
    coordinators (the survivors model the reference's fearless layouts
    placing a coordinator majority outside the primary DC)."""
    for w in list(c.workers.values()):
        if w.process.alive:
            c.net.kill(w.process)
    c.net.kill(c.cc.process)
    for i, coord in enumerate(c.coordinators):
        if i not in keep_coordinators and coord.process.alive:
            c.net.kill(coord.process)


def test_region_failover_through_recovery():
    c = SimCluster(seed=801, durable=True, auto_reboot=False,
                   n_coordinators=5, n_storage=2)
    try:
        db = c.client()

        async def main():
            region = RemoteRegion(c)
            await region.start()
            # attach was a recovery: the epoch moved and the region's
            # log store is in the coordinated state
            cstate = await c.cc._cstate.read()
            assert cstate.region_logs == region.log_stores()

            committed = {}   # key -> commit version
            for i in range(40):
                # alternate halves of the keyspace so the stream feeds
                # BOTH remote shards (split at 0x80)
                key = (b"k%03d" if i % 2 else b"\xc8%03d") % i
                tr = db.create_transaction()
                tr.set(key, b"v%d" % i)
                v = await tr.commit()
                committed[key] = v
                if i % 5 == 0:
                    await flow.delay(0.05)
            assert region.lag() >= 0

            # a concurrent client that never stops: its writes ride
            # the ordinary retry loop across the blackout
            progress = {"before": 0, "after": 0}
            phase = ["before"]
            stop = [False]

            async def writer():
                n = 0
                while not stop[0]:
                    async def body(tr, n=n):
                        tr.set(b"live-%04d" % n, b"x")
                    await run_transaction(db, body, max_retries=100000)
                    progress[phase[0]] += 1
                    n += 1
                    await flow.delay(0.1)

            writer_task = flow.spawn(writer(), name="concurrentWriter")

            # let the router ship at least the first 30 writes, then
            # cut region A off mid-stream
            target = committed[b"k%03d" % 29]
            deadline = flow.now() + 60
            while region._pushed_to < target:
                assert flow.now() < deadline, "router never caught up"
                tr = db.create_transaction()   # nudges known_committed
                tr.set(b"nudge", b"x")
                await tr.commit()
                await flow.delay(0.05)

            old_epoch = c.cc.dbinfo.get().epoch
            _blackout_primary(c, keep_coordinators=(2, 3, 4))
            phase[0] = "after"
            writes_at_blackout = progress["before"]

            promoted = await region.promote()
            rv = promoted.recovery_version

            # promotion WAS a recovery: a fresh epoch above the
            # primary's, fully recovered, committed into the same
            # coordinated state
            info = promoted.cc.dbinfo.get()
            assert info.epoch > old_epoch
            assert info.recovery_state == FULLY_RECOVERED
            cstate2 = await promoted.cc._cstate.read()
            assert cstate2.epoch == info.epoch
            # ...and the promoted region is SHARDED like the primary
            assert len(info.storages) >= 2
            assert len({s.tag for s in info.storages}) == len(info.storages)

            # the guarantee: every write at or below the remote
            # frontier survived the blackout
            pdb = promoted.client()

            async def read_all(tr):
                lo = await tr.get_range(b"k", b"l")
                hi = await tr.get_range(b"\xc8", b"\xc9")
                return list(lo) + list(hi)
            rows = dict(await run_transaction(pdb, read_all,
                                              max_retries=500))
            for key, v in committed.items():
                if v <= rv:
                    assert rows.get(key) == b"v%d" % int(key[1:]), \
                        (key, v, rv)
            for i in range(30):
                key = (b"k%03d" if i % 2 else b"\xc8%03d") % i
                assert key in rows

            # the data really is spread across BOTH remote shards
            per_shard = []
            for s in region.storage_objs():
                lo, hi = s.shard_begin, s.shard_end or b"\xff"
                per_shard.append(sum(1 for k in rows
                                     if lo <= k < hi))
            assert all(n > 0 for n in per_shard), per_shard

            # the concurrent client survived the transition: its loop
            # keeps committing against the promoted cluster with no
            # new handle — it re-found the CC through the coordinators
            deadline = flow.now() + 120
            while progress["after"] < 3:
                assert flow.now() < deadline, \
                    "writer never recovered after failover"
                await flow.delay(0.5)
            stop[0] = True
            await flow.catch_errors(writer_task)
            assert progress["after"] >= 3
            # at least one of its post-blackout writes is readable
            async def read_live(tr):
                return await tr.get_range(b"live-", b"live.\xff")
            live = dict(await run_transaction(pdb, read_live,
                                              max_retries=500))
            assert len(live) >= progress["after"] - 1
            _ = writes_at_blackout  # (diagnostic)

            # the promoted region is a live transaction system with
            # real conflict detection: two writers of one key from the
            # same snapshot — the second aborts
            tr1 = pdb.create_transaction()
            tr2 = pdb.create_transaction()
            assert (await tr1.get(b"occ")) is None
            assert (await tr2.get(b"occ")) is None
            tr1.set(b"occ", b"a")
            tr2.set(b"occ", b"b")
            await tr1.commit()
            with pytest.raises(flow.FdbError) as ei:
                await tr2.commit()
            assert ei.value.name == "not_committed"
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()


def test_router_survives_primary_recovery():
    """The log stream crosses primary epoch changes: a tlog kill and
    recovery mid-replication must not leave a hole in the remote copy
    (ref: the log router draining old generations before the current
    one)."""
    c = SimCluster(seed=803, durable=True)
    try:
        db = c.client()

        async def main():
            region = RemoteRegion(c)
            await region.start()

            for i in range(15):
                async def body(tr, i=i):
                    tr.set(b"r%03d" % i, b"w%d" % i)
                await run_transaction(db, body, max_retries=500)
            c.kill_role("tlog")
            last_v = 0
            for i in range(15, 30):
                async def body(tr, i=i):
                    tr.set(b"r%03d" % i, b"w%d" % i)
                await run_transaction(db, body, max_retries=500)
            tr = db.create_transaction()
            tr.set(b"final", b"1")
            last_v = await tr.commit()

            # ship everything, then compare the remote copy
            deadline = flow.now() + 120
            while region._pushed_to < last_v or \
                    region.applied_version() < last_v:
                assert flow.now() < deadline, (
                    region._pushed_to, region.applied_version(), last_v)
                tr = db.create_transaction()
                tr.set(b"nudge", b"x")
                await tr.commit()
                await flow.delay(0.05)

            rows = {}
            from foundationdb_tpu_torch.server.types import \
                StorageGetRangeRequest
            for s in region.storage_objs():
                part = await s.ranges.ref().get_reply(
                    StorageGetRangeRequest(b"r", b"s",
                                           s.version.get(), 1 << 20),
                    db.process)
                rows.update(dict(part))
            for i in range(30):
                assert rows.get(b"r%03d" % i) == b"w%d" % i, i
            await region.stop()
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()


def test_satellite_failover_loses_nothing():
    """Satellite log replicas (ref: satelliteTagLocations,
    TagPartitionedLogSystem.actor.cpp:156-220): with satellites, a
    primary blackout loses NO acked commit even when the region router
    has shipped nothing — promotion locks the surviving satellite
    replicas, which hold the complete acked stream, and recovers at
    their frontier (the fearless guarantee, not just the async one)."""
    c = SimCluster(seed=811, durable=True, auto_reboot=False,
                   n_coordinators=5, n_storage=2)
    try:
        db = c.client()

        async def main():
            region = RemoteRegion(c, n_satellites=2)
            await region.start()
            # attach recruited satellite replicas into the log set
            info = c.cc.dbinfo.get()
            sat_stores = [s for s, _m in (info.logs.stores or ())
                          if "-sat" in s]
            assert len(sat_stores) == 2, info.logs.stores

            # model maximum router lag: the remote DC receives nothing
            region._router_task.cancel()

            committed = {}
            for i in range(24):
                key = (b"k%03d" if i % 2 else b"\xc8%03d") % i
                tr = db.create_transaction()
                tr.set(key, b"v%d" % i)
                committed[key] = await tr.commit()
            assert region._pushed_to < max(committed.values())

            old_epoch = c.cc.dbinfo.get().epoch
            _blackout_primary(c, keep_coordinators=(2, 3, 4))

            promoted = await region.promote()
            # zero loss: the recovery frontier covers EVERY acked commit
            assert promoted.recovery_version >= max(committed.values()), (
                promoted.recovery_version, max(committed.values()))
            info2 = promoted.cc.dbinfo.get()
            assert info2.epoch > old_epoch

            pdb = promoted.client()

            async def read_all(tr):
                rows = dict(await tr.get_range(b"", b"\xff"))
                for k in committed:
                    assert rows.get(k) is not None, (k, len(rows))
            await run_transaction(pdb, read_all, max_retries=500)
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()


def test_satellite_death_recovers_and_commits_resume():
    """A satellite replica is a critical process: its death ends the
    epoch; the next recovery recruits replicas on the surviving
    satellite workers and commits resume (ref: recruitment degrading
    across satellite failures rather than wedging the push)."""
    c = SimCluster(seed=813, durable=True, n_coordinators=3)
    try:
        db = c.client()

        async def main():
            region = RemoteRegion(c, n_satellites=2)
            await region.start()
            epoch0 = c.cc.dbinfo.get().epoch

            async def w(tr):
                tr.set(b"a", b"1")
            await run_transaction(db, w)

            # kill one satellite worker outright
            c.net.kill(region.satellite_workers[0].process)

            # commits keep working across the triggered recovery
            for i in range(5):
                async def body(tr, i=i):
                    tr.set(b"k%d" % i, b"v%d" % i)
                await run_transaction(db, body, max_retries=1000)

            deadline = flow.now() + 60
            while c.cc.dbinfo.get().epoch == epoch0:
                assert flow.now() < deadline, "no recovery after sat death"
                await flow.delay(0.2)
            info = c.cc.dbinfo.get()
            sat_stores = [s for s, _m in (info.logs.stores or ())
                          if "-sat" in s]
            # the dead satellite is gone from the set; the survivor
            # carries the replica
            assert len(sat_stores) == 1, info.logs.stores

            tr = db.create_transaction()
            assert await tr.get(b"k4") == b"v4"
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()
