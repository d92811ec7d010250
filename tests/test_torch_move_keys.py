"""The reference's cases of tests/test_move_keys.py on the port's
SimCluster.

Shard movement: boundary shifts via dual-tagging + AddingShard
backfill + durable ownership flip (ref: MoveKeys.actor.cpp,
storageserver fetchKeys :1862 / AddingShard :149,
DataDistributionTracker split decisions)."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402


def _shard_objs(c):
    info = c.cc.dbinfo.get()
    return [c.cc._storage_objs[s.replicas[0].name] for s in info.storages]


def test_dd_moves_boundary_to_balance_load():
    """All data lands in shard 0's half; DD shifts the boundary so
    shard 1 takes part of it; reads/writes stay correct throughout."""
    c = SimCluster(seed=1101, durable=True, n_storage=2)
    try:
        db = c.client()

        async def main():
            # everything below 0x80: shard 0 holds 100%, shard 1 empty
            async def seed_data(tr):
                for i in range(400):
                    tr.set(b"\x10k%04d" % i, b"v%d" % i)
            await run_transaction(db, seed_data)

            # let the DD loop notice and move
            moved = False
            for _ in range(100):
                await flow.delay(0.5)
                info = c.cc.dbinfo.get()
                if info.storages[1].begin < b"\x80":
                    moved = True
                    break
            assert moved, "data distribution never moved the boundary"

            # both shards now hold part of the data; reads see all of it
            async def check(tr):
                got = await tr.get_range(b"", b"\xff")
                assert len(got) == 400
                assert got[0][0] == b"\x10k0000"
                assert got[-1][0] == b"\x10k0399"
            await run_transaction(db, check, max_retries=200)
            objs = _shard_objs(c)
            a = objs[0].approx_rows()
            b_ = objs[1].approx_rows()
            assert a > 0 and b_ > 0, (a, b_)

            # writes keep flowing to the right owners afterwards
            async def more(tr):
                for i in range(400, 450):
                    tr.set(b"\x10k%04d" % i, b"v%d" % i)
            await run_transaction(db, more, max_retries=200)

            async def check2(tr):
                got = await tr.get_range(b"\x10k0390", b"\x10k0450")
                assert len(got) == 60
            await run_transaction(db, check2, max_retries=200)
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()


def test_moved_data_survives_dst_crash_after_move():
    """The ownership flip is durable on the destination BEFORE the
    source shrinks — killing the destination after a move must bring
    back the moved rows from ITS disk."""
    c = SimCluster(seed=1103, durable=True, n_storage=2)
    try:
        db = c.client()

        async def main():
            async def seed_data(tr):
                for i in range(400):
                    tr.set(b"\x10k%04d" % i, b"v%d" % i)
            await run_transaction(db, seed_data)
            for _ in range(100):
                await flow.delay(0.5)
                if c.cc.dbinfo.get().storages[1].begin < b"\x80":
                    break
            else:
                raise AssertionError("no move happened")
            # give durability a beat, then crash the destination
            await flow.delay(1.0)
            c.kill_role("storage")

            async def check(tr):
                got = await tr.get_range(b"", b"\xff")
                assert len(got) == 400, len(got)
            await run_transaction(db, check, max_retries=300)
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()


def test_writes_during_move_are_not_lost():
    """A client keeps writing into the moving range while the move is
    in flight; every acknowledged write is readable afterwards."""
    c = SimCluster(seed=1107, durable=True, n_storage=2)
    try:
        db = c.client()
        writer_db = c.client("writer")

        async def main():
            async def seed_data(tr):
                for i in range(300):
                    tr.set(b"\x10k%04d" % i, b"v%d" % i)
            await run_transaction(db, seed_data)

            stop = [False]
            written = []

            async def writer():
                i = 1000
                while not stop[0]:
                    async def body(tr, i=i):
                        tr.set(b"\x10w%04d" % i, b"x")
                    await run_transaction(writer_db, body, max_retries=300)
                    written.append(i)
                    i += 1
                    await flow.delay(0.05)

            wtask = flow.spawn(writer())
            for _ in range(100):
                await flow.delay(0.5)
                if c.cc.dbinfo.get().storages[1].begin < b"\x80":
                    break
            else:
                raise AssertionError("no move happened")
            await flow.delay(1.0)
            stop[0] = True
            await wtask

            async def check(tr):
                got = await tr.get_range(b"\x10w", b"\x10x")
                assert len(got) == len(written), (len(got), len(written))
            await run_transaction(db, check, max_retries=200)
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()


def _worker_hosting(c, role_name):
    for name, wi in c.cc.workers.items():
        if role_name in wi.worker.roles:
            return name
    return None


def test_exclusion_vacates_storage_replica():
    """Excluding a worker that hosts a storage replica makes DD
    re-home the replica on an included worker — whole-shard fetchKeys:
    snapshot + buffered log replay, pinned TLog records, published team
    swap, old role retired — with data intact and writes continuing
    (ref: exclude + DataDistribution re-replication, MoveKeys)."""
    c = SimCluster(seed=1301, durable=True, n_storage=2, n_workers=6)
    try:
        db = c.client()

        async def main():
            async def seed(tr):
                for i in range(120):
                    tr.set(b"k%04d" % i, b"v%d" % i)
                tr.set(b"\xf0far", b"high")
            await run_transaction(db, seed)

            info = c.cc.dbinfo.get()
            victim_role = info.storages[0].replicas[0].name
            victim_worker = _worker_hosting(c, victim_role)
            assert victim_worker is not None
            await db.exclude(victim_worker)

            # DD must vacate EVERY shard replica off the worker (one
            # re-home per DD tick)
            for _ in range(120):
                await flow.delay(0.5)
                info = c.cc.dbinfo.get()
                hosts = {_worker_hosting(c, r.name)
                         for s in info.storages for r in s.replicas}
                if victim_worker not in hosts and None not in hosts:
                    break
            else:
                raise AssertionError("exclusion never vacated the replica")
            assert victim_role not in c.cc.workers[
                victim_worker].worker.roles, "old role not retired"

            # every row survived the re-home, and writes still flow
            async def check(tr):
                rows = await tr.get_range(b"k", b"l")
                assert len(rows) == 120, len(rows)
                assert await tr.get(b"k0042") == b"v42"
                assert await tr.get(b"\xf0far") == b"high"
                tr.set(b"k9999", b"after-vacate")
            await run_transaction(db, check)

            # the excluded worker can now die with zero data impact
            c.kill_worker(victim_worker)
            await flow.delay(1.0)

            async def check2(tr):
                assert await tr.get(b"k9999") == b"after-vacate"
                assert await tr.get(b"k0000") == b"v0"
            await run_transaction(db, check2)
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_exclusion_vacates_one_of_replicated_team():
    """With storage_replicas=2, excluding one team member re-homes only
    that replica; the surviving teammate serves as the fetch source."""
    c = SimCluster(seed=1302, durable=True, n_storage=1,
                   storage_replicas=2, n_workers=6)
    try:
        db = c.client()

        async def main():
            async def seed(tr):
                for i in range(60):
                    tr.set(b"r%03d" % i, b"w%d" % i)
            await run_transaction(db, seed)

            info = c.cc.dbinfo.get()
            victim_role = info.storages[0].replicas[0].name
            keep_role = info.storages[0].replicas[1].name
            victim_worker = _worker_hosting(c, victim_role)
            await db.exclude(victim_worker)

            for _ in range(120):
                await flow.delay(0.5)
                info = c.cc.dbinfo.get()
                names = [r.name for r in info.storages[0].replicas]
                if victim_role not in names:
                    break
            else:
                raise AssertionError("replica never vacated")
            names = [r.name for r in info.storages[0].replicas]
            assert keep_role in names  # the teammate was untouched

            async def check(tr):
                rows = await tr.get_range(b"r", b"s")
                assert len(rows) == 60
            await run_transaction(db, check)
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_dd_splits_hot_shard_with_fresh_tag():
    """A shard over the split threshold gets divided: DD mints a fresh
    tag, recruits a new team, dual-tags the transition, and publishes
    an extra shard — with reads/writes correct throughout and the new
    tag live in the proxies' routing (ref: dataDistributionTracker
    shardSplitter + moveKeys to a new team)."""
    from foundationdb_tpu_torch.flow import SERVER_KNOBS

    c = SimCluster(seed=1401, durable=True, n_storage=1, n_workers=5)
    try:
        db = c.client()
        SERVER_KNOBS.init("DD_SHARD_SPLIT_BYTES", 1200)

        async def main():
            async def seed(tr):
                for i in range(300):
                    tr.set(b"s%04d" % i, b"v%d" % i)
            await run_transaction(db, seed)

            for _ in range(120):
                await flow.delay(0.5)
                info = c.cc.dbinfo.get()
                if len(info.storages) >= 2:
                    break
            else:
                raise AssertionError("hot shard never split")
            info = c.cc.dbinfo.get()
            tags = [s.tag for s in info.storages]
            assert len(set(tags)) == len(tags)
            assert max(tags) >= 1          # a fresh tag was minted
            assert info.storages[0].end == info.storages[1].begin

            # all rows survive, routed across the split
            async def check(tr):
                rows = await tr.get_range(b"s", b"t")
                assert len(rows) == 300, len(rows)
                # a write on each side of the new boundary
                tr.set(b"s0000x", b"left")
                tr.set(b"s0299x", b"right")
            await run_transaction(db, check)

            async def check2(tr):
                assert await tr.get(b"s0000x") == b"left"
                assert await tr.get(b"s0299x") == b"right"
            await run_transaction(db, check2)
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_dd_merges_cold_split_back():
    """After the data that forced a split is cleared, DD merges the
    extra shard away (never below the configured count), retiring the
    right team and its tag (ref: shardMerger)."""
    from foundationdb_tpu_torch.flow import SERVER_KNOBS

    c = SimCluster(seed=1402, durable=True, n_storage=1, n_workers=5)
    try:
        db = c.client()
        SERVER_KNOBS.init("DD_SHARD_SPLIT_BYTES", 1200)

        async def main():
            async def seed(tr):
                for i in range(300):
                    tr.set(b"m%04d" % i, b"v%d" % i)
            await run_transaction(db, seed)
            for _ in range(120):
                await flow.delay(0.5)
                if len(c.cc.dbinfo.get().storages) >= 2:
                    break
            else:
                raise AssertionError("never split")
            right_names = [r.name
                           for r in c.cc.dbinfo.get().storages[1].replicas]

            # empty the keyspace: both shards go cold -> merge
            async def wipe(tr):
                tr.clear_range(b"", b"\xff")
                tr.set(b"survivor", b"1")
            await run_transaction(db, wipe)
            for _ in range(120):
                await flow.delay(0.5)
                if len(c.cc.dbinfo.get().storages) == 1:
                    break
            else:
                raise AssertionError("cold shards never merged")

            # the right team retired: roles gone from every worker
            for name in right_names:
                assert all(name not in wi.worker.roles
                           for wi in c.cc.workers.values()), name

            async def check(tr):
                assert await tr.get(b"survivor") == b"1"
                # no resurrection: the left team's kv held the m-rows
                # from before the split; the merge install must not let
                # them shine through under the (cleared) snapshot
                assert await tr.get_range(b"m", b"n") == []
                tr.set(b"post-merge", b"2")
            await run_transaction(db, check)
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()
