"""The reference's replication cases (tests/test_replication.py) on the
port's SimCluster. Storage replication: same-tag replica teams, replica-read failover,
and per-replica log pops (ref: §2.6 item 6 replica read parallelism /
fdbrpc/LoadBalance.actor.h; teams in DataDistribution.actor.cpp:539)."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402


def test_replicas_serve_identical_data_and_failover():
    """Reads keep working when one replica of a shard dies — WITHOUT an
    epoch recovery (replica failover, not healing)."""
    c = SimCluster(seed=1301, durable=True, storage_replicas=2,
                   auto_reboot=False)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                for i in range(60):
                    tr.set(b"rep%02d" % i, b"v%d" % i)
            await run_transaction(db, body)
            # both replicas converge to the same data
            shard = c.cc.dbinfo.get().storages[0]
            objs = [c.cc._storage_objs[r.name] for r in shard.replicas]
            await flow.delay(0.5)
            views = []
            for o in objs:
                v = o.version.get()
                views.append(o.data.get_range(b"", b"\xff", v, 1000))
            assert views[0] == views[1] and len(views[0]) == 60
            epoch_before = c.cc.dbinfo.get().epoch

            # kill ONE replica: reads fail over to the survivor
            c.net.kill(objs[0].process)
            for i in range(60):
                async def rbody(tr, i=i):
                    assert await tr.get(b"rep%02d" % i) == b"v%d" % i
                await run_transaction(db, rbody, max_retries=200)
            # storage death is not a transaction-subsystem failure
            assert c.cc.dbinfo.get().epoch == epoch_before
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_lagging_replica_is_not_starved_by_pops():
    """The TLog frees a tag's records only once EVERY replica has
    popped past them: clog one replica's machine and verify it still
    catches up afterwards (per-replica pop bookkeeping)."""
    c = SimCluster(seed=1303, durable=True, storage_replicas=2)
    try:
        db = c.client()

        async def main():
            await db.info()   # wait for recruitment
            shard = c.cc.dbinfo.get().storages[0]
            objs = [c.cc._storage_objs[r.name] for r in shard.replicas]
            lag_machine = objs[1].process.machine
            # clog the laggard's links to everything for a while
            for i in range(c.n_workers):
                c.net.clog_pair(lag_machine, f"w{i}", 3.0)
            c.net.clog_pair(lag_machine, "cc", 3.0)

            async def body(tr):
                for i in range(40):
                    tr.set(b"lag%02d" % i, b"v%d" % i)
            await run_transaction(db, body)
            # wait long enough for durability + pops on the fast replica
            await flow.delay(5.0)
            # the laggard catches up: its view converges
            for _ in range(60):
                v = objs[1].version.get()
                rows = objs[1].data.get_range(b"lag", b"lah", v, 100)
                if len(rows) == 40:
                    break
                await flow.delay(0.5)
            assert len(rows) == 40, len(rows)
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_replicated_cluster_survives_attrition():
    c = SimCluster(seed=1307, durable=True, storage_replicas=2,
                   n_logs=2, n_workers=6, buggify=True)
    try:
        db = c.client()

        async def main():
            acked = {}
            for i in range(10):
                async def body(tr, i=i):
                    tr.set(b"a%02d" % i, b"v%d" % i)
                await run_transaction(db, body, max_retries=300)
                acked[b"a%02d" % i] = b"v%d" % i
                if i == 3:
                    c.kill_role("storage")
                if i == 6:
                    c.kill_role("tlog")

            async def check(tr):
                got = dict(await tr.get_range(b"a", b"b"))
                assert got == acked, (len(got), len(acked))
            await run_transaction(db, check, max_retries=300)
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()


def test_backup_requests_mask_a_slow_replica():
    """Load balance (ref: fdbrpc/LoadBalance.actor.h): when the chosen
    replica is slow (clogged links), a duplicate request to the other
    replica answers within the backup window — far sooner than the 5s
    request timeout — and the latency model steers later reads away
    from the slow replica."""
    c = SimCluster(seed=1304, storage_replicas=2)
    try:
        db = c.client()

        async def main():
            async def seed(tr):
                for i in range(10):
                    tr.set(b"bk%02d" % i, b"v%d" % i)
            await run_transaction(db, seed)

            shard = (await db.info()).storages[0]
            objs = [c.cc._storage_objs[r.name] for r in shard.replicas]
            slow = objs[0]
            slow_machine = slow.process.machine
            client_machine = db.process.machine
            # only the CLIENT'S link to the slow replica clogs: pulls
            # and peer traffic stay healthy, so this is purely a read-
            # latency event, not a failure
            c.net.clog_pair(client_machine, slow_machine, 30.0)

            t0 = flow.now()
            async def read_all(tr):
                for i in range(10):
                    assert await tr.get(b"bk%02d" % i) == b"v%d" % i
            await run_transaction(db, read_all)
            elapsed = flow.now() - t0
            # without backup requests the first read against the slow
            # replica eats the full 5s REQUEST_TIMEOUT
            assert elapsed < 4.0, elapsed

            # the model now prefers the healthy replica outright: the
            # abandoned slow request recorded a penalty sample, so both
            # replicas are modeled and the healthy one sorts first
            ema = db._latency_ema
            healthy = shard.replicas[1].name
            slow_name = shard.replicas[0].name
            assert healthy in ema and slow_name in ema, ema
            assert ema[healthy] < ema[slow_name], ema
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()
