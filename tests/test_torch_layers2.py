"""The reference's cases of tests/test_layers2.py on the port's
directory, task bucket and metrics layers.

Directory layer, TaskBucket, MetricLogger, QuietDatabase
(ref: bindings/python/fdb/directory_impl.py, fdbclient/TaskBucket
.actor.cpp, fdbclient/MetricLogger.actor.cpp,
fdbserver/QuietDatabase.actor.cpp)."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow
from foundationdb_tpu_torch.client import run_transaction
from foundationdb_tpu_torch.layers import metrics as metrics_layer
from foundationdb_tpu_torch.layers.directory import DirectoryLayer
from foundationdb_tpu_torch.layers.subspace import Subspace
from foundationdb_tpu_torch.layers.taskbucket import TaskBucket
from foundationdb_tpu_torch.server import SimCluster


def test_directory_layer():
    c = SimCluster(seed=1401)
    try:
        db = c.client()
        dl = DirectoryLayer()

        async def main():
            async def mk(tr):
                users = await dl.create_or_open(tr, ("app", "users"))
                logs = await dl.create_or_open(tr, ("app", "logs"))
                tr.set(users.pack((1,)), b"alice")
                tr.set(logs.pack((1,)), b"started")
                return users.subspace.key, logs.subspace.key
            up, lp = await run_transaction(db, mk)
            assert up != lp and not up.startswith(lp)

            async def reopen(tr):
                users = await dl.open(tr, ("app", "users"))
                assert users.subspace.key == up   # stable prefix
                assert await tr.get(users.pack((1,))) == b"alice"
                assert await dl.list(tr, ("app",)) == ["logs", "users"]
                with pytest.raises(flow.FdbError):
                    await dl.open(tr, ("app", "missing"))
            await run_transaction(db, reopen)

            async def mv(tr):
                moved = await dl.move(tr, ("app", "users"),
                                      ("app", "members"))
                assert moved.subspace.key == up  # data untouched
            await run_transaction(db, mv)

            async def after_move(tr):
                members = await dl.open(tr, ("app", "members"))
                assert await tr.get(members.pack((1,))) == b"alice"
                assert await dl.list(tr, ("app",)) == ["logs", "members"]
            await run_transaction(db, after_move)

            async def rm(tr):
                await dl.remove(tr, ("app", "members"))
            await run_transaction(db, rm)

            async def gone(tr):
                assert not await dl.exists(tr, ("app", "members"))
                assert await tr.get(up + b"\x15\x01") is None
            await run_transaction(db, gone)
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()


def test_taskbucket_claim_lease_finish():
    c = SimCluster(seed=1403)
    try:
        db = c.client()
        tb = TaskBucket(Subspace(("tasks",)), lease=1.0)

        async def main():
            async def add(tr):
                await tb.add(tr, {b"op": b"backup", b"n": b"1"})
                await tb.add(tr, {b"op": b"restore", b"n": b"2"})
            await run_transaction(db, add)

            async def claim(tr):
                return await tb.claim_one(tr)
            t1 = await run_transaction(db, claim)
            t2 = await run_transaction(db, claim)
            assert {t1.params[b"op"], t2.params[b"op"]} == \
                {b"backup", b"restore"}
            assert await run_transaction(db, claim) is None  # all claimed

            # finish one; let the other's lease expire and reclaim it
            async def fin(tr, t=t1):
                await tb.finish(tr, t)
            await run_transaction(db, fin)
            await flow.delay(1.5)
            t3 = await run_transaction(db, claim)
            assert t3 is not None and t3.params == t2.params

            async def fin2(tr, t=t3):
                await tb.finish(tr, t)
            await run_transaction(db, fin2)

            async def empty(tr):
                assert await tb.is_empty(tr)
            await run_transaction(db, empty)
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()


def test_metric_logger_persists_counters():
    c = SimCluster(seed=1405)
    try:
        db = c.client()

        async def main():
            for i in range(4):
                async def body(tr, i=i):
                    tr.set(b"m%d" % i, b"v")
                await run_transaction(db, body)
            # persist the proxies' counters into the DB itself
            proxies = c.cc._current_proxies()
            n = await metrics_layer.log_counters(
                db, [p.stats for p in proxies])
            assert n >= 2
            series = await metrics_layer.read_series(
                db, "proxy", "transactions_committed")
            assert series and series[-1][1] >= 4
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()


def test_quiet_database_settles():
    c = SimCluster(seed=1407, durable=True, n_storage=2)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                for i in range(50):
                    tr.set(b"q%02d" % i, b"v")
            await run_transaction(db, body)
            await c.quiet_database()
            logs = c.cc.tlog_objs()
            assert all(len(t.entries) == 0 for t in logs)
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()
