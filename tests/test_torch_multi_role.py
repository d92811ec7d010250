"""The reference's cases of tests/test_multi_role.py on the port's
SimCluster.

Multi-proxy, replicated-log, and sharded-storage cluster shapes.

Ref: §2.6 items 2 (data parallelism across proxies), 4 (tag-partitioned
log replication), 5 (storage shard parallelism);
MasterProxyServer.actor.cpp:1019 getLiveCommittedVersion (causal GRV),
TagPartitionedLogSystem.actor.cpp:404 (wait-all quorum push).
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server.types import KeySelector  # noqa: E402


def test_two_proxies_causal_reads():
    """A commit acked through one proxy is visible to a read whose GRV
    came from the other (getLiveCommittedVersion confirmation)."""
    c = SimCluster(seed=301, n_proxies=2)
    try:
        db = c.client()

        async def main():
            # many sequential read-own-write rounds: each round's GRV
            # lands on a random proxy, so both orders get exercised
            for i in range(30):
                async def wbody(tr, i=i):
                    tr.set(b"c", b"%d" % i)
                await run_transaction(db, wbody)
                tr = db.create_transaction()
                got = await tr.get(b"c")
                assert got == b"%d" % i, (i, got)
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()


def test_two_proxies_concurrent_increment():
    c = SimCluster(seed=307, n_proxies=2)
    try:
        dbs = [c.client(f"cl{i}") for i in range(4)]

        async def incr(db, n):
            for _ in range(n):
                async def body(tr):
                    cur = await tr.get(b"n")
                    tr.set(b"n", b"%d" % (int(cur or b"0") + 1))
                await run_transaction(db, body, max_retries=500)

        async def main():
            await flow.wait_for_all([flow.spawn(incr(d, 8)) for d in dbs])
            tr = dbs[0].create_transaction()
            assert await tr.get(b"n") == b"32"
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_replicated_logs_survive_one_tlog_loss():
    """n_logs=2: every ack required both logs, so after one dies the
    survivor has every acked commit; recovery rebuilds on it and
    nothing is lost."""
    c = SimCluster(seed=311, durable=True, n_logs=2, n_workers=6)
    try:
        db = c.client()

        async def main():
            acked = {}
            for i in range(10):
                async def body(tr, i=i):
                    tr.set(b"r%02d" % i, b"v%d" % i)
                await run_transaction(db, body, max_retries=300)
                acked[b"r%02d" % i] = b"v%d" % i
                if i == 4:
                    c.kill_role("tlog")

            async def check(tr):
                got = dict(await tr.get_range(b"r", b"s"))
                assert got == acked, (len(got), len(acked))
            await run_transaction(db, check, max_retries=100)
            info = c.cc.dbinfo.get()
            assert len(info.logs.logs) == 2
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_sharded_storage_cross_shard_ops():
    """n_storage=3: writes land on their shards, range reads stitch
    across boundaries, clears span shards, selectors walk over
    boundaries."""
    c = SimCluster(seed=313, n_storage=3)
    try:
        db = c.client()

        async def main():
            keys = [b"\x10a", b"\x55b", b"\x55c", b"\xaad", b"\xaae",
                    b"\xf0f"]
            async def setup(tr):
                for i, k in enumerate(keys):
                    tr.set(k, b"v%d" % i)
            await run_transaction(db, setup)

            tr = db.create_transaction()
            # cross-shard range read
            got = await tr.get_range(b"", b"\xff")
            assert got == [(k, b"v%d" % i) for i, k in enumerate(keys)]
            # reverse, limited
            got = await tr.get_range(b"", b"\xff", limit=3, reverse=True)
            assert [k for k, _ in got] == [b"\xf0f", b"\xaae", b"\xaad"]
            # selector walking across a shard boundary:
            # first_greater_or_equal(\x55b) + 2 present keys -> \xaad
            sel = KeySelector(b"\x55b", False, 3)
            assert await tr.get_key(sel) == b"\xaad"
            # backward across the boundary: last_less_than(\xaad) - 1
            sel = KeySelector(b"\xaad", False, -1)
            assert await tr.get_key(sel) == b"\x55b"

            # cross-shard clear
            async def clr(tr):
                tr.clear_range(b"\x40", b"\xc0")
            await run_transaction(db, clr)
            tr2 = db.create_transaction()
            got = await tr2.get_range(b"", b"\xff")
            assert got == [(b"\x10a", b"v0"), (b"\xf0f", b"v5")]
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()


def test_sharded_and_durable_with_kill():
    """Shards + replication + kills together."""
    c = SimCluster(seed=317, durable=True, n_storage=2, n_logs=2,
                   n_resolvers=2, n_workers=6)
    try:
        db = c.client()

        async def main():
            acked = {}
            for i in range(12):
                k = bytes([i * 20]) + b"k%02d" % i
                async def body(tr, k=k, i=i):
                    tr.set(k, b"v%d" % i)
                await run_transaction(db, body, max_retries=300)
                acked[k] = b"v%d" % i
                if i == 5:
                    c.kill_role("tlog")
                if i == 8:
                    c.kill_role("storage")

            async def check(tr):
                got = dict(await tr.get_range(b"", b"\xff"))
                assert got == acked, (sorted(got), sorted(acked))
            await run_transaction(db, check, max_retries=200)
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_grv_degrades_on_dead_peer_without_erroring():
    """A dead GRV-confirmation peer must not error the batch: the proxy
    marks the peer suspect and falls back to the TLogs' durable
    frontier — min(frontier) across logs is >= every acknowledged commit
    and is reachable by storage — so clients see a valid read version,
    never an error (ref: the reference degrading
    by recruitment, MasterProxyServer.actor.cpp:1019)."""
    from foundationdb_tpu_torch.rpc import RequestStream

    c = SimCluster(seed=311, n_proxies=2)
    try:
        db = c.client()

        async def main():
            async def wbody(tr):
                tr.set(b"k", b"v")
            await run_transaction(db, wbody)

            proxies = c.cc._current_proxies()
            assert len(proxies) == 2
            a, b = proxies
            floor = max(p.committed_version.get() for p in proxies)

            # replace a's view of its peer with an endpoint that never
            # answers (peer process dead, recovery not yet rotated)
            dead = RequestStream(db.process)
            a.set_peers([dead.ref()])

            t0 = flow.now()
            reply = await a.grvs.ref().get_reply(None, db.process)
            assert reply.version >= floor, (reply.version, floor)
            assert a.stats.counter("grv_degraded").value >= 1

            # suspect cache: the next batch skips the dead peer and
            # answers well inside one confirm-timeout
            t1 = flow.now()
            reply2 = await a.grvs.ref().get_reply(None, db.process)
            assert reply2.version >= reply.version
            assert flow.now() - t1 < flow.SERVER_KNOBS.grv_confirm_timeout, (
                flow.now() - t1)
            # the first, suspect-discovering batch pays at most one
            # confirm-timeout plus the fallback round-trip
            assert flow.now() - t0 < 3 * flow.SERVER_KNOBS.grv_confirm_timeout
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()
