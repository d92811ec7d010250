"""The reference's cases of tests/test_metadata_keys.py on the port's
SimCluster.

Management through the system keyspace.

Ref: fdbclient/SystemData.cpp (\\xff/conf/ keys), ManagementAPI
changeConfig building system-key transactions,
fdbserver/ApplyMetadataMutation.h (the proxy interpreting system-key
mutations during commit). The
committed keys ARE the coordination medium — a raw transaction on
\\xff/conf/ must reconfigure the cluster, and the bespoke
ConfigureRequest RPC is gone.
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402


def test_configure_request_rpc_is_gone():
    import foundationdb_tpu_torch.server.cluster_controller as cc
    assert not hasattr(cc, "ConfigureRequest")
    assert not hasattr(cc, "ExcludeRequest")


def _wait_recovered_past(c, epoch):
    async def w():
        while c.cc.dbinfo.get().epoch <= epoch or \
                c.cc.dbinfo.get().recovery_state != "fully_recovered":
            await flow.delay(0.1)
    return w()


def test_raw_conf_transaction_reconfigures_cluster():
    """A plain ACCESS_SYSTEM_KEYS transaction on \\xff/conf/proxies —
    no management API involved — must trigger an epoch recovery into
    the new shape, and the row must read back as committed data."""
    c = SimCluster(seed=6100, n_workers=5)
    try:
        db = c.client()

        async def main():
            await _wait_recovered_past(c, 0)   # initial boot recovery
            e0 = c.cc.dbinfo.get().epoch

            async def body(tr):
                tr.set_option("access_system_keys")
                tr.set(b"\xff/conf/proxies", b"2")
            await run_transaction(db, body, max_retries=200)

            await _wait_recovered_past(c, e0)
            info = c.cc.dbinfo.get()
            assert len(info.proxies) == 2
            assert c.cc.config.n_proxies == 2

            # the committed row is real, versioned data
            tr = db.create_transaction()
            tr.set_option("read_system_keys")
            assert await tr.get(b"\xff/conf/proxies") == b"2"

            # writes still work through the reshaped pipeline
            async def body2(tr):
                tr.set(b"after", b"reconfig")
            await run_transaction(db, body2, max_retries=200)
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()


def test_invalid_conf_value_is_clamped_not_honored():
    """Garbage in \\xff/conf/ commits (the keyspace is real data) but
    the CC ignores unrecruitable values with a trace instead of
    bricking recovery; the seeder then repairs the row to the live
    truth after the next recovery."""
    c = SimCluster(seed=6200, n_workers=4)
    try:
        db = c.client()

        async def main():
            await _wait_recovered_past(c, 0)   # initial boot recovery
            e0 = c.cc.dbinfo.get().epoch

            async def body(tr):
                tr.set_option("access_system_keys")
                tr.set(b"\xff/conf/logs", b"ninety-nine")  # not an int
                tr.set(b"\xff/conf/proxies", b"99")        # > workers
            await run_transaction(db, body, max_retries=200)
            await flow.delay(2.0)
            # neither value was honored, no recovery was provoked
            assert c.cc.config.n_logs == 1
            assert c.cc.config.n_proxies == 1
            assert c.cc.dbinfo.get().epoch == e0
            assert flow.trace.g_trace.counts.get(
                "MetadataConfigIgnored", 0) >= 1
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_configure_and_exclude_survive_recovery_roundtrip():
    """db.configure / db.exclude ride transactions end-to-end: rows
    appear, the CC reacts, re-include clears the row."""
    c = SimCluster(seed=6300, n_workers=5)
    try:
        db = c.client()

        async def main():
            await _wait_recovered_past(c, 0)   # initial boot recovery
            e0 = c.cc.dbinfo.get().epoch
            await db.configure(n_resolvers=2)
            await _wait_recovered_past(c, e0)
            assert c.cc.config.n_resolvers == 2

            # pick a worker with no current txn roles; exclude it
            victim = None
            for name, wi in c.cc.workers.items():
                if not wi.worker.roles and wi.worker.process.alive:
                    victim = name
                    break
            if victim is None:
                victim = next(iter(c.cc.workers))
            await db.exclude(victim)
            await flow.delay(1.0)
            assert victim in c.cc.excluded
            tr = db.create_transaction()
            tr.set_option("read_system_keys")
            assert await tr.get(
                b"\xff/excluded/" + victim.encode()) == b""

            await db.exclude(victim, exclude=False)
            await flow.delay(1.0)
            assert victim not in c.cc.excluded
            tr = db.create_transaction()
            tr.set_option("read_system_keys")
            assert await tr.get(
                b"\xff/excluded/" + victim.encode()) is None
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()


def test_lost_proxy_notice_is_reconciled_from_rows():
    """The one-way proxy notice is only the low-latency trigger: with
    it suppressed entirely, the CC's reconcile loop must still adopt a
    committed \\xff/conf change from the stored rows (the keys are the
    medium, not the RPC — ref: the reference reading configuration
    from the system keyspace)."""
    c = SimCluster(seed=6500, n_workers=5)
    try:
        db = c.client()

        async def main():
            await _wait_recovered_past(c, 0)
            # sever every proxy's management notice — a crashed proxy
            # loses the datagram the same way
            for p in c.cc.dbinfo.get().proxies:
                for wi in c.cc.workers.values():
                    obj = wi.worker.roles.get(p.name)
                    if obj is not None:
                        obj._management_ref = None
            e0 = c.cc.dbinfo.get().epoch

            async def body(tr):
                tr.set_option("access_system_keys")
                tr.set(b"\xff/conf/resolvers", b"2")
            await run_transaction(db, body, max_retries=200)
            await _wait_recovered_past(c, e0)   # sync loop picks it up
            assert c.cc.config.n_resolvers == 2
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()


def test_conf_rows_survive_shard_movement():
    """Stored system rows are first-class shard data now: a split and
    merge cycle of the rightmost shard must carry \\xff/conf/ rows
    (they used to be silently dropped — snapshot_range capped at
    \\xff)."""
    c = SimCluster(seed=6400, durable=True, n_storage=1, n_workers=5)
    flow.SERVER_KNOBS.init("DD_SHARD_SPLIT_BYTES", 1200)
    try:
        db = c.client()

        async def main():
            # wait for the conf seed to land
            for _ in range(100):
                tr = db.create_transaction()
                tr.set_option("read_system_keys")
                if await tr.get(b"\xff/conf/proxies") is not None:
                    break
                await flow.delay(0.2)

            async def seed(tr):
                for i in range(300):
                    tr.set(b"mv%04d" % i, b"v%d" % i)
            await run_transaction(db, seed, max_retries=200)
            for _ in range(120):
                await flow.delay(0.5)
                if len(c.cc.dbinfo.get().storages) >= 2:
                    break
            else:
                raise AssertionError("never split")

            async def wipe(tr):
                tr.clear_range(b"", b"\xff")
            await run_transaction(db, wipe, max_retries=200)
            for _ in range(120):
                await flow.delay(0.5)
                if len(c.cc.dbinfo.get().storages) == 1:
                    break

            tr = db.create_transaction()
            tr.set_option("read_system_keys")
            assert await tr.get(b"\xff/conf/proxies") == b"1"
            rows = await tr.get_range(b"\xff/conf/", b"\xff/conf0")
            assert len(rows) >= 8, rows
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        flow.reset_server_knobs()
        c.shutdown()
