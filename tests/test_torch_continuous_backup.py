"""The reference's cases of tests/test_continuous_backup.py on the
port's backup agent.

Continuous backup: the mutation-log tail + snapshot gives
point-in-time restore; the tag survives epoch recoveries (ref:
fdbclient/FileBackupAgent.actor.cpp + design/backup.md)."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow
from foundationdb_tpu_torch.client import run_transaction
from foundationdb_tpu_torch.layers import backup_agent as ba
from foundationdb_tpu_torch.server import SimCluster


def test_point_in_time_restore():
    c = SimCluster(seed=1501, durable=True)
    try:
        db = c.client()

        async def main():
            async def write_kv(k, v):
                async def body(tr):
                    tr.set(k, v)
                await run_transaction(db, body)

            await write_kv(b"pre", b"1")

            agent = ba.BackupAgent(c, c.client("agent"))
            base_v = await agent.start()

            # era A
            for i in range(5):
                await write_kv(b"a%d" % i, b"A")
            tr = db.create_transaction()
            await tr.get(b"a0")
            v_mid = await tr.get_read_version()

            # era B (after the point we'll restore to)
            for i in range(5):
                await write_kv(b"b%d" % i, b"B")
            async def clr(tr):
                tr.clear(b"pre")
            await run_transaction(db, clr)

            await agent.wait_tailed_to(v_mid)
            tr2 = db.create_transaction()
            await tr2.get(b"b0")
            v_end = await tr2.get_read_version()
            await agent.wait_tailed_to(v_end)
            await agent.stop()
            snapshot, log = agent.base_blob, agent.write_log()

            # wipe, then restore to v_mid: era A present, era B absent
            async def wipe(tr):
                tr.clear_range(b"", b"\xff")
            await run_transaction(db, wipe)
            await ba.restore_to_version(db, snapshot, log, v_mid)

            async def check_mid(tr):
                got = dict(await tr.get_range(b"", b"\xff"))
                assert got.get(b"pre") == b"1"
                assert all(got.get(b"a%d" % i) == b"A" for i in range(5))
                assert not any(k.startswith(b"b") for k in got), got
            await run_transaction(db, check_mid, max_retries=200)

            # restore to the end: everything incl. the clear of `pre`
            await run_transaction(db, wipe)
            await ba.restore_to_version(db, snapshot, log, v_end)

            async def check_end(tr):
                got = dict(await tr.get_range(b"", b"\xff"))
                assert b"pre" not in got
                assert all(got.get(b"a%d" % i) == b"A" for i in range(5))
                assert all(got.get(b"b%d" % i) == b"B" for i in range(5))
            await run_transaction(db, check_end, max_retries=200)
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_backup_tail_survives_recovery():
    """A TLog kill mid-backup: the tag carries into the new epoch's
    logs and the tail drains the old generation — nothing is lost."""
    c = SimCluster(seed=1507, durable=True)
    try:
        db = c.client()

        async def main():
            agent = ba.BackupAgent(c, c.client("agent"))
            await agent.start()

            async def write_k(k):
                async def body(tr):
                    tr.set(k, b"v")
                await run_transaction(db, body, max_retries=300)
            for i in range(4):
                await write_k(b"k%d" % i)
            c.kill_role("tlog")
            for i in range(4, 8):
                await write_k(b"k%d" % i)

            tr = db.create_transaction()
            await tr.get(b"k7")
            v_end = await tr.get_read_version()
            await agent.wait_tailed_to(v_end, max_wait=120)
            await agent.stop()
            snapshot, log = agent.base_blob, agent.write_log()

            async def wipe(tr):
                tr.clear_range(b"", b"\xff")
            await run_transaction(db, wipe, max_retries=300)
            await ba.restore_to_version(db, snapshot, log, v_end)

            async def check(tr):
                got = await tr.get_range(b"k", b"l")
                assert len(got) == 8, got
            await run_transaction(db, check, max_retries=200)
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()


def test_dr_replicates_to_second_cluster():
    """Continuous DR: a destination CLUSTER (second cluster in the
    same simulation) converges to the source's state across a source
    TLog kill mid-stream (ref: DatabaseBackupAgent)."""
    src = SimCluster(seed=1601, durable=True)
    dest = SimCluster(share_with=src, name_prefix="dr-", durable=True)
    try:
        db = src.client()
        dest_db = dest.client()

        async def main():
            async def write_k(k, v):
                async def body(tr):
                    tr.set(k, v)
                await run_transaction(db, body, max_retries=300)

            await write_k(b"seed", b"0")
            agent = ba.DrAgent(src, src.client("agent"), dest_db)
            await agent.start()

            for i in range(4):
                await write_k(b"d%d" % i, b"v%d" % i)
            src.kill_role("tlog")
            for i in range(4, 8):
                await write_k(b"d%d" % i, b"v%d" % i)

            tr = db.create_transaction()
            await tr.get(b"d7")
            v_end = await tr.get_read_version()
            await agent.wait_tailed_to(v_end, max_wait=120)
            await agent.wait_applied_to(v_end, max_wait=120)
            await agent.stop()

            async def check(tr):
                got = dict(await tr.get_range(b"", b"\xff"))
                # stop() clears the idempotency markers: the destination
                # must be byte-identical to the replicated range, with
                # no \x02dr-mark/ residue
                assert not any(k.startswith(b"\x02") for k in got), got
                assert got.get(b"seed") == b"0"
                assert all(got.get(b"d%d" % i) == b"v%d" % i
                           for i in range(8)), got
            await run_transaction(dest_db, check, max_retries=200)
            return True

        assert src.run(main(), timeout_time=900)
    finally:
        dest.shutdown()
        src.shutdown()
