"""The reference's cases of tests/test_consistency.py on the port's
SimCluster, and its sweep over TCP against the port's server process.

ConsistencyCheck: the full-replica sweep (ref:
fdbserver/workloads/ConsistencyCheck.actor.cpp, tester.actor.cpp:741).

Proves three properties: the sweep
passes on a healthy replicated cluster after faults, it CAN fail (an
injected single-replica divergence is detected), and it validates
shard accounting."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server.consistency import (ConsistencyError,  # noqa: E402
                                                 check_consistency)


def test_sweep_passes_on_replicated_cluster_after_faults():
    c = SimCluster(seed=701, durable=True, n_storage=2,
                   storage_replicas=2, n_workers=6)
    try:
        db = c.client()

        async def main():
            for i in range(30):
                async def body(tr, i=i):
                    tr.set(b"k%03d" % i, b"v%d" % i)
                await run_transaction(db, body)
            # a storage kill + recovery in the middle
            c.kill_role("storage")
            for i in range(30, 60):
                async def body(tr, i=i):
                    tr.set(b"k%03d" % i, b"v%d" % i)
                await run_transaction(db, body, max_retries=500)
            stats = await check_consistency(c)
            assert stats["shards"] >= 2
            assert stats["replicas"] == stats["shards"] * 2
            assert stats["rows"] >= 60
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_sweep_detects_injected_divergence():
    """The check must be able to FAIL: silently corrupt one replica's
    in-memory data and require the sweep to notice."""
    c = SimCluster(seed=703, n_storage=2, storage_replicas=2,
                   n_workers=6)
    try:
        db = c.client()

        async def main():
            for i in range(10):
                async def body(tr, i=i):
                    tr.set(b"d%02d" % i, b"x%d" % i)
                await run_transaction(db, body)
            await c.quiet_database()
            # inject: flip one row on ONE replica, bypassing the
            # commit path entirely
            victim = next(iter(c.cc._storage_objs.values()))
            v = victim.version.get()
            from foundationdb_tpu_torch.server.types import (MutationRef,
                                                       SET_VALUE)
            victim.data.apply(v, MutationRef(SET_VALUE, b"d05",
                                             b"CORRUPT"))
            with pytest.raises(ConsistencyError) as ei:
                await check_consistency(c, quiesce=False)
            assert b"d05" in str(ei.value).encode() or \
                "d05" in str(ei.value)
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()


def test_sweep_detects_shard_map_violations():
    """Shard accounting: a published map with a gap must fail."""
    c = SimCluster(seed=705, n_storage=2)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set(b"a", b"1")
            await run_transaction(db, body)
            await c.quiet_database()
            # hand the SWEEP's client a picture whose shard map has a
            # gap (injected into the handle, not published — the
            # always-on sim validator would rightly fail the broken
            # broadcast before the sweep could demonstrate its own
            # accounting check)
            info = await db.info()
            broken = info._replace(
                storages=(info.storages[0]._replace(end=b"zzz"),)
                + info.storages[1:])
            # the first shard now ends at b"zzz" while the second
            # still begins at the original split: gap or overlap
            db._info = broken
            with pytest.raises(ConsistencyError):
                await check_consistency(db, quiesce=False)
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()


def test_sweep_over_tcp_against_server_process():
    """The round-4 de-sim criterion: ConsistencyCheck runnable against
    a tools.server cluster OVER TCP — the sweep reads the broadcast
    shard refs, GRVs, status, and every replica's ranges through the
    wire protocol only (no role-object access)."""
    import os
    import subprocess
    import sys
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "foundationdb_tpu_torch.tools.server",
         "--port", "0", "--seed", "71", "--storage", "2",
         "--replicas", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("LISTENING "), line
        port = int(line.split()[1])

        from foundationdb_tpu_torch.client.remote import RemoteCluster
        rc = RemoteCluster("127.0.0.1", port)
        try:
            async def seed():
                for i in range(20):
                    tr = rc.db.create_transaction()
                    tr.set(b"tcp%02d" % i, b"v%d" % i)
                    await tr.commit()
                return True
            assert rc.call(seed(), timeout=60)
            stats = rc.call(check_consistency(rc.db), timeout=120)
            assert stats["shards"] == 2
            assert stats["replicas"] == 4
            assert stats["rows"] >= 20
        finally:
            rc.close()

        # ...and through the CLI's --connect mode
        import io
        from contextlib import redirect_stdout
        from foundationdb_tpu_torch.tools.cli import main as cli_main
        buf = io.StringIO()
        with redirect_stdout(buf):
            code = cli_main(["--connect", f"127.0.0.1:{port}", "--exec",
                             "consistencycheck"])
        assert code == 0
        assert "Consistency check passed" in buf.getvalue(), buf.getvalue()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
