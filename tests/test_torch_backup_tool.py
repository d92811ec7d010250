"""The reference's cases of tests/test_backup_tool.py on the port's
backup tool and CLI.

The standalone backup/restore driver (fdbtpu-backup).

Ref: fdbbackup/backup.actor.cpp:74 — one multiplexed binary
(start/status/wait/abort + fdbrestore) that drives backups through the
database's backup control subspace while cluster-side agents do the
work. The contract under test: the tool speaks ONLY the client surface
(control rows + container IO), the cluster-side BackupDriver executes
the lifecycle, and a full round trip — populate, back up to
blobstore://, wipe, restore — works both in-sim and from the command
line against a separate server process.
"""

import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow
from foundationdb_tpu_torch.client import run_transaction
from foundationdb_tpu_torch.layers.backup_container import BlobStoreServer
from foundationdb_tpu_torch.server import SimCluster
from foundationdb_tpu_torch.tools import backup_tool as bt


def test_backup_tool_roundtrip_in_sim():
    store = BlobStoreServer()
    url = f"blobstore://{store.host}:{store.port}"
    c = SimCluster(seed=901, durable=True, backup_driver=True)
    try:
        db = c.client()

        async def main():
            # pre-backup data
            for i in range(10):
                async def body(tr, i=i):
                    tr.set(b"pre%02d" % i, b"v%d" % i)
                await run_transaction(db, body, max_retries=500)

            out = await bt.backup_start(db, url)
            assert out["state"] == "submitted"
            # double-start is refused while one is active
            with pytest.raises(RuntimeError):
                await bt.backup_start(db, url)

            st = await bt.backup_wait(db, max_wait=120)
            assert st["state"] in ("running", "stopped")

            # post-snapshot writes ride the mutation log
            last = 0
            for i in range(10):
                tr = db.create_transaction()
                tr.set(b"post%02d" % i, b"v%d" % i)
                last = await tr.commit()

            st = await bt.backup_wait(db, version=last, max_wait=120)
            assert st["restorable_version"] >= last

            status = await bt.backup_status(db)
            assert status["state"] == "running"
            assert status["dest"] == url
            assert status["container"]["snapshot_versions"]

            st = await bt.backup_abort(db, max_wait=120)
            assert st["state"] == "stopped"
            assert st["restorable_version"] >= last

            # wipe, then restore from the container
            async def wipe(tr):
                tr.clear_range(b"", b"\xff")
            await run_transaction(db, wipe, max_retries=500)

            async def check_empty(tr):
                return await tr.get_range(b"", b"\xff", limit=5)
            assert await run_transaction(db, check_empty,
                                         max_retries=500) == []

            out = await bt.backup_restore(db, url)
            assert out["restored_to_version"] >= last

            async def read_all(tr):
                return dict(await tr.get_range(b"", b"\xff"))
            rows = await run_transaction(db, read_all, max_retries=500)
            for i in range(10):
                assert rows.get(b"pre%02d" % i) == b"v%d" % i
                assert rows.get(b"post%02d" % i) == b"v%d" % i

            # a second backup may start after the first stopped
            out = await bt.backup_start(db, url)
            assert out["state"] == "submitted"
            await bt.backup_abort(db, max_wait=120)
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()
        store.close()


def test_backup_tool_from_command_line():
    """A round-trip through blobstore://
    FROM THE COMMAND LINE — a tools.server subprocess hosts the
    cluster (its BackupDriver included), and every step is a real
    `python -m foundationdb_tpu_torch.tools.backup_tool ...` invocation."""
    import os
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    store = BlobStoreServer()
    url = f"blobstore://{store.host}:{store.port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "foundationdb_tpu_torch.tools.server",
         "--port", "0", "--seed", "87"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("LISTENING "), line
        port = int(line.split()[1])
        connect = f"127.0.0.1:{port}"

        def tool(*args):
            r = subprocess.run(
                [sys.executable, "-m",
                 "foundationdb_tpu_torch.tools.backup_tool", *args,
                 "-C", connect],
                capture_output=True, text=True, env=env, timeout=300)
            assert r.returncode == 0, (args, r.stdout, r.stderr)
            import json
            return json.loads(r.stdout)

        from foundationdb_tpu_torch.tools.cli import main as cli_main
        import io
        from contextlib import redirect_stdout

        def cli(script):
            buf = io.StringIO()
            with redirect_stdout(buf):
                rc = cli_main(["--connect", connect, "--exec", script])
            assert rc == 0, buf.getvalue()
            return buf.getvalue()

        cli("set alpha one; set beta two")
        out = tool("start", "-d", url)
        assert out["state"] == "submitted"
        tool("wait", "--timeout", "120")
        cli("set gamma three")
        st = tool("status")
        assert st["state"] == "running" and st["dest"] == url
        out = tool("abort", "--timeout", "120")
        assert out["state"] == "stopped"

        cli("clearrange \\x00 \\xfe")
        assert "`alpha': not found" in cli("get alpha")
        out = tool("restore", "-r", url)
        assert out["restored_to_version"] > 0
        got = cli("get alpha; get beta")
        assert "`alpha' is `one'" in got and "`beta' is `two'" in got
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        store.close()
