"""The reference's cases of tests/test_tools_layers.py on the port's CLI,
backup layer and bindings (test_fdb_binding_surface).

Tools + surfaces: the fdbcli analogue, backup/restore, and the
fdb-style binding (ref: fdbcli/fdbcli.actor.cpp,
fdbclient/FileBackupAgent.actor.cpp, bindings/python/fdb)."""

import pytest

torch = pytest.importorskip("torch")

import foundationdb_tpu_torch.bindings as fdb
from foundationdb_tpu_torch.client import run_transaction
from foundationdb_tpu_torch.layers import backup as bk
from foundationdb_tpu_torch.server import SimCluster
from foundationdb_tpu_torch.tools.cli import Cli


def test_cli_commands():
    c = SimCluster(seed=801)
    cli = Cli.for_cluster(c)
    try:
        assert cli.execute("set apple red") == "Committed"
        assert cli.execute("set banana yellow") == "Committed"
        assert cli.execute("get apple") == "`apple' is `red'"
        assert "not found" in cli.execute("get missing")
        out = cli.execute("getrange a z")
        assert "`apple' is `red'" in out and "`banana' is `yellow'" in out
        assert cli.execute("getkey ge apple 1") == "`banana'"
        assert cli.execute("clear apple") == "Committed"
        assert "not found" in cli.execute("get apple")
        # escapes
        assert cli.execute("set \\x00k v") == "Committed"
        assert cli.execute("get \\x00k") == "`\\x00k' is `v'"
        st = cli.execute("status")
        assert "fully_recovered" in st
        assert "transactions committed" in st
        cli.writemode = False
        assert "writemode" in cli.execute("set a b")
        assert "unknown command" in cli.execute("frobnicate")
    finally:
        c.shutdown()


def test_cli_exec_mode(tmp_path):
    from foundationdb_tpu_torch.tools.cli import main
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--exec", "set k v; get k; status"])
    out = buf.getvalue()
    assert rc == 0
    assert "`k' is `v'" in out
    assert "fully_recovered" in out


def test_backup_restore_roundtrip(tmp_path):
    c = SimCluster(seed=803, n_storage=2)
    try:
        db = c.client()
        path = str(tmp_path / "snap.fdbtpu")

        async def main():
            async def seed(tr):
                for i in range(120):
                    tr.set(b"bk%03d" % i, b"v%d" % i)
            await run_transaction(db, seed)

            blob, version, n = await bk.backup(db)
            assert n == 120 and version > 0
            bk.backup_to_file(blob, path)

            # diverge: mutate + add garbage
            async def mutate(tr):
                tr.clear_range(b"bk", b"bk\xff")
                tr.set(b"junk", b"x")
            await run_transaction(db, mutate)

            restored = await bk.restore(db, path)
            assert restored == 120
            tr = db.create_transaction()
            got = await tr.get_range(b"", b"\xff")
            assert got == [(b"bk%03d" % i, b"v%d" % i) for i in range(120)]
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()


def test_backup_rejects_garbage(tmp_path):
    p = tmp_path / "bad.bin"
    p.write_bytes(b"not a backup")
    with pytest.raises(ValueError):
        bk.read_backup(str(p))


def test_fdb_binding_surface():
    c = SimCluster(seed=805)
    try:
        db = fdb.open(c)
        users = fdb.Subspace(("users",))

        @fdb.transactional
        async def add_user(tr, uid, name):
            tr.set(users.pack((uid,)), name)

        @fdb.transactional
        async def get_user(tr, uid):
            return await tr.get(users.pack((uid,)))

        @fdb.transactional
        async def composed(tr, uid):
            # a transactional called with a Transaction composes without
            # a nested retry loop
            await add_user(tr, uid, b"inner")
            return await get_user(tr, uid)

        async def main():
            await add_user(db, 1, b"alice")
            assert await get_user(db, 1) == b"alice"
            assert await composed(db, 2) == b"inner"
            assert fdb.tuple.unpack(users.pack((1,)))[-1] == 1
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_cli_operator_commands():
    """coordinators / consistencycheck / profile (ref: the fdbcli
    command table + `-r consistencycheck` + ProfilerRequest)."""
    from foundationdb_tpu_torch.tools.cli import Cli

    c = SimCluster(seed=73, durable=True, n_coordinators=3)
    try:
        cli = Cli.for_cluster(c)
        assert cli.execute("set alpha 1") == "Committed"
        out = cli.execute("consistencycheck")
        assert out.startswith("Consistency check passed"), out

        assert cli.execute("profile on") == "Profiler on"
        for i in range(5):
            cli.execute(f"set p{i} x")
        out = cli.execute("profile off")
        assert out.startswith("Profiler off"), out
        assert any(ch.isdigit() for ch in out)

        out = cli.execute("coordinators 3")
        assert "3 new coordinators" in out, out
        # the cluster still serves traffic on the new quorum
        assert cli.execute("set beta 2") == "Committed"
        assert "2" in cli.execute("get beta")
    finally:
        c.shutdown()
