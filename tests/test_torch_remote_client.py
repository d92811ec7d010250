"""The reference's cases of tests/test_remote_client.py on the port: the
remote client over a gatewayed cluster, the port's server, monitor and
CLI as separate processes, mutual TLS, the watch forwarding and the
cluster file. GatewayedCluster is the port's
(foundationdb_tpu_torch.testing), not the C-binding test's.

Out-of-process access: RemoteCluster (full Python client over TCP)
and a genuinely separate server process driven by the CLI.

Ref: external fdbcli/clients reaching a cluster purely over the wire
(FlowTransport + MonitorLeader); fdbserver as the hosting process.
"""

import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch.client import run_transaction
from foundationdb_tpu_torch.client.remote import RemoteCluster

from foundationdb_tpu_torch.testing import GatewayedCluster


def test_remote_python_client_full_stack():
    """The unchanged Python client (RYW, routing, retry) over TCP:
    transactions, status, management — all cross-thread via
    RemoteCluster.call."""
    with GatewayedCluster(seed=81, n_storage=2, n_proxies=2) as gc:
        rc = RemoteCluster("127.0.0.1", gc.port)
        try:
            async def write(tr):
                tr.set(b"remote", b"yes")
                tr.set(b"\x90far", b"side")
            rc.call(run_transaction(rc.db, write))

            async def read(tr):
                assert await tr.get(b"remote") == b"yes"
                rows = await tr.get_range(b"", b"\xff")
                assert (b"\x90far", b"side") in rows
                return len(rows)
            assert rc.call(run_transaction(rc.db, read)) == 2

            # RYW + conflict semantics hold over the wire
            async def conflicting():
                t1 = rc.db.create_transaction()
                t2 = rc.db.create_transaction()
                await t1.get(b"occ")
                await t2.get(b"occ")
                t1.set(b"occ", b"a")
                await t1.commit()
                t2.set(b"occ", b"b")
                try:
                    await t2.commit()
                    return "committed"
                except Exception as e:  # noqa: BLE001
                    return getattr(e, "name", "?")
            assert rc.call(conflicting()) == "not_committed"

            status = rc.call(rc.db.get_status())
            assert status["cluster"]["recovery_state"] == "fully_recovered"
            assert len(status["cluster"]["storages"]) == 2
        finally:
            rc.close()


def test_cli_against_separate_server_process():
    """True multi-process: a tools.server subprocess hosts the cluster;
    the CLI connects over TCP from THIS process and reads back what it
    wrote (ref: fdbcli -C against a running fdbserver)."""
    import os
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "foundationdb_tpu_torch.tools.server",
         "--port", "0", "--seed", "83"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("LISTENING "), line
        port = int(line.split()[1])

        from foundationdb_tpu_torch.tools.cli import main as cli_main
        import io
        from contextlib import redirect_stdout

        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = cli_main(["--connect", f"127.0.0.1:{port}", "--exec",
                           "set alpha one; set beta two; get alpha; "
                           "getrange a c; status"])
        assert rc == 0
        out = buf.getvalue()
        assert "`alpha' is `one'" in out
        assert "`beta' is `two'" in out
        assert "fully_recovered" in out or "Epoch" in out
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_remote_client_over_mutual_tls(tmp_path):
    """The full remote client stack over mutually-authenticated TLS —
    a rogue client with an untrusted certificate cannot connect (ref:
    FDBLibTLS protecting every external connection)."""
    import subprocess

    from foundationdb_tpu_torch.rpc.tcp import TlsConfig

    def make_cert(name):
        key = str(tmp_path / f"{name}-key.pem")
        cert = str(tmp_path / f"{name}-cert.pem")
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", key, "-out", cert, "-days", "2",
             "-subj", f"/CN=fdbtpu-{name}"],
            check=True, capture_output=True)
        return cert, key

    cert, key = make_cert("cluster")
    rogue_cert, rogue_key = make_cert("rogue")
    tls = TlsConfig(cert, key, cert)

    # GatewayedCluster with a TLS transport
    import foundationdb_tpu_torch.rpc.gateway as gwmod

    class TlsGatewayedCluster(GatewayedCluster):
        def _main(self):
            import foundationdb_tpu_torch.flow as fl
            from foundationdb_tpu_torch.server.cluster import SimCluster
            gw = None
            c = None
            try:
                c = SimCluster(virtual=False, **self.kw)
                gw = gwmod.TcpGateway(c.client("gateway-host"), tls=tls)

                async def main():
                    gw.start()
                    self.q.put(gw.port)
                    while not self.stop.is_set():
                        await fl.delay(0.02)

                c.run(main())
            except BaseException as e:  # noqa: BLE001
                self.q.put(e)
            finally:
                if gw is not None:
                    gw.close()
                if c is not None:
                    c.shutdown()

    with TlsGatewayedCluster(seed=87) as gc:
        # generous boot window: RSA keygen + TLS handshakes under a
        # loaded machine can stretch startup well past the default
        rc = RemoteCluster("127.0.0.1", gc.port, tls=tls,
                           connect_timeout=120)
        try:
            async def write(tr):
                tr.set(b"secure", b"channel")
            rc.call(run_transaction(rc.db, write))

            async def read(tr):
                return await tr.get(b"secure")
            assert rc.call(run_transaction(rc.db, read)) == b"channel"
        finally:
            rc.close()

        # untrusted certificate: the connection dies AT THE HANDSHAKE —
        # a specific transport error, fast, not a connect-timeout
        from foundationdb_tpu_torch import flow as fl
        with pytest.raises(fl.FdbError) as ei:
            RemoteCluster("127.0.0.1", gc.port, connect_timeout=60,
                          tls=TlsConfig(rogue_cert, rogue_key, cert))
        assert ei.value.name in ("broken_promise", "timed_out")


def test_server_process_sigkill_restart_keeps_data(tmp_path):
    """Operator durability: a tools.server process is SIGKILLed and a
    NEW process restarts on the same --data-dir; committed data
    survives (ref: restarting fdbserver on its data directory)."""
    import os
    import signal

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    data = str(tmp_path / "srvdata")

    def start():
        p = subprocess.Popen(
            [sys.executable, "-m", "foundationdb_tpu_torch.tools.server",
             "--port", "0", "--seed", "84", "--data-dir", data],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            env=env)
        line = p.stdout.readline().strip()
        assert line.startswith("LISTENING "), line
        return p, int(line.split()[1])

    proc, port = start()
    try:
        rc = RemoteCluster("127.0.0.1", port)
        try:
            async def write(tr):
                for i in range(30):
                    tr.set(b"dur%02d" % i, b"v%d" % i)
            rc.call(run_transaction(rc.db, write))
        finally:
            rc.close()
        proc.send_signal(signal.SIGKILL)   # no clean shutdown
        proc.wait(timeout=30)

        proc, port = start()               # fresh process, same dir
        rc = RemoteCluster("127.0.0.1", port)
        try:
            async def check(tr):
                rows = await tr.get_range(b"dur", b"dus")
                assert len(rows) == 30, len(rows)
                tr.set(b"post", b"1")
            rc.call(run_transaction(rc.db, check))
        finally:
            rc.close()
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_monitor_restarts_crashed_server(tmp_path):
    """fdbmonitor analogue: the supervisor restarts a killed server
    process with backoff, and — thanks to --data-dir — the restarted
    child serves the same database (ref: fdbmonitor.cpp spawn/restart
    loop)."""
    import os
    import signal

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    data = str(tmp_path / "mondata")
    port = _free_port()

    mon = subprocess.Popen(
        [sys.executable, "-m", "foundationdb_tpu_torch.tools.monitor",
         "--port", str(port), "--seed", "89", "--data-dir", data],
        stdout=subprocess.PIPE, text=True, env=env)
    try:
        def wait_listening():
            while True:
                line = mon.stdout.readline()
                assert line, "monitor died"
                if "LISTENING" in line:
                    return

        wait_listening()
        rc = RemoteCluster("127.0.0.1", port)
        try:
            async def write(tr):
                tr.set(b"monitored", b"yes")
            rc.call(run_transaction(rc.db, write))
        finally:
            rc.close()

        # find and kill the CHILD server process
        out = subprocess.run(
            ["pgrep", "-f", f"tools.server --port {port}"],
            capture_output=True, text=True)
        pids = [int(p) for p in out.stdout.split()]
        assert pids, "no child server found"
        for pid in pids:
            os.kill(pid, signal.SIGKILL)

        wait_listening()   # the monitor restarted it
        rc = RemoteCluster("127.0.0.1", port, connect_timeout=60)
        try:
            async def check(tr):
                assert await tr.get(b"monitored") == b"yes"
                tr.set(b"post-crash", b"1")
            rc.call(run_transaction(rc.db, check))
        finally:
            rc.close()
    finally:
        mon.send_signal(signal.SIGINT)
        try:
            mon.wait(timeout=30)
        except subprocess.TimeoutExpired:
            mon.kill()


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_remote_watch_fires_over_the_gateway():
    """A watch armed by one remote client fires when another remote
    transaction changes the key — the long-poll forwarding path (ref:
    storage watches reaching external clients through FlowTransport)."""
    import foundationdb_tpu_torch.flow as fl

    with GatewayedCluster(seed=818) as gc:
        rc = RemoteCluster("127.0.0.1", gc.port)
        try:
            async def arm():
                tr = rc.db.create_transaction()
                await tr.get(b"watched")
                w = tr.watch(b"watched")
                await tr.commit()
                return w
            w = rc.call(arm())

            async def write(tr):
                tr.set(b"watched", b"changed")
            rc.call(run_transaction(rc.db, write))

            async def await_watch():
                return await fl.timeout_error(w, 30.0)
            rc.call(await_watch())   # raises timed_out if never fired
        finally:
            rc.close()


def test_cluster_file_roundtrip(tmp_path):
    """fdb.cluster format (ref: MonitorLeader.actor.cpp:185 parsing
    tests): parse/write round-trip, comment tolerance, validation, and
    the CLI dialing a server through --cluster-file."""
    from foundationdb_tpu_torch.client.cluster_file import (
        ClusterConnectionString, parse_connection_string,
        read_cluster_file, resolve_connect, write_cluster_file)

    conn = parse_connection_string(
        "# a comment\n  mydb:abc123@10.0.0.1:4500,10.0.0.2:4501\n")
    assert conn.description == "mydb"
    assert conn.cluster_id == "abc123"
    assert conn.addresses == (("10.0.0.1", 4500), ("10.0.0.2", 4501))
    assert str(conn) == "mydb:abc123@10.0.0.1:4500,10.0.0.2:4501"

    path = str(tmp_path / "fdb.cluster")
    write_cluster_file(path, conn)
    assert read_cluster_file(path) == conn
    assert resolve_connect(None, path) == ("10.0.0.1", 4500)
    assert resolve_connect("h:9", path) == ("h", 9)  # --connect wins
    assert resolve_connect(None, None) is None

    import pytest as _pytest
    for bad in ("nope", "a:b", "db:id@", "db:id@host:notaport",
                "db/x:id@h:1", "one:1@h:1\ntwo:2@h:2"):
        with _pytest.raises(ValueError):
            parse_connection_string(bad)

    # e2e: server writes the file; the CLI dials through it
    import subprocess
    import sys as _sys
    cf = str(tmp_path / "live.cluster")
    proc = subprocess.Popen(
        [_sys.executable, "-m", "foundationdb_tpu_torch.tools.server",
         "--port", "0", "--cluster-file", cf],
        stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("LISTENING"), line
        out = subprocess.run(
            [_sys.executable, "-m", "foundationdb_tpu_torch.tools.cli",
             "--cluster-file", cf, "--exec", "set cf works; get cf"],
            capture_output=True, text=True, timeout=120)
        assert "works" in out.stdout, (out.stdout, out.stderr)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
