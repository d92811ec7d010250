"""The port stands alone: no module of foundationdb_tpu_torch (the data
plane, and the flow runtime, `rpc`, `server` and `client` modules, the
storage and log engines' lazy imports included, and the cluster with
its control plane), and not chip_smoke.py, imports JAX or the JAX
package (scanned by AST and checked at run time in a fresh
interpreter), and the CUDA backends, the resolver role and the cluster
asked for with no device raise on a host without a card instead of
running on the CPU. A device fault that outlasts the failover
wrapper's retries fails the cluster's run instead of being absorbed by
a recovery. A remote region carries its cluster's device and fatal
hook: at device="cpu" it promotes without asking for a card, and a
device fault in its promoted resolver fails the run. The server process
(`tools.server`) switched to `cuda` on a host without a card exits
nonzero naming NoCudaDeviceError, its monitor restarts it into the same
failure, and `serve` lets a device fault past the retries end it; with
`--device cpu` it commits. The monitor spawns the port's server, and
the port's server, monitor and CLI children serve, restart and answer
with a `foundationdb_tpu` first on their path whose import raises. A
role host (`tools.rolehost`) recruited on `cuda` without a card exits
nonzero naming NoCudaDeviceError, `RoleProcs.check_ready` raises with
it, and its respawn fails the same way; the soak on `cuda` without a
card fails with it; `smoke --faults` recovers every fault on the device
(no failover) and at the reference's seed fails with DeviceFaultError;
the port's tools spawn the port's role hosts and workers, which serve
with the unimportable `foundationdb_tpu` first on their path."""

import ast
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "foundationdb_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "foundationdb_tpu"}


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax():
    sources = _port_sources()
    for mod in ("cuda_resolver.py", "point_resolver.py", "failover.py"):
        assert os.path.join(PKG, "models", mod) in sources
    for sub, mods in (("flow", ("error", "future", "scheduler", "actors",
                                "smoother", "coverage", "threadpool")),
                      ("rpc", ("wire", "disk", "network")),
                      ("server", ("types", "wire", "critical_path",
                                  "resolver_role", "atomic",
                                  "replication_policy", "diskqueue",
                                  "kvstore", "btree", "chaos", "proxy",
                                  "storage", "tlog", "systemkeys",
                                  "dbinfo", "coordination", "admission",
                                  "repair", "scheduler", "tag_throttler",
                                  "ratekeeper", "master",
                                  "process_metrics", "sim_validation",
                                  "worker", "cluster_controller",
                                  "cluster")),
                      ("client", ("profiling", "transaction",
                                  "cluster_file", "remote")),
                      ("rpc", ("tcp", "gateway")),
                      ("layers", ("__init__", "tuple_layer", "subspace",
                                  "directory", "taskbucket", "backup",
                                  "backup_agent", "backup_container",
                                  "backup_driver", "clientlog", "metrics",
                                  "pubsub", "queue")),
                      ("tools", ("__init__", "_tlsargs", "networktest",
                                 "server", "monitor", "profiler",
                                 "backup_tool", "cli", "rolehost",
                                 "clusterbench", "exporter", "tracemerge",
                                 "incident", "simprof", "soak", "smoke")),
                      ("bindings", ("__init__", "c_client",
                                    "multiversion"))):
        for mod in mods:
            assert os.path.join(PKG, sub, f"{mod}.py") in sources
    assert os.path.join(PKG, "parallel", "sharded_resolver.py") in sources
    bad = {os.path.relpath(p, ROOT): sorted(set(_imported_roots(p))
                                            & FORBIDDEN)
           for p in sources}
    assert {p: m for p, m in bad.items() if m} == {}


def test_port_import_loads_no_jax():
    code = ("import sys\n"
            "import foundationdb_tpu_torch.models.cuda_resolver\n"
            "import foundationdb_tpu_torch.ops.conflict_kernel\n"
            "import foundationdb_tpu_torch.ops.point_kernel\n"
            "import foundationdb_tpu_torch.models.point_resolver\n"
            "import foundationdb_tpu_torch.models.failover\n"
            "import foundationdb_tpu_torch.parallel\n"
            "import foundationdb_tpu_torch.models\n"
            "import foundationdb_tpu_torch.flow\n"
            "import foundationdb_tpu_torch.flow.threadpool\n"
            "import foundationdb_tpu_torch.rpc\n"
            "import foundationdb_tpu_torch.rpc.wire\n"
            "import foundationdb_tpu_torch.server\n"
            "import foundationdb_tpu_torch.server.wire\n"
            "import foundationdb_tpu_torch.server.critical_path\n"
            "import foundationdb_tpu_torch.server.resolver_role\n"
            "import foundationdb_tpu_torch.server.atomic\n"
            "import foundationdb_tpu_torch.server.replication_policy\n"
            "import foundationdb_tpu_torch.server.diskqueue\n"
            "import foundationdb_tpu_torch.server.kvstore\n"
            "import foundationdb_tpu_torch.server.btree\n"
            "import foundationdb_tpu_torch.server.chaos\n"
            "import foundationdb_tpu_torch.server.proxy\n"
            "import foundationdb_tpu_torch.server.storage\n"
            "import foundationdb_tpu_torch.server.tlog\n"
            "import foundationdb_tpu_torch.server.cluster\n"
            "import foundationdb_tpu_torch.client\n"
            "from foundationdb_tpu_torch.server import SimCluster\n"
            "import foundationdb_tpu_torch.rpc.gateway\n"
            "import foundationdb_tpu_torch.client.remote\n"
            "import foundationdb_tpu_torch.layers.backup_driver\n"
            "import foundationdb_tpu_torch.layers.clientlog\n"
            "import foundationdb_tpu_torch.layers.metrics\n"
            "import foundationdb_tpu_torch.layers.pubsub\n"
            "import foundationdb_tpu_torch.layers.queue\n"
            "import foundationdb_tpu_torch.tools.server\n"
            "import foundationdb_tpu_torch.tools.monitor\n"
            "import foundationdb_tpu_torch.tools.cli\n"
            "import foundationdb_tpu_torch.tools.backup_tool\n"
            "import foundationdb_tpu_torch.tools.profiler\n"
            "import foundationdb_tpu_torch.tools.networktest\n"
            "import foundationdb_tpu_torch.tools.rolehost\n"
            "import foundationdb_tpu_torch.tools.clusterbench\n"
            "import foundationdb_tpu_torch.tools.exporter\n"
            "import foundationdb_tpu_torch.tools.tracemerge\n"
            "import foundationdb_tpu_torch.tools.incident\n"
            "import foundationdb_tpu_torch.tools.simprof\n"
            "import foundationdb_tpu_torch.tools.soak\n"
            "import foundationdb_tpu_torch.tools.smoke\n"
            "import foundationdb_tpu_torch.bindings\n"
            "import foundationdb_tpu_torch.bindings.c_client\n"
            "import foundationdb_tpu_torch.bindings.multiversion\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            f" & set({sorted(FORBIDDEN)!r})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cuda_backend_without_card_raises(monkeypatch):
    from foundationdb_tpu_torch import device
    from foundationdb_tpu_torch.models import create_conflict_set
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("cuda", "cuda-point", "sharded-cuda"):
        with pytest.raises(device.NoCudaDeviceError):
            create_conflict_set(backend)
    with pytest.raises(device.NoCudaDeviceError):
        device.resolve(None)
    assert device.resolve("cpu").type == "cpu"


def test_resolver_role_without_card_raises(monkeypatch):
    """The role's device defaults to the card: with none, a CUDA
    backend raises instead of resolving on the CPU."""
    from foundationdb_tpu_torch import device, flow
    from foundationdb_tpu_torch.rpc import SimNetwork
    from foundationdb_tpu_torch.server.resolver_role import Resolver
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sched = flow.Scheduler()
    flow.set_scheduler(sched)
    try:
        net = SimNetwork(sched, flow.g_random)
        for backend in ("cuda", "cuda-point", "sharded-cuda"):
            proc = net.new_process(f"resolver-{backend}")
            with pytest.raises(device.NoCudaDeviceError):
                Resolver(proc, backend)
        # the host backends have no card to ask for
        assert Resolver(net.new_process("py"), "python").version.get() == 0
    finally:
        flow.set_scheduler(None)


def test_cluster_without_card_raises_at_once(monkeypatch):
    """`SimCluster(conflict_backend="cuda")` asks for the card before it
    builds anything: on a host without one it raises NoCudaDeviceError
    at once, never a recruitment that every recovery retries."""
    from foundationdb_tpu_torch import device, flow
    from foundationdb_tpu_torch.server import SimCluster
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("cuda", "cuda-point", "sharded-cuda"):
        t0 = time.perf_counter()
        with pytest.raises(device.NoCudaDeviceError):
            SimCluster(seed=3, conflict_backend=backend)
        assert time.perf_counter() - t0 < 5.0
        assert flow.get_scheduler() is None


def test_switch_to_cuda_without_card_fails_run(monkeypatch):
    """A cluster whose operator switches the conflict backend to `cuda`
    through the `\xff/conf/` rows on a host without a card: the next
    recovery's recruitment raises NoCudaDeviceError, which stops the
    loop and fails `run` instead of failing recovery after recovery."""
    from foundationdb_tpu_torch import device, flow
    from foundationdb_tpu_torch.client import run_transaction
    from foundationdb_tpu_torch.server import SimCluster
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = SimCluster(seed=4)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set(b"k", b"v")
            await run_transaction(db, body)
            await db.configure(conflict_backend="cuda")
            while True:    # commits until the run is stopped
                await run_transaction(db, body)
                await flow.delay(0.1)

        t0 = time.perf_counter()
        with pytest.raises(device.NoCudaDeviceError):
            c.run(main(), timeout_time=600)
        assert time.perf_counter() - t0 < 60.0
        assert c.cc.dbinfo.get().epoch == 1
    finally:
        c.shutdown()
        flow.reset_server_knobs(randomize=False)


def test_device_fault_past_retries_fails_run():
    """Every device seam faults (DEVICE_FAULT_INJECTION = 1): the
    failover wrapper rebuilds DEVICE_FAULT_RETRIES times, then raises
    DeviceFaultError out of the resolver, which stops the loop; `run`
    raises it instead of a new epoch recruiting the same card again."""
    from foundationdb_tpu_torch import flow
    from foundationdb_tpu_torch.client import run_transaction
    from foundationdb_tpu_torch.ops.fault_injection import DeviceFaultError
    from foundationdb_tpu_torch.server import SimCluster
    c = SimCluster(seed=5, conflict_backend="cuda", device="cpu")
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set(b"k", b"v")
            await run_transaction(db, body)
            flow.SERVER_KNOBS.set("device_fault_injection", 1.0)
            while True:
                await run_transaction(db, body)

        t0 = time.perf_counter()
        with pytest.raises(DeviceFaultError):
            c.run(main(), timeout_time=600)
        assert time.perf_counter() - t0 < 60.0
        # no recovery absorbed it
        assert c.cc.dbinfo.get().epoch == 1
        assert int(flow.SERVER_KNOBS.device_fault_retries) >= 1
    finally:
        c.shutdown()
        flow.reset_server_knobs(randomize=False)


def test_region_promotes_on_cpu_without_card(monkeypatch):
    """A `cuda` cluster at device="cpu" attaches a remote region and
    promotes it on a host without a card: the region's workers and the
    promoted controller carry the cluster's device, so the second DC's
    resolver is built on the plain versions too, never asking for a
    card."""
    from foundationdb_tpu_torch import testing as tg
    from foundationdb_tpu_torch.server import resolver_role
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen = []
    start = resolver_role.Resolver.start

    def caught(self):
        seen.append(self.conflict_set.active.kernel_stats()["platform"])
        start(self)

    monkeypatch.setattr(resolver_role.Resolver, "start", caught)
    at_blackout = []
    P = tg.tester_package()
    try:
        out = tg.region_run(P, "cuda", tg.REGION_SEED,
                            cluster_kwargs={"device": "cpu"},
                            on_blackout=lambda c: at_blackout.append(
                                len(seen)))
    finally:
        P.flow.reset_server_knobs(randomize=False)
    assert out["promoted_epoch"] > out["epoch"]
    assert len(out["survived"]) >= tg.REGION_SHIPPED
    # the promotion recruited a resolver of its own, on the CPU
    assert at_blackout and len(seen) > at_blackout[0]
    assert set(seen) == {"cpu"}


def test_device_fault_in_promoted_resolver_fails_run():
    """Every device seam faults from the blackout on: the promoted
    region's resolver rebuilds DEVICE_FAULT_RETRIES times, then raises
    DeviceFaultError into the cluster's fatal hook, which stops the
    loop; `run` raises it instead of the region retrying its recovery
    for ever."""
    from foundationdb_tpu_torch import testing as tg
    from foundationdb_tpu_torch.ops.fault_injection import DeviceFaultError
    P = tg.tester_package()
    at_blackout = []

    def arm(c):
        at_blackout.append(P.flow.now())
        P.flow.SERVER_KNOBS.set("device_fault_injection", 1.0)

    t0 = time.perf_counter()
    try:
        with pytest.raises(DeviceFaultError):
            tg.region_run(P, "cuda", tg.REGION_SEED,
                          cluster_kwargs={"device": "cpu"},
                          on_blackout=arm)
    finally:
        P.flow.reset_server_knobs(randomize=False)
    assert at_blackout, "the fault must come after the blackout"
    assert time.perf_counter() - t0 < 60.0
    assert int(P.flow.SERVER_KNOBS.device_fault_retries) >= 1


# -- the server process, its monitor and the CLI --------------------------

def _child_env(path_first=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT if path_first is None else \
        path_first + os.pathsep + ROOT
    return env


def _cli(args, cwd=ROOT, env=None, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "foundationdb_tpu_torch.tools.cli", *args],
        cwd=cwd, env=env or _child_env(), capture_output=True, text=True,
        timeout=timeout)


def _until(proc, pred, what, timeout=120.0):
    """Read `proc`'s stdout lines until `pred(line)`; returns the lines."""
    import queue
    import threading
    lines = getattr(proc, "_lines", None)
    if lines is None:
        lines = proc._lines = queue.Queue()

        def pump():
            for line in proc.stdout:
                lines.put(line)
            lines.put(None)
        threading.Thread(target=pump, daemon=True).start()
    seen = []
    deadline = time.monotonic() + timeout
    while True:
        try:
            line = lines.get(timeout=max(deadline - time.monotonic(), 0.01))
        except queue.Empty:
            raise AssertionError(f"no {what} in {timeout} s: {seen}")
        if line is None:
            raise AssertionError(f"exited before {what}: {seen}")
        seen.append(line)
        if pred(line):
            return seen


def _stop(proc):
    import signal
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def test_server_switched_to_cuda_without_card_exits(tmp_path):
    """A port server at the default device on a host without a card
    serves on `python`; `configure conflict_backend=cuda` through the
    CLI makes the next recovery ask for the card, and the server exits
    nonzero with NoCudaDeviceError on its stderr. Its monitor restarts
    it on the same data directory into the same failure, never on the
    CPU: the restarted server reads the stored conf row back before it
    opens its gateway, so it fails without printing LISTENING. A child
    that hangs instead has its threads' stacks dumped (faulthandler)
    into the stderr the failure prints."""
    import signal
    err = open(tmp_path / "monitor.err", "w")
    cf = str(tmp_path / "fdb.cluster")
    env = _child_env()
    env["PYTHONFAULTHANDLER"] = "1"
    mon = subprocess.Popen(
        [sys.executable, "-m", "foundationdb_tpu_torch.tools.monitor",
         "--port", "0", "--seed", "31", "--data-dir", str(tmp_path / "d"),
         "--cluster-file", cf],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        _until(mon, lambda l: "LISTENING" in l, "LISTENING")
        out = _cli(["-C", cf, "--exec", "set k v; configure "
                    "conflict_backend=cuda"])
        assert "Committed" in out.stdout, (out.stdout, out.stderr)
        for n in range(2):   # the switch, then the restart into it
            try:
                seen = _until(mon, lambda l: "child exited rc=" in l
                              and "rc=0" not in l, "a failed child")
            except AssertionError as e:
                for pid in _server_pids(mon.pid):
                    os.kill(pid, signal.SIGABRT)
                time.sleep(2.0)
                err.flush()
                raise AssertionError(
                    f"{e}; child {n}, monitor stderr:\n"
                    + (tmp_path / "monitor.err").read_text()[-6000:])
            if n == 1:
                assert not any("LISTENING" in l for l in seen), seen
    finally:
        _stop(mon)
        err.close()
    text = (tmp_path / "monitor.err").read_text()
    assert text.count("NoCudaDeviceError") >= 2, text[-2000:]


def _server_pids(ppid):
    """Pids of `ppid`'s children that run the port's server."""
    out = subprocess.run(["pgrep", "-f", "-P", str(ppid),
                          "foundationdb_tpu_torch.tools.server"],
                         capture_output=True, text=True).stdout
    return [int(p) for p in out.split()]


def test_serve_lets_device_fault_end_it():
    """`serve` catches only KeyboardInterrupt: with the resolver on
    `cuda` at device="cpu" and every device seam faulting, the failover
    wrapper's retries run out and DeviceFaultError ends `serve`."""
    import queue
    import threading
    from foundationdb_tpu_torch import flow
    from foundationdb_tpu_torch.client.remote import RemoteCluster
    from foundationdb_tpu_torch.ops.fault_injection import DeviceFaultError
    from foundationdb_tpu_torch.tools.server import serve
    ports, ended = queue.Queue(), queue.Queue()

    def host():
        try:
            serve(port=0, seed=33, device="cpu", backup_agent=False,
                  announce=lambda m, flush=True: ports.put(int(m.split()[1])))
            ended.put(None)
        except BaseException as e:  # noqa: BLE001 — what ended serve
            ended.put(e)

    t = threading.Thread(target=host, daemon=True)
    t.start()
    try:
        port = ports.get(timeout=120)
        rc = RemoteCluster("127.0.0.1", port)
        try:
            rc.call(rc.db.configure(conflict_backend="cuda"), timeout=120)
            flow.SERVER_KNOBS.set("device_fault_injection", 1.0)

            async def body(tr):
                tr.set(b"k", b"v")
            from foundationdb_tpu_torch.client import run_transaction
            for _ in range(100):    # commits until serve has ended
                if not t.is_alive():
                    break
                try:
                    rc.call(run_transaction(rc.db, body, max_retries=5),
                            timeout=2)
                except flow.FdbError:
                    pass
        finally:
            rc.close()
        e = ended.get(timeout=120)
        assert isinstance(e, DeviceFaultError), repr(e)
    finally:
        flow.reset_server_knobs(randomize=False)
        t.join(timeout=60)


def test_server_on_cpu_device_commits_on_cuda(tmp_path):
    """The same switch with `--device cpu`: the resolver is recruited
    on the plain versions, the status shows `cuda` on the CPU, and the
    server goes on committing; `--knob_kernel_profile_every 1` times
    every resolve step after the first. Killed and restarted on its
    data directory, the server prints LISTENING only once the epoch
    recruited with the stored `cuda` row is fully recovered, and the
    write is read back."""
    import signal
    from foundationdb_tpu_torch.client import run_transaction
    from foundationdb_tpu_torch.client.remote import RemoteCluster
    args = [sys.executable, "-m", "foundationdb_tpu_torch.tools.server",
            "--port", "0", "--seed", "32", "--device", "cpu",
            "--data-dir", str(tmp_path / "d"),
            "--knob_kernel_profile_every", "1"]

    def start():
        srv = subprocess.Popen(args, cwd=ROOT, env=_child_env(),
                               stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
        port = int(_until(srv, lambda l: l.startswith("LISTENING"),
                          "LISTENING")[-1].split()[1])
        return srv, RemoteCluster("127.0.0.1", port)

    def on_cuda(st):
        kern = [r["kernel"] for r in st["resolvers"] if r.get("kernel")]
        return st["recovery_state"] == "fully_recovered" \
            and st["configuration"]["conflict_backend"] == "cuda" \
            and [k["platform"] for k in kern] == ["cpu"]

    async def read(tr):
        return await tr.get(b"after")

    srv, rc = start()
    try:
        rc.call(rc.db.configure(conflict_backend="cuda"), timeout=120)

        async def body(tr):
            tr.set(b"after", b"switch")
        for _ in range(60):
            rc.call(run_transaction(rc.db, body), timeout=60)
            st = rc.call(rc.db.get_status(), timeout=60)["cluster"]
            if on_cuda(st):
                break
            time.sleep(0.2)
        assert on_cuda(st), st["resolvers"]
        for _ in range(3):
            rc.call(run_transaction(rc.db, body), timeout=60)
        assert rc.call(run_transaction(rc.db, read)) == b"switch"
        kern = rc.call(rc.db.get_status(), timeout=60)["cluster"]["kernels"]
        stat = {s: sum(v for k, v in kern.items()
                       if k.startswith("resolve_packed[")
                       and k.endswith(f".{s}"))
                for s in ("calls", "timed_calls", "compiles")}
        assert stat["calls"] > 1, kern
        assert stat["timed_calls"] + stat["compiles"] == stat["calls"], stat
        rc.close()
        assert srv.poll() is None
        os.kill(srv.pid, signal.SIGKILL)
        srv.wait(timeout=30)

        srv, rc = start()
        st = rc.call(rc.db.get_status(), timeout=60)["cluster"]
        assert on_cuda(st), (st["recovery_state"], st["configuration"],
                             st["resolvers"])
        assert rc.call(run_transaction(rc.db, read)) == b"switch"
    finally:
        rc.close()
        srv.terminate()
        srv.wait(timeout=30)


def test_server_refuses_an_unknown_knob(capsys):
    """`--knob_<name>` names a SERVER_KNOBS entry; any other name ends
    `main` with exit code 2 before a cluster is built."""
    from foundationdb_tpu_torch.tools import server
    assert server.main(["--knob_no_such_knob", "1"]) == 2
    assert "unknown knob no_such_knob" in capsys.readouterr().err
    assert server._knob_value("7") == 7
    assert server._knob_value("0.25") == 0.25
    assert server._knob_value("memory") == "memory"


def test_monitor_spawns_the_ports_server(monkeypatch):
    """The monitor's command line names foundationdb_tpu_torch's
    server, with the server's flags (`--device` among them) as given."""
    from foundationdb_tpu_torch.tools import monitor
    cmds = []

    class Child:
        stdout = iter(())

        def wait(self):
            return 1

    def popen(cmd, **kw):
        cmds.append(cmd)
        return Child()

    monkeypatch.setattr(monitor.subprocess, "Popen", popen)
    monkeypatch.setattr(monitor.time, "sleep", lambda s: None)
    args = ["--port", "4500", "--device", "cpu"]
    assert monitor.supervise(args, max_restarts=1,
                             announce=lambda *a, **k: None) == 1
    assert len(cmds) == 2
    for cmd in cmds:
        assert cmd[1:3] == ["-m", "foundationdb_tpu_torch.tools.server"]
        assert cmd[3:] == args


def test_children_run_with_the_reference_unimportable(tmp_path):
    """A `foundationdb_tpu` whose import raises stands first on the
    children's path: the port's monitor starts its server, the CLI
    commits and reads through the cluster file, the server is killed,
    the monitor restarts it, and the CLI reads the write back."""
    import signal
    poison = tmp_path / "poison"
    (poison / "foundationdb_tpu").mkdir(parents=True)
    (poison / "foundationdb_tpu" / "__init__.py").write_text(
        "raise ImportError('the reference must not be imported')\n")
    env = _child_env(str(poison))
    cf = str(tmp_path / "fdb.cluster")
    mon = subprocess.Popen(
        [sys.executable, "-m", "foundationdb_tpu_torch.tools.monitor",
         "--port", "0", "--seed", "34", "--data-dir", str(tmp_path / "d"),
         "--cluster-file", cf],
        cwd=str(poison), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        lines = _until(mon, lambda l: "LISTENING" in l, "LISTENING")
        assert any("foundationdb_tpu_torch.tools.server" in l
                   for l in lines if "MONITOR starting" in l), lines
        out = _cli(["-C", cf, "--exec", "set iso lated; get iso"],
                   cwd=str(poison), env=env)
        assert "`iso' is `lated'" in out.stdout, (out.stdout, out.stderr)
        os.kill(_server_pids(mon.pid)[0], signal.SIGKILL)
        _until(mon, lambda l: "child exited" in l, "the child's exit")
        _until(mon, lambda l: "LISTENING" in l, "LISTENING again")
        out = _cli(["-C", cf, "--exec", "get iso"], cwd=str(poison),
                   env=env)
        assert "`iso' is `lated'" in out.stdout, (out.stdout, out.stderr)
    finally:
        _stop(mon)
    assert "must not be imported" not in mon.stderr.read()


# -- role hosts, the soak, the smoke, and the tools' children --------------

def _wall(body, timeout=180.0):
    """Run `body()` on a wall-clock scheduler (the role tests' harness)."""
    from foundationdb_tpu_torch import flow
    flow.set_seed(0)
    s = flow.Scheduler(virtual=False)
    flow.set_scheduler(s)
    try:
        return s.run(until=s.spawn(body()), timeout_time=timeout)
    finally:
        flow.set_scheduler(None)


def _failed_ready(roles, ext=None, recruit=False, timeout=120.0):
    """Poll the resolver host until `check_ready` raises (recruiting it
    on `cuda` first when asked); returns the error's text."""
    from foundationdb_tpu_torch import flow

    async def body():
        if recruit:
            flow.spawn(ext.recruit_resolver(0, "nocard-r0", 0, "cuda"))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                roles.check_ready("resolver", 0)
            except RuntimeError as e:
                return str(e)
            await flow.delay(0.05)
        raise AssertionError("the role host neither failed nor exited")

    return _wall(body, timeout + 30)


def test_role_host_on_cuda_without_card_exits(tmp_path):
    """A resolver role host at the default device, recruited on `cuda`
    on a host without a card, exits nonzero with NoCudaDeviceError in
    its log, and `RoleProcs.check_ready` raises naming it; its respawn
    (which finds the init record and recovers onto `cuda`) fails the
    same way, before it is ready. It never serves a verdict."""
    from foundationdb_tpu_torch.tools.clusterbench import RoleProcs
    roles = RoleProcs(n_resolvers=1, run_dir=str(tmp_path),
                      state_root=str(tmp_path / "state"), seed=61)
    ext = None
    try:
        roles.spawn_all().wait_ready(timeout=120)
        ext = roles.external_roles()
        first = _failed_ready(roles, ext, recruit=True)
        assert "NoCudaDeviceError" in first and "rc=1" in first, first
        assert roles.log_path("resolver", 0) in first, first
        roles.respawn("resolver", 0)
        again = _failed_ready(roles)
        assert "NoCudaDeviceError" in again and "rc=1" in again, again
        with pytest.raises(RuntimeError, match="NoCudaDeviceError"):
            roles.wait_ready(timeout=5)
    finally:
        if ext is not None:
            ext.close()
        roles.terminate_all()
    log = open(roles.log_path("resolver", 0)).read()
    assert log.count("NoCudaDeviceError: ") >= 2, log[-3000:]


def test_soak_on_cuda_without_card_fails(tmp_path):
    """The soak on a `cuda` cluster at the default device asks for the
    card before it spawns anything, and fails with NoCudaDeviceError."""
    from foundationdb_tpu_torch import device, flow
    from foundationdb_tpu_torch.tools.soak import run_soak
    with pytest.raises(device.NoCudaDeviceError):
        run_soak(processes=1, duration=2.0, kills=0, trace=False,
                 run_dir=str(tmp_path), backend="cuda", out=lambda *a: None)
    assert flow.get_scheduler() is None


def test_fault_smoke_recovers_on_the_device(monkeypatch):
    """`smoke --faults` at device="cpu", at the reference's seed and
    rate: every injected fault is recovered on a fresh device backend
    and none fails over. At a rate where every rebuild faults too, the
    smoke fails with DeviceFaultError instead of serving CPU
    verdicts."""
    from foundationdb_tpu_torch.ops.fault_injection import DeviceFaultError
    from foundationdb_tpu_torch.tools import smoke
    assert smoke.FAULTS_SEED == 4646
    lines = []
    assert smoke.run_smoke_faults(out=lines.append, device="cpu") == 0
    assert " 0 failovers" in lines[-1], lines
    assert " 0 recoveries" not in lines[-1], lines
    monkeypatch.setenv("DEVICE_FAULT_INJECTION", "1.0")
    with pytest.raises(DeviceFaultError, match="no CPU fallback"):
        smoke.run_smoke_faults(out=lines.append, device="cpu")


def test_tools_children_run_with_the_reference_unimportable(
        tmp_path, monkeypatch):
    """The port's clusterbench spawns the port's role hosts (a resolver
    and a tlog) and proxy workers, and they commit every arrival with a
    `foundationdb_tpu` whose import raises first on their path; the
    soak's workers do the same."""
    from foundationdb_tpu_torch.tools import clusterbench, soak
    poison = tmp_path / "poison"
    (poison / "foundationdb_tpu").mkdir(parents=True)
    (poison / "foundationdb_tpu" / "__init__.py").write_text(
        "raise ImportError('the reference must not be imported')\n")
    monkeypatch.setenv("PYTHONPATH", str(poison) + os.pathsep + ROOT)
    monkeypatch.chdir(poison)
    spawned = []
    real_popen = subprocess.Popen

    def popen(args, *a, **kw):
        spawned.append(list(args))
        return real_popen(args, *a, **kw)

    monkeypatch.setattr(subprocess, "Popen", popen)
    cell = clusterbench.run_tcp_cell(
        1, 1, seed=5, duration=1.5, rate=40.0,
        run_dir=str(tmp_path / "cell"), role_processes=True)
    assert cell["committed"] > 0 and cell["divergent_verdicts"] == 0, cell
    doc = soak.run_soak(processes=1, duration=3.0, rate=40.0, kills=0,
                        trace=False, run_dir=str(tmp_path / "soak"),
                        out=lambda *a: None)
    assert doc["totals"]["committed"] > 0, doc["totals"]
    assert doc["totals"]["divergent_verdicts"] == 0, doc["totals"]
    mods = {a[a.index("-m") + 1] for a in spawned if "-m" in a}
    assert mods == {"foundationdb_tpu_torch.tools.rolehost",
                    "foundationdb_tpu_torch.tools.clusterbench",
                    "foundationdb_tpu_torch.tools.soak"}, mods
    for d in ("cell", "soak"):
        for dirpath, _dirs, files in os.walk(tmp_path / d):
            for f in files:
                if f.endswith((".log", ".stderr")):
                    text = open(os.path.join(dirpath, f),
                                errors="replace").read()
                    assert "must not be imported" not in text, (f, text)

