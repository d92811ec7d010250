"""The port stands alone: no module of foundationdb_tpu_torch (the data
plane, and the flow runtime, `rpc`, `server` and `client` modules, the
storage and log engines' lazy imports included, and the cluster with
its control plane), and not chip_smoke.py, imports JAX or the JAX
package (scanned by AST and checked at run time in a fresh
interpreter), and the CUDA backends, the resolver role and the cluster
asked for with no device raise on a host without a card instead of
running on the CPU. A device fault that outlasts the failover
wrapper's retries fails the cluster's run instead of being absorbed by
a recovery."""

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
                      ("client", ("profiling", "transaction"))):
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
