"""The port stands alone: no module of foundationdb_tpu_torch (the data
plane, and the flow runtime, `rpc` and `server` modules, the storage
and log engines' lazy imports included), and not
chip_smoke.py, imports JAX or the JAX package (scanned by AST and
checked at run time in a fresh interpreter), and the CUDA backends and
the resolver role asked for with no device raise on a host without a
card instead of running on the CPU."""

import ast
import os
import subprocess
import sys

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
                                  "storage", "tlog"))):
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
