"""The port stands alone: no module of foundationdb_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package (scanned by AST and
checked at run time in a fresh interpreter), and the CUDA backend asked
for with no device raises on a host without a card instead of running
on the CPU."""

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
    assert os.path.join(PKG, "models", "cuda_resolver.py") in sources
    bad = {os.path.relpath(p, ROOT): sorted(set(_imported_roots(p))
                                            & FORBIDDEN)
           for p in sources}
    assert {p: m for p, m in bad.items() if m} == {}


def test_port_import_loads_no_jax():
    code = ("import sys\n"
            "import foundationdb_tpu_torch.models.cuda_resolver\n"
            "import foundationdb_tpu_torch.ops.conflict_kernel\n"
            "import foundationdb_tpu_torch.models\n"
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
    with pytest.raises(device.NoCudaDeviceError):
        create_conflict_set("cuda")
    with pytest.raises(device.NoCudaDeviceError):
        device.resolve(None)
    assert device.resolve("cpu").type == "cpu"
