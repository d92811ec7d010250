"""Nothing under portbench/ imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "foundationdb_tpu"}


def sources(sub=""):
    for d, _dirs, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and \
                node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()))
def test_no_jax_import(path):
    assert not set(top_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")))
def test_reference_imports_nothing_of_the_port(path):
    assert "foundationdb_tpu_torch" not in set(top_imports(path))


def test_loaded_modules():
    code = ("import sys; import portbench.run, portbench.harness, "
            "portbench.control, portbench.reference.resolver; "
            "from portbench import harness; "
            "[harness.metric_reader(m['name']) "
            " for m in harness.benchmark()['per_layer']]; "
            "import foundationdb_tpu_torch.models, "
            "foundationdb_tpu_torch.parallel; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN
    ref = ("import sys; import portbench.reference.resolver; "
           "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", ref], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert "foundationdb_tpu_torch" not in eval(out.strip().splitlines()[-1])
