"""What the benchmark may import: nothing under benchmark/ imports JAX or the
JAX package, and the reference imports nothing of the port. Top-level module
names are compared whole (`polaris_tpu_torch` begins with `polaris_tpu`)."""

import ast
import os
import subprocess
import sys

from conftest import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "polaris_tpu"}


def imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def sources(root):
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def test_no_jax_anywhere():
    for path in sources(BENCH):
        assert not imported_roots(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for sub in ("reference", "roofline"):
        for path in sources(os.path.join(BENCH, sub)):
            assert "polaris_tpu_torch" not in imported_roots(path), path


def test_reference_loads_no_port_module():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import reference.pathtracer, reference.scene, reference.adam, roofline.probe, roofline.bound\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'polaris_tpu', 'polaris_tpu_torch'})\n"
        "print(bad); sys.exit(1 if bad else 0)\n" % (BENCH, REPO)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_forbidden_check_compares_whole_names():
    from harness.device import forbidden_loaded

    assert forbidden_loaded({"polaris_tpu_torch": 1, "polaris_tpu_torch.ops": 1}) == []
    assert forbidden_loaded({"polaris_tpu.render": 1, "jaxlib": 1}) == ["jaxlib", "polaris_tpu"]
