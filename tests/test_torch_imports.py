"""ursabench_tpu_torch and chip_smoke.py import with JAX and flax blocked:
the machine with the GPU has no JAX."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "ursabench_tpu_torch"

_IMPORT_ALL = """
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import importlib, pkgutil
import ursabench_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ursabench_tpu_torch.__path__,
                                              "ursabench_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_reference_package_imports_in_port_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "flax", "optax", "ursabench_tpu"}, path
