"""The port imports neither JAX nor anything of kube_gpu_stats_tpu.

Checked twice: in a fresh subprocess (tests/conftest.py imports JAX in
this one) that imports every module of the port and inspects
sys.modules, and statically over every import statement of the port's
sources and chip_smoke.py.
"""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "kube_gpu_stats_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    # Exact names or dotted children only: kube_gpu_stats_tpu_torch itself
    # starts with the string "kube_gpu_stats_tpu".
    return any(module == banned or module.startswith(banned + ".")
               for banned in ("jax", "kube_gpu_stats_tpu"))


@pytest.mark.parametrize("name,expected", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", False),
    ("kube_gpu_stats_tpu", True), ("kube_gpu_stats_tpu.loadgen", True),
    ("kube_gpu_stats_tpu_torch", False),
    ("kube_gpu_stats_tpu_torch.loadgen", False),
])
def test_forbidden_matches_exact_names(name, expected):
    assert _forbidden(name) == expected


_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import kube_gpu_stats_tpu_torch as port
names = [port.__name__]
for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    if not info.name.endswith("__main__"):  # __main__ runs the CLI
        names.append(info.name)
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""


def test_importing_the_port_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "kube_gpu_stats_tpu_torch.loadgen.tiled_burn" in report["imported"]
    assert [m for m in report["loaded"] if _forbidden(m)] == []


def _imported_modules(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_import_statement_names_jax_or_the_reference(path):
    assert [m for m in _imported_modules(path) if _forbidden(m)] == []
