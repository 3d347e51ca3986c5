"""No module of the harness imports JAX or the JAX package: each import's
top-level name (before the first dot) compared whole, so the port, whose
name begins with the JAX package's, passes."""

from __future__ import annotations

import ast

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "kube_gpu_stats_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_harness_module_imports_jax_or_the_jax_package():
    modules = sorted((ROOT / "h100bench").rglob("*.py"))
    assert len(modules) > 10
    found = {(str(path.relative_to(ROOT)), name)
             for path in modules for name in _imports(path)
             if name.split(".", 1)[0] in FORBIDDEN}
    assert found == set()


def test_the_port_is_not_mistaken_for_the_jax_package():
    names = ["kube_gpu_stats_tpu_torch.loadgen", "kube_gpu_stats_tpu.bench"]
    assert [n for n in names if n.split(".", 1)[0] in FORBIDDEN] == [
        "kube_gpu_stats_tpu.bench"]
