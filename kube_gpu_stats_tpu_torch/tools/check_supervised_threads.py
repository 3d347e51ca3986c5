"""Lint: every thread in the port's package is born through the
supervised spawn helper.

The port's copy of the reference's ``tools/check_supervised_threads.py``.
A thread created outside :func:`kube_gpu_stats_tpu_torch.supervisor.spawn`
escapes the one-birthplace discipline — it may be unnamed, non-daemonic
(wedging process exit on a stuck backend), and nothing forces its owner
to think about liveness/restart. The runtime can't enforce this
(threading.Thread is the stdlib), so this lint catches it at lint time:

- ``threading.Thread(...)`` / ``Thread(...)`` call sites anywhere in
  ``kube_gpu_stats_tpu_torch/`` fail, EXCEPT in ``supervisor.py`` (the
  helper's home — the one real constructor call lives there) and in the
  allow-listed directories below.
- Subclassing ``threading.Thread`` fails too — it is the same escape
  hatch with a class statement in front.

The allow-list is the reference's (``supervisor.py``, ``testing/``: test
doubles build fixture servers and sockets, not production workers) plus
``sims/``, ``tools/`` and ``deploy/``: the sims drive threads
deliberately (storms of readers and pushers) and were the reference's
``tools/*_sim.py``, outside its scanned package, as its tools and its
deploy/ builders are.

Run: ``python -m kube_gpu_stats_tpu_torch.tools.check_supervised_threads``
(exit 0 clean, 1 with one line per finding).
"""

from __future__ import annotations

import ast
import pathlib
import sys

PACKAGE = pathlib.Path(__file__).resolve().parent.parent
ROOT = PACKAGE.parent

# Files allowed to touch threading.Thread directly:
# - supervisor.py IS the helper (spawn() wraps the constructor)
# - testing/ holds test doubles (fake NVML, egress sinks, the faultfs
#   socket proxies) that never ship in the daemon
# - sims/, tools/ and deploy/ were outside the reference's scanned
#   package (its tools/*_sim.py, tools/ and deploy/)
ALLOW_FILES = {"supervisor.py"}
ALLOW_DIRS = {"testing", "sims", "tools", "deploy"}


def _is_thread_ref(node: ast.expr) -> bool:
    """threading.Thread / Thread (imported name) references."""
    if isinstance(node, ast.Attribute) and node.attr == "Thread":
        return isinstance(node.value, ast.Name) and \
            node.value.id == "threading"
    if isinstance(node, ast.Name) and node.id == "Thread":
        return True
    return False


def check_file(path: pathlib.Path) -> list[str]:
    try:
        tree = ast.parse(path.read_text(encoding="utf-8"))
    except SyntaxError as exc:
        return [f"{path}: unparseable ({exc})"]
    try:
        rel = path.relative_to(ROOT)
    except ValueError:
        rel = path
    problems: list[str] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_thread_ref(node.func):
            problems.append(
                f"{rel}:{node.lineno}: bare threading.Thread(...) — "
                f"create package threads through supervisor.spawn() "
                f"(one birthplace, supervised or deliberately "
                f"short-lived)")
        elif isinstance(node, ast.ClassDef) and \
                any(_is_thread_ref(base) for base in node.bases):
            problems.append(
                f"{rel}:{node.lineno}: class {node.name} subclasses "
                f"threading.Thread — same escape hatch; compose with "
                f"supervisor.spawn() instead")
    return problems


def main() -> int:
    problems: list[str] = []
    for path in sorted(PACKAGE.rglob("*.py")):
        rel_parts = path.relative_to(PACKAGE).parts
        if path.name in ALLOW_FILES or rel_parts[0] in ALLOW_DIRS:
            continue
        problems.extend(check_file(path))
    for problem in problems:
        print(problem, file=sys.stderr)
    if problems:
        print("fix: from .supervisor import spawn; "
              "thread = spawn(target, name=...); thread.start()",
              file=sys.stderr)
        return 1
    print("check_supervised_threads: every package thread is born "
          "through supervisor.spawn()")
    return 0


if __name__ == "__main__":
    sys.exit(main())
