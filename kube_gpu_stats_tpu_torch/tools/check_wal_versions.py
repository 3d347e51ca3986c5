"""Lint: every wal.py writer call site in the port stamps a format
version.

The port's copy of the reference's ``tools/check_wal_versions.py``. The
skew-survival contract only works if EVERY persisted format is versioned
at the writer: readers decide tolerate-vs-quarantine off the stamp, and
an unstamped file from one unlucky code path would be indistinguishable
from garbage on the next rolling upgrade. wal.py enforces this at runtime
(write_state raises on an unstamped dict; SegmentRing always writes its
container header), but a runtime raise on the checkpoint path is exactly
the crash-loop the quarantine design exists to avoid — so this lint
catches the miss before it ships:

- ``SegmentRing(...)`` call sites must pass ``format_version=`` — the
  caller's record-payload format, stamped into every segment's KTSG
  header and the ceiling its reader accepts.
- ``write_state(...)`` / ``wal.write_state(...)`` call sites must
  provably stamp the state dict: a dict literal with a ``version`` key
  (or the call's ``version_key``), a local function/method whose
  returned dict literal carries it, or a name assigned from either.
  When the state expression can't be traced (built dynamically), the
  enclosing module must at least contain SOME dict literal with the
  key — a conservative fallback; the runtime raise in write_state
  remains the precise backstop.

Scans the whole ``kube_gpu_stats_tpu_torch`` package. Run: ``python -m
kube_gpu_stats_tpu_torch.tools.check_wal_versions`` (exit 0 clean, 1
with one line per finding).
"""

from __future__ import annotations

import ast
import pathlib
import sys

PACKAGE = pathlib.Path(__file__).resolve().parent.parent
ROOT = PACKAGE.parent


def _call_name(node: ast.Call) -> str:
    func = node.func
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def _keyword(node: ast.Call, name: str) -> ast.expr | None:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _dict_has_key(node: ast.Dict, key: str) -> bool:
    return any(isinstance(k, ast.Constant) and k.value == key
               for k in node.keys)


def _returned_dicts(func: ast.FunctionDef) -> list[ast.Dict]:
    """Dict literals this function can return — directly, or through a
    name assigned a dict literal inside the function."""
    dicts: list[ast.Dict] = []
    assigned: dict[str, ast.Dict] = {}
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Dict):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    assigned[target.id] = node.value
    for node in ast.walk(func):
        if isinstance(node, ast.Return) and node.value is not None:
            if isinstance(node.value, ast.Dict):
                dicts.append(node.value)
            elif isinstance(node.value, ast.Name) and \
                    node.value.id in assigned:
                dicts.append(assigned[node.value.id])
    return dicts


class _ModuleIndex:
    """Per-module lookup tables the per-call checks resolve against."""

    def __init__(self, tree: ast.Module) -> None:
        # Every function/method by bare name (methods collide across
        # classes only if same-named — acceptable for a lint).
        self.functions: dict[str, ast.FunctionDef] = {}
        # Dict literals anywhere in the module that carry a given key
        # (the conservative fallback).
        self.dicts: list[ast.Dict] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.setdefault(node.name, node)  # type: ignore[arg-type]
            elif isinstance(node, ast.Dict):
                self.dicts.append(node)

    def module_has_stamped_dict(self, key: str) -> bool:
        return any(_dict_has_key(d, key) for d in self.dicts)


def _state_is_stamped(state: ast.expr, key: str, index: _ModuleIndex,
                      enclosing: ast.FunctionDef | None) -> bool:
    """Trace the write_state state argument to a version-stamped dict."""
    if isinstance(state, ast.Dict):
        return _dict_has_key(state, key)
    if isinstance(state, ast.Call):
        name = _call_name(state)
        func = index.functions.get(name)
        if func is not None:
            returned = _returned_dicts(func)
            if returned:
                return any(_dict_has_key(d, key) for d in returned)
    if isinstance(state, ast.Name) and enclosing is not None:
        for node in ast.walk(enclosing):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == state.id
                    for t in node.targets):
                if isinstance(node.value, (ast.Dict, ast.Call, ast.Name)) \
                        and node.value is not state:
                    if _state_is_stamped(node.value, key, index, enclosing):
                        return True
    # Untraceable: fall back to "the module stamps SOMETHING with this
    # key" — conservative, and backstopped by write_state's raise.
    return index.module_has_stamped_dict(key)


def check_file(path: pathlib.Path) -> list[str]:
    try:
        tree = ast.parse(path.read_text(encoding="utf-8"))
    except SyntaxError as exc:
        return [f"{path}: unparseable ({exc})"]
    problems: list[str] = []
    index = _ModuleIndex(tree)

    # Map every call to its enclosing function for Name resolution.
    enclosing_of: dict[ast.Call, ast.FunctionDef] = {}
    for func in ast.walk(tree):
        if isinstance(func, ast.FunctionDef):
            for node in ast.walk(func):
                if isinstance(node, ast.Call):
                    enclosing_of.setdefault(node, func)

    try:
        rel = path.relative_to(ROOT)
    except ValueError:  # test fixtures live in tmp dirs
        rel = path
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name == "SegmentRing" and path.name != "wal.py":
            if _keyword(node, "format_version") is None:
                problems.append(
                    f"{rel}:{node.lineno}: SegmentRing(...) without "
                    f"format_version= — stamp the record payload "
                    f"format")
        elif name == "write_state":
            key_node = _keyword(node, "version_key")
            key = (key_node.value
                   if isinstance(key_node, ast.Constant)
                   and isinstance(key_node.value, str) else "version")
            state = (node.args[1] if len(node.args) > 1
                     else _keyword(node, "state"))
            if state is None:
                continue  # not the wal.write_state signature
            if not _state_is_stamped(state, key, index,
                                     enclosing_of.get(node)):
                problems.append(
                    f"{rel}:{node.lineno}: write_state(...) whose "
                    f"state carries no {key!r} stamp — every persisted "
                    f"format must be versioned")
    return problems


def main() -> int:
    problems: list[str] = []
    for path in sorted(PACKAGE.rglob("*.py")):
        problems.extend(check_file(path))
    for problem in problems:
        print(problem, file=sys.stderr)
    if problems:
        print("fix: stamp the writer (format_version= for SegmentRing, "
              "a 'version' key for write_state state dicts)",
              file=sys.stderr)
        return 1
    print("check_wal_versions: every wal.py writer call site stamps a "
          "format version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
