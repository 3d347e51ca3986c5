"""Builds the port's host fast paths (``wirefast.cc``) at first use.

``g++`` compiles ``wirefast.cc`` of this directory into a CPython extension
against the running interpreter's headers, linked with zlib. The library
lands in ``build/`` beside the source under a name keyed by a hash of the
source, the flags and the interpreter's cache tag, so an edited source (or
another Python) never runs a stale build. A file lock keeps concurrent first
uses from compiling over each other; a build that is already there loads
without the lock, so a read-only install (the DaemonSet image, which ships
the library from its build stage) never writes. A failed build raises with
g++'s output, and a build directory this user cannot write raises naming
the prebuild step below. Nothing falls back.

This module imports no torch: the daemon and hub load it.

Run ``python -m kube_gpu_stats_tpu_torch.native._hostbuild`` to build ahead
of use; it prints the library's path.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "wirefast.cc"
BUILD_DIR = HERE / "build"
MODULE = "_wirefast"  # the source's PyInit__wirefast
# The compiler: $CXX, else g++ from PATH.
CXX = os.environ.get("CXX") or "g++"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
LINK_FLAGS = ("-lz",)
BUILD_TIMEOUT_S = 300


def include_dirs() -> list[str]:
    """Python.h's directory, then the interpreter's prefix include
    directory (where an environment such as conda keeps zlib.h)."""
    dirs = [sysconfig.get_paths()["include"]]
    extra = sysconfig.get_config_var("INCLUDEDIR")
    if extra and extra not in dirs and Path(extra).is_dir():
        dirs.append(extra)
    return dirs


def library_dirs() -> list[str]:
    libdir = sysconfig.get_config_var("LIBDIR")
    return [libdir] if libdir and Path(libdir).is_dir() else []


def command(output: Path) -> list[str]:
    """The full g++ command line for ``output``."""
    return [CXX, *CXX_FLAGS,
            *(f"-I{d}" for d in include_dirs()),
            str(SOURCE), "-o", str(output),
            *(f"-L{d}" for d in library_dirs()), *LINK_FLAGS]


def library_path() -> Path:
    """Where the build of the current source, flags and interpreter goes."""
    digest = hashlib.sha256()
    digest.update(SOURCE.read_bytes())
    digest.update("\0".join((*CXX_FLAGS, *LINK_FLAGS)).encode())
    digest.update(sys.implementation.cache_tag.encode())
    return BUILD_DIR / f"{MODULE}_{digest.hexdigest()[:16]}.so"


class BuildError(RuntimeError):
    """g++ failed (or is missing); the message carries its output."""


def build() -> Path:
    """The extension's path, compiled first when no build of the current
    source is there."""
    lib = library_path()
    if lib.exists():
        return lib
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lock = open(BUILD_DIR / "build.lock", "w")
    except OSError as exc:
        raise BuildError(
            f"cannot write the build directory {BUILD_DIR} ({exc}): the "
            "installed package is read-only to this user. Build the "
            "library ahead, as a user who can write there: python -m "
            "kube_gpu_stats_tpu_torch.native._hostbuild") from exc
    with lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            _compile(lib)
    return lib


def _compile(lib: Path) -> None:
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = command(tmp)
    if shutil.which(cmd[0]) is None:
        raise BuildError(f"the C++ compiler {cmd[0]!r} was not found "
                         "(set CXX, or install g++)")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as exc:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"{' '.join(cmd)}: {exc}") from exc
    output = proc.stderr + proc.stdout
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"{' '.join(cmd)}\nexited {proc.returncode}:\n"
                         f"{output}")
    os.replace(tmp, lib)


def load(lib: Path):
    """Import the built extension from ``lib`` (under the package's name
    for it, so it never shadows another ``_wirefast``)."""
    name = f"{__package__}.{MODULE}"
    loader = importlib.machinery.ExtensionFileLoader(name, str(lib))
    spec = importlib.util.spec_from_file_location(name, str(lib),
                                                  loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    sys.modules[name] = module
    return module


if __name__ == "__main__":
    print(build())
