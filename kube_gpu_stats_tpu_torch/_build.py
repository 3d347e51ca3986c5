"""Builds the port's CUDA kernels at first use.

``nvcc`` compiles every ``csrc/*.cu`` of this package into one shared library
with a plain C interface, for ``sm_90a`` only. The library lands in
``csrc/build/`` (ignored by git) under a name keyed by a hash of the sources
and flags, so an edited source is never run from a stale build; a file lock
keeps concurrent first uses from compiling over each other. A failed build
raises with nvcc's output. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin (default "
        "/usr/local/cuda): the CUDA toolkit is needed to build the kernels")


def _library_path(sources: list[Path]) -> Path:
    digest = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libkts_kernels_{digest.hexdigest()[:16]}.so"


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' library, compiled on the first call in any process that
    finds no build for the current sources."""
    sources = sorted(CSRC.glob("*.cu"))
    lib_path = _library_path(sources)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            _compile(sources, lib_path)
    return ctypes.CDLL(str(lib_path))


def _compile(sources: list[Path], lib_path: Path) -> None:
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=NVCC_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, lib_path)
