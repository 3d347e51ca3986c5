"""Builds the port's CUDA kernels at first use.

``nvcc`` compiles every ``csrc/*.cu`` of this package into one shared library
with a plain C interface, for ``sm_90a`` only. The library lands in
``csrc/build/`` (ignored by git) under a name keyed by a hash of the sources
and flags, so an edited source is never run from a stale build; a file lock
keeps concurrent first uses from compiling over each other. nvcc runs with
``-Xptxas -v``, and its output (each kernel's registers, shared memory and
spills, and any warning) is kept beside the library, where ``build_log``
reads it. A failed build raises with nvcc's output. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
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


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' library, compiled on the first call in any process that
    finds no build for the current sources."""
    sources = _sources()
    lib_path = _library_path(sources)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            _compile(sources, lib_path)
    return ctypes.CDLL(str(lib_path))


def build_log() -> str:
    """nvcc's output from the build of the current sources ("" before it)."""
    log = _library_path(_sources()).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def ptxas_report(log: str) -> dict:
    """Each kernel's registers, static shared memory and spill bytes, and
    every warning line, from nvcc's ``-Xptxas -v`` output."""
    kernels: dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = m[1]
            kernels[name] = {}
        elif name and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            kernels[name].update(spill_stores=int(m[1]),
                                 spill_loads=int(m[2]))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            kernels[name].update(registers=int(m[1]),
                                 static_smem=int(smem[1]) if smem else 0)
    warnings = [line.strip() for line in log.splitlines()
                if "warning" in line.lower()]
    return {"kernels": kernels, "warnings": warnings}


def _compile(sources: list[Path], lib_path: Path) -> None:
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=NVCC_TIMEOUT_S)
    output = proc.stderr + proc.stdout
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{output}")
    lib_path.with_suffix(".log").write_text(output)
    os.replace(tmp, lib_path)
