"""Path-prefix-scoped filesystem fault injection for the port's stores.

The port's copy of the reference's ``testing/faultfs.py``, so the port's
fault tests need nothing of the reference. The stores under test
(``wal.py``'s checkpoints and segment rings, and the energy checkpoint
built on them) do their durable I/O through plain ``open`` /
``os.fsync`` / ``os.replace`` / ``os.unlink`` / ``os.makedirs`` /
``os.listdir``. This module patches those at process level but scopes
every fault to a registered PATH PREFIX — a test hands its tmpdir in,
and nothing outside it (pytest's own files, the interpreter) ever sees
a fault.

Faults:

- ``"enospc"`` / ``"eio"`` / ``"erofs"`` / ``"emfile"`` /
  ``"eacces"`` / ``"edquot"`` — raise the matching OSError from the
  targeted op.
- ``"slow"`` — sleep ``delay`` seconds, then let the op proceed
  (slow-io: a dying disk that still answers).
- ``"torn"`` — write HALF the buffer, flush it, then raise
  :class:`TornWrite` (NOT an OSError): this simulates the crash
  itself, so it deliberately escapes the stores' OSError containment
  the way a real power loss would — the test catches it, and the next
  recovery must truncate the half-written tail.

Ops: ``"open"`` (write-mode opens only), ``"write"``, ``"fsync"``,
``"replace"`` (also covers ``os.rename``), ``"unlink"``,
``"makedirs"``, ``"listdir"``.

Usage::

    with FaultFS() as fs:
        fs.inject(str(tmp_path), "enospc", ops=("write", "fsync"))
        ...drive the store...
        fs.clear()          # fault over; probes now succeed

``times=N`` bounds a rule to its first N matches (a transient fault).
:func:`fence_accepts` separately wraps a MetricsServer's listening
socket so ``accept()`` raises EMFILE ``times`` times — the accept-loop
fence's injection point (sockets aren't paths; prefix scoping can't
reach them).
"""

from __future__ import annotations

import builtins
import errno as errno_mod
import os
import threading
import time

_ERRNOS = {
    "enospc": errno_mod.ENOSPC,
    "edquot": errno_mod.EDQUOT,
    "eio": errno_mod.EIO,
    "erofs": errno_mod.EROFS,
    "eacces": errno_mod.EACCES,
    "emfile": errno_mod.EMFILE,
}

_DEFAULT_OPS = ("open", "write", "fsync", "replace")


class TornWrite(Exception):
    """The 'crash' a torn-write rule raises after landing half the
    bytes — deliberately not an OSError, because a real crash isn't
    catchable either."""


class _Rule:
    def __init__(self, prefix: str, fault: str, ops, times, delay):
        if fault not in _ERRNOS and fault not in ("slow", "torn"):
            raise ValueError(f"unknown fault {fault!r}")
        self.prefix = prefix
        self.fault = fault
        self.ops = frozenset(ops)
        self.times = times  # None = unlimited
        self.delay = delay
        self.hits = 0

    def matches(self, path: str, op: str) -> bool:
        if op not in self.ops or not path.startswith(self.prefix):
            return False
        return self.times is None or self.hits < self.times


def _raise(rule: _Rule, path: str) -> None:
    code = _ERRNOS[rule.fault]
    raise OSError(code, os.strerror(code), path)


class _FaultyFile:
    """File proxy: write faults fire at write() time (so a rule
    injected AFTER open still hits the next append), everything else
    delegates. Registered with the owning FaultFS by fd so os.fsync
    injection can map the fd back to its path."""

    def __init__(self, raw, fs: "FaultFS", path: str) -> None:
        self._raw = raw
        self._fs = fs
        self._path = path

    def write(self, data):
        rule = self._fs._take(self._path, "write")
        if rule is None:
            return self._raw.write(data)
        if rule.fault == "slow":
            time.sleep(rule.delay)
            return self._raw.write(data)
        if rule.fault == "torn":
            # Crash-mid-append: half the bytes land, then the process
            # "dies". The next recovery's CRC walk must truncate them.
            if len(data) > 1:
                self._raw.write(data[: len(data) // 2])
                self._raw.flush()
            raise TornWrite(self._path)
        _raise(rule, self._path)

    def flush(self):
        return self._raw.flush()

    def close(self):
        self._fs._forget_fd(self._raw)
        return self._raw.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self):
        return iter(self._raw)

    def __getattr__(self, name):
        return getattr(self._raw, name)


class FaultFS:
    """Installable fault plan. Context manager: patches on __enter__,
    restores on __exit__ (exception-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._rules: list[_Rule] = []
        self._watches: list[str] = []
        self._fds: dict[int, str] = {}
        self._orig: dict[str, object] = {}
        self._installed = False

    # -- plan -----------------------------------------------------------------

    def watch(self, prefix: str) -> None:
        """Wrap files opened under ``prefix`` from now on WITHOUT any
        active fault — so a store can be built healthy and have a rule
        injected mid-life hit its already-open handles (write faults
        check rules at write() time). Register the store's directory
        here before constructing it."""
        with self._lock:
            self._watches.append(str(prefix))

    def inject(self, prefix: str, fault: str, *,
               ops=_DEFAULT_OPS, times: int | None = None,
               delay: float = 0.05) -> _Rule:
        rule = _Rule(str(prefix), fault, ops, times, delay)
        with self._lock:
            self._rules.append(rule)
        return rule

    def clear(self) -> None:
        """Drop every rule (the fault 'clears'; probes succeed again).
        Watches stay — wrapped handles keep working fault-free."""
        with self._lock:
            del self._rules[:]

    def _take(self, path: str, op: str) -> _Rule | None:
        with self._lock:
            for rule in self._rules:
                if rule.matches(path, op):
                    rule.hits += 1
                    return rule
        return None

    def _interested(self, path: str) -> bool:
        with self._lock:
            return (any(path.startswith(p) for p in self._watches)
                    or any(path.startswith(r.prefix)
                           for r in self._rules))

    def _forget_fd(self, raw) -> None:
        try:
            fd = raw.fileno()
        except Exception:  # noqa: BLE001 - already closed
            return
        with self._lock:
            self._fds.pop(fd, None)

    # -- patches --------------------------------------------------------------

    def install(self) -> "FaultFS":
        if self._installed:
            return self
        self._orig = {
            "open": builtins.open,
            "fsync": os.fsync,
            "replace": os.replace,
            "rename": os.rename,
            "unlink": os.unlink,
            "makedirs": os.makedirs,
            "listdir": os.listdir,
        }
        builtins.open = self._open  # type: ignore[assignment]
        os.fsync = self._fsync  # type: ignore[assignment]
        os.replace = self._path_op("replace", self._orig["replace"], 2)
        os.rename = self._path_op("replace", self._orig["rename"], 2)
        os.unlink = self._path_op("unlink", self._orig["unlink"], 1)
        os.makedirs = self._path_op("makedirs", self._orig["makedirs"], 1)
        os.listdir = self._path_op("listdir", self._orig["listdir"], 1)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        builtins.open = self._orig["open"]  # type: ignore[assignment]
        os.fsync = self._orig["fsync"]  # type: ignore[assignment]
        os.replace = self._orig["replace"]  # type: ignore[assignment]
        os.rename = self._orig["rename"]  # type: ignore[assignment]
        os.unlink = self._orig["unlink"]  # type: ignore[assignment]
        os.makedirs = self._orig["makedirs"]  # type: ignore[assignment]
        os.listdir = self._orig["listdir"]  # type: ignore[assignment]
        self._installed = False

    __enter__ = install

    def __exit__(self, *exc):
        self.uninstall()
        return False

    def _decode(self, path) -> str | None:
        if isinstance(path, int):
            return None
        try:
            return os.fsdecode(os.fspath(path))
        except TypeError:
            return None

    def _open(self, file, mode: str = "r", *args, **kwargs):
        path = self._decode(file)
        if path is not None and any(c in mode for c in "wax+"):
            rule = self._take(path, "open")
            if rule is not None:
                if rule.fault == "slow":
                    time.sleep(rule.delay)
                else:
                    _raise(rule, path)
        raw = self._orig["open"](file, mode, *args, **kwargs)
        if path is not None and self._interested(path):
            try:
                with self._lock:
                    self._fds[raw.fileno()] = path
            except OSError:
                pass
            return _FaultyFile(raw, self, path)
        return raw

    def _fsync(self, fd) -> None:
        real_fd = fd if isinstance(fd, int) else fd.fileno()
        with self._lock:
            path = self._fds.get(real_fd)
        if path is not None:
            rule = self._take(path, "fsync")
            if rule is not None:
                if rule.fault == "slow":
                    time.sleep(rule.delay)
                else:
                    _raise(rule, path)
        return self._orig["fsync"](fd)

    def _path_op(self, op: str, orig, npaths: int):
        def wrapper(*args, **kwargs):
            for candidate in args[:npaths]:
                path = self._decode(candidate)
                if path is None:
                    continue
                rule = self._take(path, op)
                if rule is not None:
                    if rule.fault == "slow":
                        time.sleep(rule.delay)
                        break
                    _raise(rule, path)
            return orig(*args, **kwargs)

        return wrapper


class _FaultyAcceptSocket:
    """Listening-socket proxy whose accept() raises OSError(EMFILE)
    the first ``times`` calls, then delegates — the accept fence's
    injection point. Everything else (fileno for the selector,
    getsockname, close) passes through."""

    def __init__(self, raw, code: int, times: int) -> None:
        self._raw = raw
        self._code = code
        self._left = times
        self.faults_served = 0

    def accept(self):
        if self._left > 0:
            self._left -= 1
            self.faults_served += 1
            raise OSError(self._code, os.strerror(self._code))
        return self._raw.accept()

    def __getattr__(self, name):
        return getattr(self._raw, name)


def fence_accepts(metrics_server, *, times: int = 3,
                  errno_name: str = "EMFILE") -> _FaultyAcceptSocket:
    """Make a MetricsServer's next ``times`` accepts fail with
    ``errno_name`` (EMFILE by default) — fd exhaustion as the accept
    loop sees it. Returns the proxy so the test can assert
    faults_served drained."""
    httpd = metrics_server._server
    proxy = _FaultyAcceptSocket(httpd.socket,
                                getattr(errno_mod, errno_name), times)
    httpd.socket = proxy
    return proxy
