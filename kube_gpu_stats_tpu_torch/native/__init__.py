"""Native transports and fast paths.

- ``nvml.py``: the ctypes binding to NVML.
- ``wirefast.cc``: the host fast paths as one CPython extension, built by
  ``_hostbuild.py`` at first use — the hub's batch slot store
  (``apply_slots``) and frame fold (``fold_rows``), the delta frame decode,
  snappy, and the exposition render with gzip. Each has a Python path in
  the package that computes the same bytes and stays as its oracle.

The loaders below build the extension when no build of the current source
is there, and raise :class:`NativeUnavailable` with g++'s output when the
build or a ``configure_*`` fails: with the fast paths on (the default) a
process stops at start rather than quietly running the Python paths.
``--no-native`` (the daemon, the embedded exporter) and
``--no-native-ingest`` (the hub) choose the Python paths instead, and
:func:`use_python_paths` turns the module-level users (``snappy``,
``delta.decode_frame_raw``) over with them.

A fast path that faults on a call after a good start degrades its instance
to the Python path with a warning, as the reference does; :func:`faults`
lists those, and the doctor's ``native`` row reports them.
"""

from __future__ import annotations

import contextlib
import gzip
import threading

from . import _hostbuild

SWITCHES = ("pass --no-native (the daemon; KTS_NO_NATIVE=1 for the embedded "
            "exporter) or --no-native-ingest (the hub) to run the Python "
            "paths instead")


class NativeUnavailable(RuntimeError):
    """The extension did not build, load or configure."""


_lock = threading.Lock()
# module / path / error / configured: what this process has loaded;
# python_paths: the switch that turned the module-level users over.
_cache: dict = {}
_faults: dict[str, str] = {}


def load_wirefast():
    """The extension, built at first use and configured with this
    interpreter's gzip header. Raises :class:`NativeUnavailable`."""
    with _lock:
        module = _cache.get("module")
        if module is not None:
            return module
        if "error" in _cache:
            raise NativeUnavailable(_cache["error"])
        try:
            path = _hostbuild.build()
            module = _hostbuild.load(path)
            module.configure_gzip(tuple(
                gzip.compress(b"", compresslevel=level, mtime=0)[:10]
                for level in range(10)))
        except Exception as exc:
            _cache["error"] = (f"the host fast paths are unavailable: "
                               f"{exc}\n{SWITCHES}")
            raise NativeUnavailable(_cache["error"]) from exc
        _cache["module"] = module
        _cache["path"] = path
        return module


def _configured(name: str, configure) -> object:
    module = load_wirefast()
    with _lock:
        if name in _cache.setdefault("configured", set()):
            return module
        try:
            configure(module)
        except Exception as exc:
            raise NativeUnavailable(
                f"the host fast paths failed to configure ({name}): "
                f"{exc}\n{SWITCHES}") from exc
        _cache["configured"].add(name)
    return module


def load_ingest():
    """The hub's batch slot store (``apply_slots``), configured with the
    port's ``registry.Series``."""
    def configure(module) -> None:
        from ..registry import Series

        module.configure_apply(Series)
    return _configured("apply", configure)


def load_delta_decode():
    """The DELTA frame decode (``decode_delta_frame``,
    ``decode_delta_slots``)."""
    return load_wirefast()


def load_render():
    """The exposition render and gzip (``render_exposition``,
    ``gzip_compress``), configured with the port's schema families."""
    def configure(module) -> None:
        from .. import schema

        fams = []
        for spec in schema.ALL_METRICS:
            if spec.type is schema.MetricType.HISTOGRAM:
                continue
            family = spec.name
            if spec.type is schema.MetricType.COUNTER:
                family = spec.name.removesuffix("_total")
            plain = (f"# HELP {spec.name} {spec.help}\n"
                     f"# TYPE {spec.name} {spec.type.value}\n")
            om = (f"# HELP {family} {spec.help}\n"
                  f"# TYPE {family} {spec.type.value}\n")
            fams.append((spec.name, plain.encode(), om.encode()))
        module.configure_render(tuple(fams))
    return _configured("render", configure)


def load_fold():
    """The hub's frame-fold inner loop (``fold_rows``)."""
    return load_wirefast()


def use_python_paths(switch: str) -> None:
    """Turn this process's module-level users of the extension (snappy,
    the delta decode) over to their Python paths; ``switch`` names the
    flag that asked for it."""
    _cache["python_paths"] = switch


@contextlib.contextmanager
def python_paths(switch: str | None):
    """:func:`use_python_paths` for the length of a ``with`` block: a
    measurement or a test of the Python paths beside the native ones.
    ``None`` leaves the paths as they are."""
    if switch is None:
        yield
        return
    before = _cache.get("python_paths")
    _cache["python_paths"] = switch
    try:
        yield
    finally:
        if before is None:
            _cache.pop("python_paths", None)
        else:
            _cache["python_paths"] = before


def fast_path():
    """The extension for the module-level users, or None when this process
    chose the Python paths. Builds at first use; raises
    :class:`NativeUnavailable` when that fails."""
    if "python_paths" in _cache:
        return None
    return _cache.get("module") or load_wirefast()


def library_path():
    """The loaded extension's file, or None before a load."""
    return _cache.get("path")


def python_paths_switch() -> str | None:
    """The flag that turned the module-level users over, or None."""
    return _cache.get("python_paths")


def note_fault(where: str, exc: BaseException) -> None:
    """Record that ``where`` faulted on a call and its instance went back
    to the Python path."""
    _faults[where] = f"{type(exc).__name__}: {exc}"


def faults() -> dict[str, str]:
    """Each fast path that faulted in this process, with its error."""
    return dict(_faults)
