"""What the sims share: a sim's result, and an NVML daemon over a fake.

Each sim returns a :class:`Result`: the problems it found (empty is a
pass), the figures its scenario fixes (counts, verdicts, names: the same
on any host, and compared with the reference's), and the host timings it
measured (printed, never a pass condition of the comparison).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import time
from typing import Callable, Iterator

from ..testing.fake_nvml import FakeDevice, FakeNvml
from ..testing.nvml_faults import NvmlFaults


@dataclasses.dataclass
class Result:
    name: str
    problems: list[str] = dataclasses.field(default_factory=list)
    figures: dict = dataclasses.field(default_factory=dict)
    timings: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.problems

    def merge(self, other: "Result", prefix: str) -> None:
        self.problems += other.problems
        self.figures.update({f"{prefix}.{k}": v
                             for k, v in other.figures.items()})
        self.timings.update({f"{prefix}.{k}": v
                             for k, v in other.timings.items()})

    def report(self, summary: str) -> str:
        lines = [f"{self.name}-sim {'PASS' if self.ok else 'FAIL'}"
                 + (f": {summary}" if self.ok else ":")]
        lines += [f"  {problem}" for problem in self.problems]
        lines.append("  figures " + json.dumps(self.figures, sort_keys=True))
        lines.append("  timings " + json.dumps(
            {k: round(v, 4) if isinstance(v, float) else v
             for k, v in self.timings.items()}, sort_keys=True))
        return "\n".join(lines)


def wait_for(predicate: Callable[[], bool], timeout: float,
             interval: float = 0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def cards(node: int, n: int = 2, **readings) -> list[FakeDevice]:
    """``n`` H100 cards of node ``node``, each with two NVLink links."""
    base = dict(gpu_util=60, power_mw=120_000, memory_used=8 * 2**30,
                nvlink_kib={0: (0, 0), 1: (0, 0)})
    base.update(readings)
    return [FakeDevice(uuid=f"GPU-{node:04x}{i:04x}-0000-0000-0000-"
                            f"{node:06x}{i:06x}",
                       minor=i, **base) for i in range(n)]


def kubelet_checkpoint(path: pathlib.Path,
                       pods: dict[str, list[str]]) -> None:
    """The kubelet's device-plugin checkpoint giving each pod (its UID,
    which the checkpoint source serves as the ``pod`` label) its cards,
    by UUID."""
    entries = [{"PodUID": pod, "ContainerName": "worker",
                "ResourceName": "nvidia.com/gpu",
                "DeviceIDs": {"0": list(uuids)}}
               for pod, uuids in pods.items()]
    registered = [u for uuids in pods.values() for u in uuids]
    path.write_text(json.dumps({"Data": {
        "PodDeviceEntries": entries,
        "RegisteredDevices": {"nvidia.com/gpu": registered}},
        "Checksum": 0}))


@contextlib.contextmanager
def node_env(slice_name: str, worker: int,
             topology: str = "") -> Iterator[None]:
    """The topology labels a node's daemon reads at construction."""
    keys = {"KTS_SLICE": slice_name, "KTS_WORKER": str(worker),
            "KTS_TOPOLOGY": topology}
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update(keys)
    try:
        yield
    finally:
        for key, value in old.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def nvml_daemon(root: pathlib.Path, node: int, *, slice_name: str = "sim",
                topology: str = "",
                pods: dict[str, list[int]] | None = None,
                fake: FakeNvml | None = None, **cfg):
    """(daemon, fake, faults) for one node: the port's daemon over
    ``fake`` (two cards when None) through ``faults``, the
    ``testing.nvml_faults`` wrapper a sim scripts NVML's faults with; pods attributed through a kubelet checkpoint
    file (``pods``: pod -> card indexes), topology labels from
    ``slice_name``, ``node`` and ``topology``. ``cfg`` overrides the
    daemon's ``Config``. The daemon is built, not started."""
    from ..config import Config
    from ..daemon import Daemon

    fake = fake if fake is not None else FakeNvml(cards(node))
    root.mkdir(parents=True, exist_ok=True)
    settings = dict(backend="nvml", interval=0.1, deadline=2.0,
                    listen_host="127.0.0.1", listen_port=0,
                    attribution="off", use_native=False)
    if pods is not None:
        ckpt = root / "kubelet_internal_checkpoint"
        kubelet_checkpoint(ckpt, {
            pod: [fake.devices[i].uuid for i in idx]
            for pod, idx in pods.items()})
        settings.update(attribution="checkpoint",
                        checkpoint_path=str(ckpt),
                        attribution_interval=0.2)
    settings.update(cfg)
    with node_env(slice_name, node, topology):
        faults = NvmlFaults(fake)
        daemon = Daemon(Config(**settings), nvml=faults)
    return daemon, fake, faults
