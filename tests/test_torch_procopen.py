"""Device holders: the port's ``/proc`` scan against the JAX package's.

Fake ``/proc`` trees, made from a seed, with processes holding
``/dev/nvidiaN`` (and other files) open, their ``comm`` and their cgroup
paths in both kubelet layouts. The port's ``scan`` and watcher and the
reference's must give the same holders, including the overflow fold past
the cap and the pod UID.
"""

import os

import numpy as np
import pytest

from kube_gpu_stats_tpu import procopen as ref_procopen
from kube_gpu_stats_tpu_torch import procopen

PATHS = [f"/dev/nvidia{i}" for i in range(4)]
OTHER = ["/dev/nvidiactl", "/dev/nvidia-uvm", "/tmp/x", "socket:[123]"]


def _cgroup(rng, uid: str) -> str:
    layout = rng.integers(0, 3)
    if layout == 0:  # systemd driver
        return ("0::/kubepods.slice/kubepods-burstable.slice/"
                f"kubepods-burstable-pod{uid.replace('-', '_')}.slice/"
                "cri-containerd-abc.scope\n")
    if layout == 1:  # cgroupfs driver
        return f"0::/kubepods/burstable/pod{uid}/0123abcd\n"
    return "0::/user.slice/user-1000.slice/session-1.scope\n"  # not a pod


def _fake_proc(root, seed: int, n_procs: int) -> None:
    rng = np.random.default_rng(seed)
    for pid in rng.choice(np.arange(100, 100000), n_procs, replace=False):
        proc = root / str(int(pid))
        (proc / "fd").mkdir(parents=True)
        (proc / "comm").write_text(f"proc{int(pid) % 7}\n")
        uid = "-".join(f"{int(rng.integers(0, 16**w)):0{w}x}"
                       for w in (8, 4, 4, 4, 12))
        if rng.random() < 0.8:
            (proc / "cgroup").write_text(_cgroup(rng, uid))
        targets = list(rng.choice(PATHS + OTHER, rng.integers(0, 5)))
        for fd, target in enumerate(targets):
            os.symlink(str(target), proc / "fd" / str(fd))
    (root / "self").mkdir()  # not a pid: skipped
    (root / "999999").mkdir()  # a pid whose fds are unreadable


@pytest.mark.parametrize("seed,n_procs,cap,folds", [
    (0, 12, 32, False), (1, 40, 3, True), (2, 60, 1, True),
    (3, 5, 32, False)])
def test_scan_matches_the_reference(tmp_path, seed, n_procs, cap, folds):
    _fake_proc(tmp_path, seed, n_procs)
    got = procopen.scan(str(tmp_path), PATHS, cap)
    assert got == ref_procopen.scan(str(tmp_path), PATHS, cap)
    assert set(got) == set(PATHS)
    assert any(holders and holders[-1][1] == procopen.OVERFLOW_COMM
               for holders in got.values()) == folds
    uids = {uid for holders in got.values() for _, _, uid, _ in holders}
    assert any(uid.count("-") == 4 for uid in uids)


def test_watcher_lookup_matches_the_reference(tmp_path):
    _fake_proc(tmp_path, 7, 30)
    watchers = [cls(lambda: PATHS, proc_root=str(tmp_path), max_holders=4)
                for cls in (ref_procopen.DeviceProcessWatcher,
                            procopen.DeviceProcessWatcher)]
    for watcher in watchers:
        watcher.refresh_once()
    ref, port = watchers
    for path in PATHS + ["/dev/nvidia9"]:
        assert port.lookup(path) == ref.lookup(path)
    assert port.consecutive_failures == 0


def test_missing_proc_root_yields_empty_holders(tmp_path):
    missing = str(tmp_path / "absent")
    assert procopen.scan(missing, PATHS) == \
        ref_procopen.scan(missing, PATHS) == {p: [] for p in PATHS}
    assert procopen.scan(missing, []) == {}
