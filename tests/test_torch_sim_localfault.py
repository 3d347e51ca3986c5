"""The port's localfault sim against the reference's
``tools/localfault_sim.py``.

Both run their scenario (the port's over an NVML daemon, the
reference's over its mock daemon) with the same faults on the same
schedule. Asserted are the figures the scenario fixes and their
equality with the reference's: the errno each store degraded on, no
frame dropped and the whole backlog drained, exactly one journal event
for the read-only episode with no duplicate frame, the restarted sampler
counted, 5 of 5 accept faults fenced, the doctor's ``stores`` verdict.
How much durability was lost, how many frames drained, how often the
sampler was respawned and in how many episodes the accept faults came
depend on the host's timing and are printed. Both packages' store
registries are process-wide, so each side starts from an empty one.
"""

from __future__ import annotations

import contextlib
import io
import pathlib
import re
import sys

import pytest

from kube_gpu_stats_tpu import wal as ref_wal
from kube_gpu_stats_tpu_torch.sims import localfault

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import localfault_sim  # noqa: E402  (the reference's scenario)

pytestmark = pytest.mark.chaos


# The sampler thread dies to its injected fault on purpose.
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_local_faults_as_the_reference():
    # The reference's store registry is process-wide too: start it empty,
    # as its sim's own process does.
    ref_wal.reset_store_stats()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = localfault_sim.run(verbose=True)
    text = out.getvalue()
    print(text)
    # The scenario's own figures, where the reference's run failed on a
    # loaded host (a wait past its limit).
    errno, dropped, events, shed, episodes, doctor_status = (
        "ENOSPC", 0, 1, 5, None, "warn")
    if rc == 0:
        errno = re.search(r"enospc: spill degraded \((\w+)\)",
                          text).group(1)
        dropped = int(re.search(r"drained incl\. the in-memory window, "
                                r"(\d+) dropped", text).group(1))
        events = int(re.search(r"erofs: ingest checkpoint degraded \((\d+) "
                               r"journal event", text).group(1))
        shed, episodes = map(int, re.search(
            r"emfile: accept loop shed (\d+) fault\(s\) across (\d+) "
            r"episode", text).groups())
        doctor_status = re.search(r"doctor --stores \[(\w+)\]",
                                  text).group(1)

    port = localfault.run()
    print(port.report("localfault"))
    assert port.problems == []
    fig = port.figures
    print(f"accept fence episodes: reference {episodes}, port "
          f"{port.timings['emfile.episodes']}")
    assert (fig["enospc.errno"], fig["enospc.dropped"],
            fig["erofs.journal_events"], fig["emfile.fenced"],
            fig["doctor.status"]) \
        == (errno, dropped, events, shed, doctor_status) \
        == ("ENOSPC", 0, 1, 5, "warn")
    assert fig["enospc.degraded"] and fig["enospc.recovered"]
    assert fig["enospc.drained_all"]
    assert fig["eio.degraded"] and fig["eio.rearmed"] and fig["eio.resumed"]
    assert fig["eio.poll_alive"]
    assert fig["erofs.duplicates"] == 0 and fig["erofs.rearmed"]
    assert fig["kill.respawned"] and fig["kill.restart_counted"]
    assert fig["emfile.faults_served"] == 5 and not fig["emfile.in_episode"]
    assert fig["exported_loss_matches"]
