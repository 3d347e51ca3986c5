"""Energy and bursts: a real NVML daemon with the burst sampler on.

The port of the reference's ``tools/energy_sim.py``. The daemon runs over
``testing.fake_nvml`` (pod ``train-energy`` on both cards through a
kubelet checkpoint) with the burst sampler continuous at 200 Hz:

- **50 ms power spikes**: card 0's power jumps 120 -> 900 W for 50 ms
  between poll ticks (timed off the publish edge), in NVML's power
  reading and in its instantaneous power field (the burst sampler's
  read), then returns. The tick gauge never sees it; the burst ring
  catches it at full height in ``kts_power_burst_watts{stat="max"}`` and
  in the top histogram bucket;
- **restart persistence**: the daemon stops (its final energy
  checkpoint) and a new daemon on the same checkpoint resumes:
  ``kts_energy_pod_joules_total`` is monotone across the restart;
- **the governance digest**: ``doctor --energy`` verifies the signed
  ``/debug/energy`` payload with the shared audit key, and fails with a
  wrong one.
"""

from __future__ import annotations

import pathlib
import tempfile
import time

from ._common import Result, cards, nvml_daemon

SPIKE_WATTS = 900.0
BASE_MW = 120_000


def run() -> Result:
    from .. import doctor
    from ..testing.fake_nvml import FakeNvml
    from ..validate import parse_exposition

    result = Result("energy")
    problems = result.problems
    fig = result.figures
    daemons: list = []

    def series(daemon, family, **want):
        text = daemon.registry.snapshot().render()
        return [(labels, value)
                for name, labels, value in parse_exposition(text)
                if name == family and all(labels.get(k) == v
                                          for k, v in want.items())]

    def pod_joules(daemon) -> float:
        rows = series(daemon, "kts_energy_pod_joules_total",
                      pod="train-energy")
        return rows[0][1] if rows else 0.0

    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        fake = FakeNvml(cards(0, power_mw=BASE_MW))
        settings = dict(
            pods={"train-energy": [0, 1]}, interval=0.3, deadline=2.0,
            pipeline_fetch=False, burst_mode="continuous", burst_hz=200.0,
            energy_checkpoint=str(root / "energy.json"),
            energy_checkpoint_interval=0.5,
            energy_audit_key="sim-attest-key")
        try:
            daemon, _, _ = nvml_daemon(root / "node", 0, fake=fake, **settings)
            daemon.start()
            daemons.append(daemon)
            daemon.registry.wait_for_publish(0, timeout=10)
            deadline = time.monotonic() + 10
            while pod_joules(daemon) == 0.0 and time.monotonic() < deadline:
                time.sleep(0.2)
            joined = pod_joules(daemon) > 0.0
            if not joined:
                problems.append("per-pod joules never appeared "
                                "(attribution join failed)")

            gauge_max = burst_max = 0.0
            generation = daemon.registry.generation

            def observe() -> None:
                nonlocal gauge_max, burst_max
                for _labels, value in series(daemon,
                                             "accelerator_power_watts"):
                    gauge_max = max(gauge_max, value)
                for _labels, value in series(daemon, "kts_power_burst_watts",
                                             stat="max"):
                    burst_max = max(burst_max, value)

            card = fake.devices[0]
            for _ in range(4):
                if not daemon.registry.wait_for_publish(generation,
                                                        timeout=5):
                    problems.append("daemon stopped publishing mid-spike")
                    break
                generation = daemon.registry.generation
                observe()
                # A publish just happened: the next blocking read is a
                # whole interval away, and the spike fits well inside.
                card.power_mw = card.power_instant_mw = int(
                    SPIKE_WATTS * 1000)
                time.sleep(0.05)
                card.power_mw, card.power_instant_mw = BASE_MW, None
            for _ in range(3):
                daemon.registry.wait_for_publish(generation, timeout=5)
                generation = daemon.registry.generation
                observe()
            if burst_max < SPIKE_WATTS:
                problems.append(f"burst max {burst_max} W missed the "
                                f"{SPIKE_WATTS} W spike")
            if gauge_max >= 500.0:
                problems.append(f"the tick gauge saw {gauge_max} W: the "
                                f"spike was not between ticks")
            high = series(daemon, "kts_power_burst_watts_distribution_bucket",
                          chip="0", le="1000")
            low = series(daemon, "kts_power_burst_watts_distribution_bucket",
                         chip="0", le="750")
            spiked = high[0][1] - low[0][1] if high and low else 0.0
            if spiked <= 0:
                problems.append("burst histogram has no samples in the "
                                "(750, 1000] W spike bucket")
            fig.update(joined=joined, burst_max=burst_max,
                       gauge_saw_spike=gauge_max >= 500.0,
                       spike_bucketed=spiked > 0)
            result.timings.update(gauge_max=gauge_max, spike_samples=spiked)

            joules_before = pod_joules(daemon)
            daemon.stop()  # the final checkpoint
            daemons.clear()
            daemon2, _, _ = nvml_daemon(root / "node", 0, fake=fake,
                                        **settings)
            daemon2.start()
            daemons.append(daemon2)
            daemon2.registry.wait_for_publish(0, timeout=10)
            joules_after = pod_joules(daemon2)
            monotone = joules_before > 0 and joules_after >= joules_before
            if not monotone:
                problems.append(f"per-pod joules not monotone across "
                                f"restart ({joules_before} -> "
                                f"{joules_after})")
            time.sleep(1.0)
            joules_later = pod_joules(daemon2)
            advancing = joules_later > joules_after
            if not advancing:
                problems.append(f"per-pod joules not advancing after "
                                f"restart ({joules_after} -> "
                                f"{joules_later})")
            base = f"http://127.0.0.1:{daemon2.server.port}"
            good = doctor.check_energy(base, "sim-attest-key")
            if good.status != doctor.OK:
                problems.append(f"doctor --energy did not verify the signed "
                                f"digest: [{good.status}] {good.detail}")
            bad = doctor.check_energy(base, "wrong-key")
            if bad.status != doctor.FAIL:
                problems.append(f"doctor --energy accepted a digest under "
                                f"the wrong key: [{bad.status}] "
                                f"{bad.detail}")
            fig.update(joules_monotone=monotone, joules_advancing=advancing,
                       doctor_right_key=good.status,
                       doctor_wrong_key=bad.status)
            result.timings.update(joules_before=joules_before,
                                  joules_after=joules_after,
                                  joules_later=joules_later)
        finally:
            for daemon in daemons:
                daemon.stop()
    return result


def add_arguments(parser) -> None:
    pass


def main(args) -> Result:
    result = run()
    print(result.report(
        "50 ms spike caught by the burst ring and never by the tick gauge, "
        "joules monotone across restart, digest verified + wrong key "
        "refused"))
    return result
