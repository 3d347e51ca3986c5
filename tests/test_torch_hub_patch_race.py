"""A push entry's delta patches against the hub's lazy derived views.

The hub builds a push entry's derived views (the per-chip merge plan, the
frame fold, the histogram fold, the fleet digest) on its refresh thread
while ingest threads patch the same entry. Each case lets a frame land
in the window between a build's read of the values and the install of
its view: a patcher thread applies one delta there, and the build waits
for it. The frame finds no view to patch, so the built view must not be
kept: the entry holds no view, or one with the patched value, and the
next refresh's view carries the patched value. Without that, the
installed view kept the value from before the frame until that slot
changed again. Values are compared exactly.

Each case runs twice: the frame patched by the Python per-slot loop, and
by the host extension's batch slot store (``apply_slots``), which runs at
the same place inside the seqlock. For the native case the entry's patch
program is compiled first (it needs a merge plan) and the view under test
dropped again, so the landing frame goes through the extension.
"""

from __future__ import annotations

import threading

import pytest

from kube_gpu_stats_tpu_torch import fleetlens, hub, schema
from kube_gpu_stats_tpu_torch.registry import SnapshotBuilder
from kube_gpu_stats_tpu_torch.validate import parse_exposition_interned

TARGET = "http://node-01.synthetic:9400/metrics"
WAIT_S = 0.2
HIST = schema.WORKLOAD_HISTOGRAMS[0].name


def _body() -> str:
    labels = 'chip="0",slice="s",worker="node-01",uuid="GPU-0"'
    return "\n".join([
        f"{schema.POWER.name}{{{labels}}} 100",
        f"{schema.ENERGY.name}{{{labels}}} 5000",
        f'{HIST}_bucket{{le="1",{labels}}} 1',
        f'{HIST}_bucket{{le="+Inf",{labels}}} 2',
        f"{HIST}_sum{{{labels}}} 3",
        f"{HIST}_count{{{labels}}} 2",
        f'{schema.SLOWEST_TICK_SECONDS.name}{{phase="poll",blame="x"}} 0.5',
    ]) + "\n"


def _slot(entry: hub._TargetCache, name: str) -> int:
    return next(i for i, (n, _, _) in enumerate(entry.series) if n == name)


def _landing_frame(entry: hub._TargetCache, slot: int, value: float,
                   native_mod=None):
    """A wrapper for a builder: the first time, after the build has read
    the values, a frame patching ``slot`` to ``value`` lands from another
    thread."""
    def wrap(build):
        def racing(*args, **kwargs):
            view = build(*args, **kwargs)
            if not racing.patchers:
                patcher = threading.Thread(
                    target=entry.apply_patch, args=([slot], [value], TARGET),
                    kwargs={"native_mod": native_mod})
                patcher.start()
                patcher.join(WAIT_S)
                racing.patchers.append(patcher)
            return view
        racing.patchers = []
        return racing
    return wrap


def _chip_plan(h, entry, monkeypatch, wrap):
    racing = wrap(h._build_merge_plan)
    monkeypatch.setattr(h, "_build_merge_plan", racing)
    return racing, lambda: h._replay_chip_plans([(TARGET, entry)], []), \
        lambda: None if entry.chip_plan is None else {
            pair[1].spec.name: pair[1].value for pair in entry.chip_plan[1]
        }[schema.POWER.name]


def _frame_fold(h, entry, monkeypatch, wrap):
    racing = wrap(hub.fold_target)
    monkeypatch.setattr(hub, "fold_target", racing)
    return racing, lambda: h._entry_fold(TARGET, entry), lambda: (
        None if entry.frame_rows is None
        else next(iter(entry.frame_rows.values())).power)


def _hist_fold(h, entry, monkeypatch, wrap):
    racing = wrap(h._build_hist_local)
    monkeypatch.setattr(h, "_build_hist_local", racing)
    return racing, lambda: h._merge_histograms(
        SnapshotBuilder(), [(TARGET, entry)]), lambda: (
        None if entry.hist_local is None
        else next(iter(entry.hist_local.values()))["sum"])


def _digest(h, entry, monkeypatch, wrap):
    racing = wrap(fleetlens.digest_from_series)
    monkeypatch.setattr(fleetlens, "digest_from_series", racing)
    return racing, lambda: h._entry_digest(entry), lambda: (
        None if entry.fleet_digest is None
        else entry.fleet_digest["slowest"]["seconds"])


# (case, family the frame patches, value, builder driven through the hub)
CASES = [
    ("chip_plan", schema.POWER.name, 250.0, _chip_plan),
    ("frame_fold", schema.POWER.name, 250.0, _frame_fold),
    ("hist_fold", f"{HIST}_sum", 9.0, _hist_fold),
    ("fleet_digest", schema.SLOWEST_TICK_SECONDS.name, 0.75, _digest),
]


class _Counting:
    """The extension's apply_slots, counted."""

    def __init__(self, module) -> None:
        self.module = module
        self.calls = 0

    def apply_slots(self, entry, slots, values):
        self.calls += 1
        return self.module.apply_slots(entry, slots, values)


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("case,family,value,drive", CASES,
                         ids=[case[0] for case in CASES])
def test_a_frame_landing_during_a_build_reaches_the_view(
        case, family, value, drive, native, monkeypatch):
    h = hub.Hub([], interval=1.0, native_ingest=native)
    entry = hub._TargetCache("", parse_exposition_interned(_body()),
                             pushed=True)
    slot = _slot(entry, family)
    native_mod = None
    if native:
        h._replay_chip_plans([(TARGET, entry)], [])
        assert entry._compile_program(TARGET) is not None
        entry.chip_plan = None
        native_mod = _Counting(h.delta._native_mod)
    racing, refresh, read = drive(h, entry, monkeypatch,
                                  _landing_frame(entry, slot, value,
                                                 native_mod))
    refresh()
    assert len(racing.patchers) == 1, f"{case}: the build ran"
    racing.patchers[0].join(5)
    assert not racing.patchers[0].is_alive()
    assert entry.series[slot][2] == value
    if native:
        assert native_mod.calls == 1, f"{case}: the extension patched"
        assert entry.value_slab[slot] == value
    kept = read()
    assert kept in (None, value), f"{case}: the entry kept {kept}"
    refresh()
    assert read() == value, f"{case}: the next refresh served {read()}"
