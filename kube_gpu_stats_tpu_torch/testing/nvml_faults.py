"""Faults scripted over an NVML binding: the real one on a card, or
``testing.fake_nvml.FakeNvml`` on the CPU.

:class:`NvmlFaults` wraps the binding and passes every call on, except
where a fault is scripted. It is the one place the survival suites and
sims script NVML's outages:

- ``lost``: card indexes whose every call returns
  ``NVML_ERROR_GPU_IS_LOST``, as a card that fell off the bus;
- ``stalls``: card index -> {call name: (seconds, every)}: every Nth
  call of that name on that card sleeps that long before it runs, as
  NVML's slow reads do;
- :meth:`NvmlFaults.driver_gone`: every call returns a library-level
  code (``NVML_ERROR_UNINITIALIZED`` by default), and ``nvmlInit_v2``
  and ``nvmlShutdown`` return ``NVML_ERROR_DRIVER_NOT_LOADED`` (so the
  binding's inits and shutdowns stay paired), until
  :meth:`NvmlFaults.driver_back` and an ``init`` that opens a fresh
  session: one that finds the library closed, every holder in the
  process having shut down. An init while another holder keeps the
  library open leaves the calls failing. Over the fake,
  ``driver_back(reset=True)`` also reloads it (a new session epoch,
  the counters from 0). On a card the driver stays loaded: a process
  without root cannot unload it, and an unload would end every CUDA
  context on the card;
- ``init_errors`` (``nvmlInit_v2``'s scripted returns, one per call,
  ``None`` succeeds), ``init_delay`` (seconds every init takes) and
  ``count_error`` (``nvmlDeviceGetCount_v2``'s return, a failing
  rediscovery).

``inits`` holds every ``nvmlInit_v2`` run through the wrapper: its ms
and whether it opened a fresh session.

:func:`run_scenarios` drives a started daemon built over the wrapper
(``Daemon(cfg, nvml=NvmlFaults(...))``) through the survival scenarios
and returns, per scenario, the ticks to detect and to recover, trips,
restarts, threads and the re-init's ms; a scenario whose check fails
raises ``FaultCheckFailed``. ``python -m
kube_gpu_stats_tpu_torch.testing.nvml_faults`` runs them on the real
binding in a process of their own, as the DaemonSet runs the daemon,
and prints one JSON line. No torch.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Callable, Sequence

from ..native import nvml as binding
from ..native.nvml import Nvml, NvmlError

_PER_CARD = ("uuid", "name", "minor_number", "utilization", "memory",
             "power_mw", "temperature", "energy_mj", "field_values",
             "gpm_supported", "gpm_sample_get")


class NvmlFaults:
    def __init__(self, nvml=None) -> None:
        self._nvml = nvml if nvml is not None else Nvml()
        self._lock = threading.Lock()
        self.lost: set[int] = set()
        self.stalls: dict[int, dict[str, tuple[float, int]]] = {}
        self.calls: dict[tuple[int, str], int] = {}  # (card, call) -> n
        self.gone: int | None = None
        self.loaded = True
        self.init_errors: list[int | None] = []
        self.init_delay = 0.0
        self.count_error: int | None = None
        self._index: dict[int, int] = {}  # handle -> card index
        self.inits: list[tuple[float, bool]] = []  # (ms, fresh session)

    # -- faults --------------------------------------------------------------

    def driver_gone(self, code: int = binding.NVML_ERROR_UNINITIALIZED
                    ) -> None:
        with self._lock:
            self.gone = code
            self.loaded = False

    def driver_back(self, reset: bool = True) -> None:
        """Loaded again; the calls keep failing until a fresh session."""
        reload = getattr(self._nvml, "reload", None)  # the fake only
        if reload is not None:
            reload(reset)
        with self._lock:
            self.loaded = True

    def _raise(self, code: int) -> None:
        raise NvmlError(code, self._nvml.error_string(code))

    def _gate(self, handle: int | None = None, call: str = "") -> None:
        stall = 0.0
        with self._lock:
            gone = self.gone
            card = None if handle is None else self._index.get(handle)
            if card is not None:
                key = (card, call)
                n = self.calls[key] = self.calls.get(key, 0) + 1
                seconds, every = self.stalls.get(card, {}).get(call,
                                                               (0.0, 1))
                if n % every == 0:
                    stall = seconds
        if gone is not None:
            self._raise(gone)
        if stall:
            time.sleep(stall)
        if card in self.lost:
            self._raise(binding.NVML_ERROR_GPU_IS_LOST)

    def _library_open(self) -> bool:
        """Whether some holder in the process keeps a session open."""
        try:
            self._nvml.device_count()
        except NvmlError as exc:
            return exc.code != binding.NVML_ERROR_UNINITIALIZED
        return True

    # -- the binding's surface -----------------------------------------------

    def error_string(self, code: int) -> str:
        return self._nvml.error_string(code)

    def init(self) -> None:
        with self._lock:
            scripted = self.init_errors.pop(0) if self.init_errors else None
            loaded = self.loaded
        if self.init_delay:
            time.sleep(self.init_delay)
        if scripted is not None:
            self._raise(scripted)
        if not loaded:
            self._raise(binding.NVML_ERROR_DRIVER_NOT_LOADED)
        fresh = not self._library_open()
        started = time.perf_counter()
        self._nvml.init()
        with self._lock:
            self.inits.append(((time.perf_counter() - started) * 1e3, fresh))
            if fresh:
                self.gone = None

    def shutdown(self) -> None:
        with self._lock:
            loaded = self.loaded
        if not loaded:
            self._raise(binding.NVML_ERROR_DRIVER_NOT_LOADED)
        self._nvml.shutdown()

    def driver_version(self) -> str:
        self._gate()
        return self._nvml.driver_version()

    def cuda_driver_version(self) -> int:
        self._gate()
        return self._nvml.cuda_driver_version()

    def device_count(self) -> int:
        self._gate()
        if self.count_error is not None:
            self._raise(self.count_error)
        return self._nvml.device_count()

    def handle(self, index: int) -> int:
        self._gate()
        if index in self.lost:
            self._raise(binding.NVML_ERROR_GPU_IS_LOST)
        handle = self._nvml.handle(index)
        with self._lock:
            self._index[handle] = index
        return handle

    def gpm_sample_alloc(self) -> int:
        return self._nvml.gpm_sample_alloc()

    def gpm_sample_free(self, sample: int) -> None:
        self._nvml.gpm_sample_free(sample)

    def gpm_metrics(self, sample1: int, sample2: int,
                    metric_ids: Sequence[int]):
        self._gate()
        return self._nvml.gpm_metrics(sample1, sample2, metric_ids)

    def __getattr__(self, name: str):
        if name not in _PER_CARD:
            raise AttributeError(name)
        real = getattr(self._nvml, name)

        def call(handle, *args):
            self._gate(handle, name)
            return real(handle, *args)

        return call


# -- the scenarios -----------------------------------------------------------

class FaultCheckFailed(AssertionError):
    """A survival scenario's check failed."""


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise FaultCheckFailed(message)


def _card_rows(snapshot, card: str) -> dict[str, tuple]:
    """family -> (value, labels) of card ``card``'s device series."""
    return {s.spec.name: (s.value, dict(s.labels)) for s in snapshot.series
            if dict(s.labels).get("chip") == card}


def _self_value(snapshot, family: str, component: str) -> float | None:
    for s in snapshot.series:
        if (s.spec.name == family
                and dict(s.labels).get("component") == component):
            return s.value
    return None


class _Ticks:
    """The daemon's published ticks, one at a time."""

    def __init__(self, daemon, timeout: float) -> None:
        self.registry = daemon.registry
        self.timeout = timeout
        self.seen: list = []  # every snapshot stepped through

    def next(self):
        generation = self.registry.generation
        _require(self.registry.wait_for_publish(generation, self.timeout),
                 f"no tick published within {self.timeout} s")
        snapshot = self.registry.snapshot()
        self.seen.append(snapshot)
        return snapshot

    def until(self, predicate, limit: int) -> int | None:
        """Ticks until ``predicate(snapshot)`` holds (1 = the next), or
        None when it has not after ``limit``."""
        for n in range(1, limit + 1):
            if predicate(self.next()):
                return n
        return None


def _scrape(port: int) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as resp:
        return resp.read().decode()


def _monotone(snapshots, card: str, family: str) -> bool:
    values = [rows[family][0] for rows in
              (_card_rows(s, card) for s in snapshots) if family in rows]
    return all(a <= b for a, b in zip(values, values[1:]))


def scenario_lost(daemon, faults: NvmlFaults, card: int = 0,
                  hold: int = 5, after: Callable[[], dict] | None = None
                  ) -> dict:
    """Card ``card`` lost for ``hold`` ticks: served down within 2 ticks
    with nothing of its readings served, up again within 2 ticks of the
    fault clearing; ``after`` (the card's own checks) runs then."""
    from .. import schema

    ticks = _Ticks(daemon, 10.0)
    chip = str(card)

    def up(snapshot) -> float | None:
        row = _card_rows(snapshot, chip).get(schema.DEVICE_UP.name)
        return None if row is None else row[0]

    faults.lost.add(card)
    detect = ticks.until(lambda s: up(s) == 0.0, 10)
    _require(detect is not None and detect <= 2,
             f"lost card served up for {detect} ticks")
    fabricated = []
    for _ in range(hold - detect):
        rows = _card_rows(ticks.next(), chip)
        _require(rows[schema.DEVICE_UP.name][0] == 0.0,
                 "a lost card served up")
        fabricated += [name for name in (schema.DUTY_CYCLE.name,
                                         schema.POWER.name,
                                         schema.MEMORY_USED.name)
                       if name in rows]
    _require(not fabricated, f"served for a lost card: {fabricated}")
    faults.lost.discard(card)
    recover = ticks.until(lambda s: up(s) == 1.0, 10)
    _require(recover is not None and recover <= 2,
             f"card back up only after {recover} ticks")
    out = {"detect_ticks": detect, "recover_ticks": recover,
           "trips": daemon.collector.breaker.trips_total,
           "breaker": daemon.collector.breaker.state}
    _require(out["breaker"] == "closed" and out["trips"] == 0,
             f"one lost card moved the breaker: {out}")
    if after is not None:
        out.update(after())
    return out


def scenario_driver_gone(daemon, faults: NvmlFaults, card: int = 0,
                         rounds: int = 3) -> dict:
    """The driver gone for at least ``rounds`` read rounds and until the
    breaker opens, then back: the breaker reads 2 in a scrape and the
    doctor's ``resilience`` row fails naming ``nvml``; the probe's
    shutdown closes the library and its init opens a fresh session, the
    card is up and fresh within 2 ticks of it, the breaker closed; joules
    never go back, no NVLink rate goes negative, and the process never
    stopped serving."""
    from .. import doctor, schema

    collector = daemon.collector
    ticks = _Ticks(daemon, 10.0)
    chip = str(card)
    trips = collector.breaker.trips_total
    reinits = collector.reinits_total
    inits = len(faults.inits)
    faults.driver_gone()
    gone_at = time.monotonic()
    opened = ticks.until(lambda s: _self_value(
        s, schema.BREAKER_STATE.name, "nvml") == 2.0, 200)
    _require(opened is not None, "the nvml breaker never opened")
    _require(opened > rounds, f"the breaker opened after {opened} rounds")
    stale = _card_rows(ticks.next(), chip)
    _require(stale[schema.DEVICE_UP.name][0] == 0.0
             and "stale" not in stale[schema.DEVICE_UP.name][1],
             f"under the open breaker: {stale.get(schema.DEVICE_UP.name)}")
    _require(schema.DUTY_CYCLE.name not in stale,
             "a reading served under the open breaker")
    stale_labels = sorted(name for name, (_v, labels) in stale.items()
                          if labels.get("stale") == "true")
    _require(stale_labels, "nothing labelled stale under the open breaker")
    text = _scrape(daemon.server.port)
    _require('kts_breaker_state{component="nvml"} 2' in text,
             "no kts_breaker_state{component=\"nvml\"} 2 in a scrape")
    row = doctor.resilience_result(collector)
    _require(row.status == doctor.FAIL and "nvml" in row.detail,
             f"doctor resilience: [{row.status}] {row.detail}")
    faults.driver_back()
    back_at = time.monotonic()
    probed = ticks.until(lambda s: collector.reinits_total > reinits, 200)
    _require(probed is not None, "the probe never re-initialised NVML")
    probe_inits = faults.inits[inits:]
    _require(probe_inits and probe_inits[-1][1],
             f"the probe's nvmlInit_v2 opened no fresh session (another "
             f"holder kept the library open): {probe_inits}")
    fresh = ticks.until(lambda s: (
        _card_rows(s, chip).get(schema.DEVICE_UP.name, (0.0,))[0] == 1.0
        and not any(labels.get("stale") for _v, labels
                    in _card_rows(s, chip).values())), 10)
    # The tick the probe ran in counts as the first.
    _require(fresh is not None and fresh <= 2,
             f"card fresh {fresh} ticks after the probe")
    last = ticks.next()
    _require(_self_value(last, schema.BREAKER_STATE.name, "nvml") == 0.0,
             "the breaker did not close")
    _require(_monotone(ticks.seen, chip, schema.ENERGY.name),
             "the card's joules went back")
    rates = [s.value for snap in ticks.seen for s in snap.series
             if s.spec.name == schema.ICI_BANDWIDTH.name]
    _require(all(r >= 0 for r in rates), f"a negative NVLink rate: {rates}")
    return {"detect_ticks": opened, "recover_ticks": probed + fresh - 1,
            "fresh_after_probe_ticks": fresh,
            "trips": collector.breaker.trips_total - trips,
            "reinits": collector.reinits_total - reinits,
            "reinit_ms": collector.last_reinit_ms,
            "init_ms": probe_inits[-1][0],
            "cold_init_ms": faults.inits[0][0] if faults.inits[0][1]
            else None,
            "stale_families": stale_labels, "gone_s": back_at - gone_at,
            "doctor": row.status}


def scenario_hung_tick(daemon, hang_s: float | None = None) -> dict:
    """``begin_tick`` blocks once, past the watchdog's heartbeat timeout:
    the loop is respawned, ``kts_component_restarts_total{component=
    "poll"}`` rises by 1, and ``/metrics`` answers throughout."""
    from .. import schema

    collector = daemon.collector
    release = threading.Event()
    hung = threading.Event()
    real = collector.begin_tick

    def begin_tick() -> None:
        if not hung.is_set():
            hung.set()
            release.wait(60)
        real()

    def restarts() -> float:
        return _self_value(daemon.registry.snapshot(),
                           schema.COMPONENT_RESTARTS.name, "poll") or 0.0

    before = restarts()
    threads_before = threading.active_count()
    collector.begin_tick = begin_tick
    try:
        _require(hung.wait(10), "the loop never entered the hung tick")
        started = time.monotonic()
        scrapes = 0
        generation = daemon.registry.generation
        while time.monotonic() - started < (hang_s or 60.0):
            _scrape(daemon.server.port)  # answers throughout
            scrapes += 1
            if daemon.registry.generation > generation + 2:
                break
            time.sleep(0.1)
        respawn_s = time.monotonic() - started
        _require(daemon.registry.generation > generation + 2,
                 "the loop was never respawned")
    finally:
        release.set()
        del collector.begin_tick
    ticks = _Ticks(daemon, 10.0)
    after = None
    for _ in range(20):
        ticks.next()
        after = restarts()
        if after > before:
            break
    _require(after == before + 1, f"poll restarts {before} -> {after}")
    return {"restarts": after - before, "respawn_s": respawn_s,
            "scrapes_while_hung": scrapes,
            "threads_before": threads_before,
            "threads_after": threading.active_count()}


def scenario_soak(daemon, faults: NvmlFaults, card: int = 0,
                  seconds: float = 30.0, flap_s: float = 2.0,
                  scrapers: int = 4, check: Callable[[str], list] | None
                  = None) -> dict:
    """Card ``card`` flaps between lost and back every ``flap_s`` under
    ``scrapers`` scrapers for ``seconds``: no thread leak (the count
    within 8 of where it started), every scrape clean by ``check`` (the
    exposition contract), the generation advancing."""
    from .. import validate

    check = check or validate.check
    stop = threading.Event()
    seen = {"scrapes": 0, "errors": 0}
    problems: list = []
    lock = threading.Lock()

    def scraper() -> None:
        while not stop.is_set():
            try:
                text = _scrape(daemon.server.port)
            except Exception as exc:  # noqa: BLE001 - counted
                with lock:
                    seen["errors"] += 1
                    problems.append(repr(exc))
                continue
            found = check(text)
            with lock:
                seen["scrapes"] += 1
                problems.extend(found)
            time.sleep(0.02)

    threads_before = threading.active_count()
    generation = daemon.registry.generation
    pool = [threading.Thread(target=scraper, daemon=True,
                             name=f"soak-scraper-{i}")
            for i in range(scrapers)]
    for thread in pool:
        thread.start()
    flaps = 0
    try:
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            if card in faults.lost:
                faults.lost.discard(card)
            else:
                faults.lost.add(card)
            flaps += 1
            time.sleep(min(flap_s, max(0.0, end - time.monotonic())))
    finally:
        faults.lost.discard(card)
        stop.set()
        for thread in pool:
            thread.join(timeout=15)
    time.sleep(1.0)
    threads_after = threading.active_count()
    ticks = daemon.registry.generation - generation
    interval = daemon.cfg.interval
    _require(not problems, f"soak scrapes: {problems[:5]}")
    _require(threads_after <= threads_before + 8,
             f"threads {threads_before} -> {threads_after}")
    _require(ticks >= 0.5 * seconds / interval,
             f"only {ticks} ticks in {seconds} s")
    _require(seen["scrapes"] > 0 and seen["errors"] == 0,
             f"soak scrapes: {seen}")
    return {"seconds": seconds, "flaps": flaps, "ticks": ticks,
            "scrapes": seen["scrapes"], "threads_before": threads_before,
            "threads_after": threads_after,
            "trips": daemon.collector.breaker.trips_total}


def run_scenarios(daemon, faults: NvmlFaults, *, card: int = 0,
                  soak_s: float = 30.0, flap_s: float = 2.0,
                  scrapers: int = 4,
                  after_lost: Callable[[], dict] | None = None) -> dict:
    """Every scenario in order, on a started daemon over ``faults``."""
    return {
        "lost": scenario_lost(daemon, faults, card, after=after_lost),
        "driver_gone": scenario_driver_gone(daemon, faults, card),
        "hung_tick": scenario_hung_tick(daemon),
        "soak": scenario_soak(daemon, faults, card, soak_s, flap_s,
                              scrapers),
    }


# -- on a card, in a process of its own ---------------------------------------

def _smi_memory_used_mib(card: int) -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits", "-i", str(card)],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def main(argv: Sequence[str] | None = None) -> int:
    """The NVML daemon over the real binding with faults scripted over it,
    through :func:`run_scenarios`, in this process alone (no torch, no
    other NVML holder: the probe's re-init is a real one). Prints one
    JSON line; exits 1 when a scenario's check fails."""
    from ..config import Config
    from ..daemon import Daemon
    from .. import schema

    parser = argparse.ArgumentParser(prog="python -m kube_gpu_stats_tpu_"
                                     "torch.testing.nvml_faults")
    parser.add_argument("--card", type=int, default=0)
    parser.add_argument("--interval", type=float, default=0.2)
    parser.add_argument("--soak", type=float, default=30.0)
    parser.add_argument("--flap", type=float, default=2.0)
    parser.add_argument("--scrapers", type=int, default=4)
    parser.add_argument("--duty-min", type=float, default=None,
                        help="the lost card's duty once back, at least "
                             "(a burn runs on it)")
    parser.add_argument("--mem-tol-mib", type=float, default=None,
                        help="the lost card's memory used once back, "
                             "within this of nvidia-smi's")
    args = parser.parse_args(argv)
    chip = str(args.card)
    faults = NvmlFaults()
    node = Daemon(Config(backend="nvml", interval=args.interval,
                         listen_host="127.0.0.1", listen_port=0,
                         attribution="off"), nvml=faults)

    def after_lost() -> dict:
        node.registry.wait_for_publish(node.registry.generation, 10)
        rows = _card_rows(node.registry.snapshot(), chip)
        duty = rows[schema.DUTY_CYCLE.name][0]
        used_mib = rows[schema.MEMORY_USED.name][0] / 1024**2
        smi_mib = _smi_memory_used_mib(args.card)
        if args.duty_min is not None:
            _require(duty >= args.duty_min, f"duty {duty} < {args.duty_min}"
                     f" after the lost card came back")
        if args.mem_tol_mib is not None:
            _require(abs(used_mib - smi_mib) <= args.mem_tol_mib,
                     f"memory used {used_mib} MiB not within "
                     f"{args.mem_tol_mib} MiB of nvidia-smi's {smi_mib}")
        return {"duty": duty, "memory_used_mib": used_mib,
                "smi_memory_used_mib": smi_mib}

    out: dict = {"ok": False}
    started = time.monotonic()
    node.start()
    try:
        _require(node.registry.wait_for_publish(0, 30),
                 "the faults daemon never published")
        out["scenarios"] = run_scenarios(
            node, faults, card=args.card, soak_s=args.soak,
            flap_s=args.flap, scrapers=args.scrapers, after_lost=after_lost)
        out["ok"] = True
    except FaultCheckFailed as exc:
        out["error"] = str(exc)
    finally:
        node.stop()
    out["torch_loaded"] = "torch" in sys.modules
    out["seconds"] = time.monotonic() - started
    if out["torch_loaded"]:
        out["ok"] = False
        out["error"] = "torch was imported by the daemon's process"
    print(json.dumps(out, sort_keys=True), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
