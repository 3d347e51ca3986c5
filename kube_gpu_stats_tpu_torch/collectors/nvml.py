"""The H100 node backend: NVML readings per card, one sample per tick.

The port's counterpart of the reference's ``collectors/composite.py``
(``TpuCollector``: sysfs plus the libtpu runtime-metrics RPC). On an
NVIDIA card the driver's NVML library (``native/nvml.py``) plays both
roles. Wired by ``daemon.build_collector`` for ``--backend nvml`` and by
the ``auto`` probe.

Discovery: one :class:`Device` per NVML index — ``device_id`` the index,
``device_path`` ``/dev/nvidia<minor number>``, ``uuid`` NVML's ``GPU-…``
string, ``accel_type`` from the product name through the same kind lookup
as the embedded collector (an H100 is ``gpu-h100``). NVML enumerates every
card of the node in PCI order, whatever ``CUDA_VISIBLE_DEVICES`` says.

Families per sample:

- ``utilization.gpu`` → ``accelerator_duty_cycle``;
- GPM's ``NVML_GPM_METRIC_ANY_TENSOR_UTIL`` →
  ``accelerator_tensorcore_utilization``: the share of the interval in
  which any tensor pipe was active, averaged over the SMs (the analog of
  DCGM's ``PIPE_TENSOR_ACTIVE``). ``docs/UNIFIED_SCHEMA.md`` defines the
  family as a share of the peak FLOP rate; a pipe kept busy by narrow or
  low-rate instructions reads as active here while doing fewer FLOPs, so
  this reading is an upper bound on that share;
- GPM's ``NVML_GPM_METRIC_DRAM_BW_UTIL`` →
  ``accelerator_memory_bandwidth_utilization``: DRAM bandwidth used as a
  share of the card's peak, the schema's meaning;
- memory ``used``/``total`` (``nvmlMemory_v2_t``: ``used`` leaves out the
  driver's reservation) → ``accelerator_memory_used_bytes`` /
  ``accelerator_memory_total_bytes``;
- power (mW / 1000) → ``accelerator_power_watts``;
- GPU temperature → ``accelerator_temperature_celsius``;
- per-link NVLink data counters (TX + RX, KiB × 1024) →
  ``Sample.ici_counters`` as ``link="nvlink<N>"``; the poll loop turns
  them into rates from the second tick. A link that has carried no byte
  since the driver loaded (a card without active links reads zeros), or
  whose counters are not supported, is omitted.

GPM metrics are computed between two samples of the card's counters, so
the collector keeps the previous tick's sample per card and the first
tick omits both GPM families. Where ``nvmlGpmQueryDeviceSupport`` says
no, or taking a sample fails (a container may refuse the card's counters
while the query says yes), the card has no GPM for the collector's life:
``accelerator_tensorcore_utilization`` is omitted and
``accelerator_memory_bandwidth_utilization`` is ``utilization.memory``,
the share of the last sample period in which device memory was read or
written (a time share, not a share of the peak bandwidth).
:attr:`NvmlCollector.gpm_state` says which, per card.

Not exported: NVML has no uptime reading, so ``accelerator_uptime_seconds``
is omitted, as the reference's sysfs backend omits what it cannot read.
``accelerator_energy_joules_total`` stays the poll loop's integration of
power, as in the reference.

Failures degrade one read at a time, as ``composite.assemble`` does: a
``NOT_SUPPORTED`` reading is omitted; a sample raises ``CollectorError``
(the loop serves ``accelerator_up 0``) when no reading succeeded, and at
once when the card is lost (``NVML_ERROR_GPU_IS_LOST``).

Split sampling, as the reference's ``composite.TpuCollector`` offers it
to the poll loop: :meth:`NvmlCollector.read_environment` is the blocking
half (every NVML read of a sample, run on the loop's pool), and
:meth:`NvmlCollector.assemble` the in-memory half (run on the loop
thread). With ``pipelined_wait`` the loop runs the reads of tick N+1
while tick N serves the last completed round, so a read that stalls
(on an H100 80GB HBM3 at 700 W with NVML 580.159.03, the memory and
NVLink reads took 20-113 ms in 3-4% of calls) no longer costs the card
its tick. :meth:`sample` is
``assemble(read_environment(...))``. :attr:`runtime_fetch_seq` is the
read generation the loop's rate-feed dedup keys on (:class:`_ReadRounds`).

:meth:`NvmlCollector.read_burst` is the burst sampler's read: the
instantaneous power field (``NVML_FI_DEV_POWER_INSTANT``), never the
one-second average of ``nvmlDeviceGetPowerUsage``; None, with the reason
in :attr:`NvmlCollector.burst_state`, where the card refuses the field.

``nvmlInit_v2`` runs once per collector, in the constructor (so
``--backend nvml`` fails at startup without the driver); ``nvmlShutdown``
in :meth:`close`. Rediscovery re-enumerates.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Mapping, Sequence

from . import Collector, CollectorError, Device, Sample
from .. import schema
from ..kinds import accel_type
from ..native import nvml as binding
from ..native.nvml import Nvml, NvmlError

log = logging.getLogger(__name__)

# (binding call, its reading -> {family: value}), in sample order.
_READS: tuple[tuple[str, Callable[..., Mapping[str, float]]], ...] = (
    ("utilization", lambda r: {
        schema.DUTY_CYCLE.name: float(r[0]),
        schema.MEMORY_BANDWIDTH_UTIL.name: float(r[1])}),
    ("memory", lambda r: {
        schema.MEMORY_USED.name: float(r[3]),
        schema.MEMORY_TOTAL.name: float(r[0])}),
    ("power_mw", lambda mw: {schema.POWER.name: mw / 1000.0}),
    ("temperature", lambda c: {schema.TEMPERATURE.name: float(c)}),
)

_LINK_FIELDS = (binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_TX,
                binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_RX)

# GPM metric id -> family.
_GPM_FAMILIES = (
    (binding.NVML_GPM_METRIC_ANY_TENSOR_UTIL, schema.TENSORCORE_UTIL.name),
    (binding.NVML_GPM_METRIC_DRAM_BW_UTIL, schema.MEMORY_BANDWIDTH_UTIL.name),
)
_GPM_IDS = tuple(metric_id for metric_id, _ in _GPM_FAMILIES)


class _GpmSamples:
    """One card's two GPM sample buffers: ``previous`` holds the last
    tick's counters once ``primed``.

    A pipelined read may still be filling them on a pool thread when the
    loop rediscovers: :meth:`free` then only marks them retired, and the
    read frees them when it lets go (:meth:`release`)."""

    def __init__(self, nvml) -> None:
        self.previous = nvml.gpm_sample_alloc()
        try:
            self.current = nvml.gpm_sample_alloc()
        except NvmlError:
            nvml.gpm_sample_free(self.previous)
            raise
        self.primed = False
        self._lock = threading.Lock()
        self._busy = False
        self._retired = False

    def acquire(self) -> bool:
        """Take the buffers for one read; False once they are retired."""
        with self._lock:
            if self._retired:
                return False
            self._busy = True
            return True

    def release(self, nvml) -> None:
        with self._lock:
            self._busy = False
            retired = self._retired
        if retired:
            self._free(nvml)

    def free(self, nvml) -> None:
        with self._lock:
            self._retired = True
            if self._busy:
                return  # the read in flight frees them on release
        self._free(nvml)

    def _free(self, nvml) -> None:
        for sample in (self.previous, self.current):
            try:
                nvml.gpm_sample_free(sample)
            except NvmlError as exc:
                log.warning("nvmlGpmSampleFree failed: %s", exc)


class _ReadRounds:
    """The read generation behind ``NvmlCollector.runtime_fetch_seq``.

    The poll loop replays the last interconnect rates instead of feeding
    its rate tracker while this generation stands still. On NVML the
    NVLink counters come with every other reading in ``read_environment``,
    so the generation must advance once per completed read round, never
    per tick: a pipelined tick that re-serves the last round's counters
    would otherwise feed the tracker a duplicate observation (a zero
    rate, then a doubled one).

    A round is the reads that start between two ``begin_tick`` calls.
    :meth:`join` runs on the loop thread (``wait_ready``) right before
    the loop captures the generation:

    - a blocking join (no ``max_age``: ``--no-pipeline-fetch``, the
      doctor) serves its own tick's round, so it always advances;
    - a pipelined join advances when a round newer than the last one
      counted has completed and no ``assemble`` has served it yet: the
      round the loop has just harvested. A tick that re-serves a round
      leaves the generation where it was, and so does a blocking
      fallback tick, whose reads are still running when it joins.

    A read that returns within microseconds before the join, or that
    starts a whole interval after the loop submitted it (a pool
    saturated by wedged reads), can still count a round the loop has not
    harvested.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tick = 0
        self._running: dict[int, int] = {}  # round -> reads not returned
        self._unserved: set[int] = set()  # returned, not yet assembled
        self._counted = 0  # newest round the generation counted
        self.seq = 0

    def begin_tick(self) -> None:
        with self._lock:
            self._tick += 1

    def start(self) -> int:
        with self._lock:
            tag = self._tick
            self._running[tag] = self._running.get(tag, 0) + 1
            return tag

    def finish(self, tag: int) -> None:
        with self._lock:
            left = self._running[tag] - 1
            if left:
                self._running[tag] = left
            else:
                del self._running[tag]
            if tag > self._counted:
                self._unserved.add(tag)

    def served(self, tag: int) -> None:
        with self._lock:
            self._unserved.discard(tag)

    def join(self, pipelined: bool) -> None:
        with self._lock:
            if not pipelined:
                self.seq += 1
                self._counted = self._tick
                self._unserved.clear()
                return
            done = [tag for tag in self._unserved
                    if tag not in self._running]
            if done:
                self.seq += 1
                self._counted = max(done)
                self._unserved = {tag for tag in self._unserved
                                  if tag > self._counted}


class NvmlCollector(Collector):
    name = "nvml"
    # wait_ready accepts max_age: the poll loop may run this backend in
    # pipelined-tick mode (serve the last completed read round while the
    # next one runs during the inter-tick idle).
    pipelined_wait = True

    def __init__(self, nvml=None) -> None:
        """``nvml``: the binding (or ``testing.fake_nvml.FakeNvml``);
        None loads ``libnvidia-ml.so.1``. Raises ``NvmlError`` when the
        library cannot be loaded or ``nvmlInit_v2`` fails."""
        self._nvml = nvml if nvml is not None else Nvml()
        self._nvml.init()
        self._closed = False
        # device_id -> NVML handle / UUID / NVLink link count, from
        # discover().
        self._handles: dict[str, int] = {}
        self._uuids: dict[str, str] = {}
        self._links: dict[str, int] = {}
        # device_id -> links that have carried traffic: exported from
        # their first non-zero read on.
        self._active_links: dict[str, set[int]] = {}
        # device_id -> the card's GPM samples, or None once GPM is found
        # unavailable; absent until the card's first sample.
        self._gpm: dict[str, _GpmSamples | None] = {}
        # device_id -> "on", "unsupported" or the NVML error that turned
        # GPM off for the card.
        self.gpm_state: dict[str, str] = {}
        # device_id -> why read_burst takes no sample on the card (NVML's
        # answer for the instantaneous power field).
        self.burst_state: dict[str, str] = {}
        self._rounds = _ReadRounds()

    def discover(self) -> Sequence[Device]:
        nvml = self._nvml
        devices: list[Device] = []
        handles: dict[str, int] = {}
        links: dict[str, int] = {}
        for index in range(nvml.device_count()):
            handle = nvml.handle(index)
            device_id = str(index)
            devices.append(Device(
                index=index,
                device_id=device_id,
                device_path=f"/dev/nvidia{nvml.minor_number(handle)}",
                accel_type=accel_type(nvml.name(handle)),
                uuid=nvml.uuid(handle),
            ))
            handles[device_id] = handle
            links[device_id] = self._link_count(handle)
        uuids = {device.device_id: device.uuid for device in devices}
        self._free_gpm(same={device_id for device_id, uuid in uuids.items()
                             if self._uuids.get(device_id) == uuid})
        self._handles = handles
        self._uuids = uuids
        self._links = links
        return devices

    def _link_count(self, handle: int) -> int:
        try:
            [(code, count)] = self._nvml.field_values(
                handle, [(binding.NVML_FI_DEV_NVLINK_LINK_COUNT, 0)])
        except NvmlError as exc:
            log.debug("NVLink link count unavailable: %s", exc)
            return 0
        return int(count) if code == binding.NVML_SUCCESS else 0

    # -- split sampling (poll.py): the pool runs read_environment, the
    # -- loop thread assembles every card in memory.

    def begin_tick(self) -> None:
        self._rounds.begin_tick()

    def wait_ready(self, timeout: float | None = None,
                   max_age: float | None = None) -> None:
        """The join of the loop's split tick. NVML has no batched fetch
        to wait for, so it returns at once; it only moves the read
        generation (``max_age`` set = the loop runs pipelined)."""
        self._rounds.join(pipelined=max_age is not None)

    @property
    def runtime_fetch_seq(self) -> int:
        """Completed-read-round generation (poll loop: rate-feed dedup)."""
        return self._rounds.seq

    def read_environment(self, device: Device) -> dict:
        """The blocking half: every NVML read of one card's sample.
        Raises ``CollectorError`` for a card not discovered or lost."""
        tag = self._rounds.start()
        try:
            handle = self._handles.get(device.device_id)
            if handle is None:
                raise CollectorError(f"{device.device_path}: not discovered")
            values: dict[str, float] = {}
            failures: list[NvmlError] = []
            for call, to_families in _READS:
                reading = self._read(device, call, failures, handle)
                if reading is not None:
                    values.update(to_families(reading))
            gpm = self._gpm_values(device, handle)
            if gpm is not None:
                # GPM serves the bandwidth family: not the time share.
                values.pop(schema.MEMORY_BANDWIDTH_UTIL.name, None)
                values.update(gpm)
            ici = self._nvlink(device, handle, failures)
        finally:
            self._rounds.finish(tag)
        return {"values": values, "ici": ici, "failures": failures,
                "round": tag}

    def assemble(self, device: Device, env: Mapping,
                 env_err: Exception | None = None,
                 runtime_ready: bool = True) -> Sample:
        """The in-memory half. Raises ``CollectorError`` where
        :meth:`sample` raises: the read failed, or no reading succeeded.
        ``runtime_ready`` is the loop's join verdict; NVML's join never
        misses, so it changes nothing here."""
        if env_err is not None:
            if isinstance(env_err, CollectorError):
                raise env_err
            raise CollectorError(f"{device.device_path}: {env_err}") \
                from env_err
        if "round" in env:
            self._rounds.served(env["round"])
        values = env.get("values", {})
        failures = env.get("failures", ())
        if not values:
            raise CollectorError(
                f"{device.device_path}: no NVML reading succeeded: "
                + ("; ".join(map(str, failures)) or "none is supported"))
        for exc in failures:
            log.debug("%s: reading missing: %s", device.device_path, exc)
        return Sample(device=device, values=dict(values),
                      ici_counters=dict(env.get("ici", {})))

    def sample(self, device: Device) -> Sample:
        return self.assemble(device, self.read_environment(device))

    def read_burst(self, device: Device) -> float | None:
        """The burst sampler's read: NVML's instantaneous power field,
        in watts. None where the card does not serve it (the reason goes
        to ``burst_state``): the one-second average of
        ``nvmlDeviceGetPowerUsage`` is never served in its place."""
        handle = self._handles.get(device.device_id)
        if handle is None:
            return None
        try:
            [(code, milliwatts)] = self._nvml.field_values(
                handle, [(binding.NVML_FI_DEV_POWER_INSTANT, 0)])
        except NvmlError as exc:
            if not exc.not_supported:
                raise
            code = exc.code
        if code == binding.NVML_SUCCESS:
            return milliwatts / 1000.0
        reason = NvmlError(code, self._nvml.error_string(code))
        if code != binding.NVML_ERROR_NOT_SUPPORTED:
            raise reason
        self.burst_state[device.device_id] = (
            f"NVML_FI_DEV_POWER_INSTANT: {reason}")
        return None

    def _read(self, device: Device, call: str, failures: list[NvmlError],
              *args):
        """One binding call; None when it failed (recorded in
        ``failures`` unless not supported). A lost card raises."""
        try:
            return getattr(self._nvml, call)(*args)
        except NvmlError as exc:
            if exc.code == binding.NVML_ERROR_GPU_IS_LOST:
                raise CollectorError(f"{device.device_path}: {exc}") from exc
            if not exc.not_supported:
                failures.append(exc)
            return None

    def _gpm_values(self, device: Device, handle: int
                    ) -> dict[str, float] | None:
        """This tick's GPM families; None when the card has no GPM (the
        time share then stands), empty on the card's first tick."""
        nvml = self._nvml
        device_id = device.device_id
        if device_id not in self._gpm:
            samples = self._gpm[device_id] = self._gpm_open(device, handle)
            return None if samples is None else {}
        samples = self._gpm[device_id]
        if samples is None:
            return None
        if not samples.acquire():
            return {}  # rediscovery retired them since the lookup
        try:
            nvml.gpm_sample_get(handle, samples.current)
            got = (nvml.gpm_metrics(samples.previous, samples.current,
                                    _GPM_IDS) if samples.primed else [])
        except NvmlError as exc:
            if exc.code == binding.NVML_ERROR_GPU_IS_LOST:
                raise CollectorError(f"{device.device_path}: {exc}") from exc
            # A failed read leaves no baseline: the next tick starts anew.
            samples.primed = False
            log.debug("%s: GPM reading missing: %s", device.device_path, exc)
            return {}
        finally:
            samples.release(nvml)
        samples.previous, samples.current = samples.current, samples.previous
        samples.primed = True
        return {family: float(value)
                for (_, family), (code, value) in zip(_GPM_FAMILIES, got)
                if code == binding.NVML_SUCCESS}

    def _gpm_open(self, device: Device, handle: int) -> _GpmSamples | None:
        """The card's GPM samples, or None (and why, in ``gpm_state``)
        when the card or the container does not give GPM."""
        nvml = self._nvml
        try:
            if not nvml.gpm_supported(handle):
                self.gpm_state[device.device_id] = "unsupported"
                return None
            samples = _GpmSamples(nvml)
        except NvmlError as exc:
            self.gpm_state[device.device_id] = str(exc)
            return None
        try:
            # One sample now proves the counters can be read at all.
            nvml.gpm_sample_get(handle, samples.previous)
        except NvmlError as exc:
            samples.free(nvml)
            self.gpm_state[device.device_id] = str(exc)
            log.info("%s: GPM unavailable (%s); serving NVML's memory "
                     "time share, no tensor-core utilization",
                     device.device_path, exc)
            return None
        samples.primed = True
        self.gpm_state[device.device_id] = "on"
        return samples

    def _free_gpm(self, same: frozenset[str] | set[str] = frozenset()
                  ) -> None:
        """Gives back every card's GPM samples. A card in ``same`` (still
        the same card after rediscovery) keeps a verdict of no GPM: it is
        not probed again."""
        gpm, self._gpm = self._gpm, {}
        for device_id, samples in gpm.items():
            if samples is not None:
                samples.free(self._nvml)
            elif device_id in same:
                self._gpm[device_id] = None

    def _nvlink(self, device: Device, handle: int,
                failures: list[NvmlError]) -> dict[str, int]:
        count = self._links.get(device.device_id, 0)
        if not count:
            return {}
        fields = [(field, link) for link in range(count)
                  for field in _LINK_FIELDS]
        got = self._read(device, "field_values", failures, handle, fields)
        if got is None:
            return {}
        active = self._active_links.setdefault(device.device_id, set())
        out: dict[str, int] = {}
        for link in range(count):
            (tx_code, tx), (rx_code, rx) = got[2 * link], got[2 * link + 1]
            if (tx_code != binding.NVML_SUCCESS
                    or rx_code != binding.NVML_SUCCESS):
                continue
            total = (int(tx) + int(rx)) * 1024
            if total == 0 and link not in active:
                continue
            active.add(link)
            out[f"nvlink{link}"] = total
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._free_gpm()
        try:
            self._nvml.shutdown()
        except NvmlError as exc:
            log.warning("nvmlShutdown failed: %s", exc)
