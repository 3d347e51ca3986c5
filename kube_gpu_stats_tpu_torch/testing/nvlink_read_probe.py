"""Does NVML's NVLink field read corrupt the process's heap?

    python -m kube_gpu_stats_tpu_torch.testing.nvlink_read_probe \\
        [--processes 48] [--reads 400] [--variants exact,padded,...]

With glibc's heap checks armed (``MALLOC_CHECK_=3``, and
``libc_malloc_debug.so.0`` preloaded where glibc has it), exporters
died of SIGABRT inside the poll loop's ``nvmlDeviceGetFieldValues`` for
the 36 NVLink throughput fields (18 links x TX/RX) whatever the NVML
lock and GPM did (``ROADMAP.md`` C6). This probe starts ``--processes``
fresh processes per variant (four at a time), each with the checks
armed, opening NVML on card 0 and making ``--reads`` calls on one
thread, and no other thread, no exporter:

- ``exact``: the 36-field NVLink read on an array of exactly 36
  ``nvmlFieldValue_t``, as the binding made it before the C6 repair;
- ``padded``: the same call on an array of 72 (the binding's room
  since the repair), the 36 past the count filled with a sentinel;
  counts the calls after which NVML had written past the count, and the
  furthest byte it wrote;
- ``per-link``: the ``exact`` read two fields at a time, one call per
  link;
- ``power``: the one-field instantaneous power read the burst sampler
  makes;
- ``count``: the one-field NVLink link count.

Prints the card's ``nvidia-smi`` name, power limit and driver, what was
armed, then one JSON line per variant: processes, deaths by exit code,
glibc's abort messages, and the writes past the count.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import ctypes
import json
import re
import subprocess
import sys

from ..native import nvml as binding
from .burst_soak import malloc_check_env

VARIANTS = ("exact", "padded", "per-link", "power", "count")
SENTINEL = 0xA5


def _fields(nvml, handle) -> list[tuple[int, int]]:
    [(_, count)] = nvml.field_values(
        handle, [(binding.NVML_FI_DEV_NVLINK_LINK_COUNT, 0)])
    return [(field, link) for link in range(int(count or 0))
            for field in (binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_TX,
                          binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_RX)]


def _exact_read(nvml, handle, fields) -> None:
    """One read on an array of exactly ``len(fields)`` entries."""
    values = (binding.NvmlFieldValue * len(fields))()
    for slot, (field_id, scope_id) in zip(values, fields):
        slot.fieldId = field_id
        slot.scopeId = scope_id
    nvml._check(nvml._call("nvmlDeviceGetFieldValues", handle,
                           len(fields), values))


def _padded_read(nvml, handle, fields) -> tuple[bool, int]:
    """One read on an array twice the count; (wrote past the count, the
    furthest byte past it that changed)."""
    n = len(fields)
    values = (binding.NvmlFieldValue * (2 * n))()
    size = ctypes.sizeof(binding.NvmlFieldValue) * n
    ctypes.memset(ctypes.addressof(values) + size, SENTINEL, size)
    for slot, (field_id, scope_id) in zip(values, fields):
        slot.fieldId = field_id
        slot.scopeId = scope_id
    nvml._check(nvml._call("nvmlDeviceGetFieldValues", handle, n, values))
    slack = ctypes.string_at(ctypes.addressof(values) + size, size)
    changed = [i for i, byte in enumerate(slack) if byte != SENTINEL]
    return bool(changed), (max(changed) + 1 if changed else 0)


def child(variant: str, reads: int) -> dict:
    nvml = binding.Nvml()
    nvml.init()
    handle = nvml.handle(0)
    links = _fields(nvml, handle)
    out = {"links": len(links) // 2, "past_count": 0, "furthest": 0}
    for _ in range(reads):
        if variant == "exact":
            _exact_read(nvml, handle, links)
        elif variant == "padded":
            past, furthest = _padded_read(nvml, handle, links)
            out["past_count"] += past
            out["furthest"] = max(out["furthest"], furthest)
        elif variant == "per-link":
            for i in range(0, len(links), 2):
                _exact_read(nvml, handle, links[i:i + 2])
        elif variant == "power":
            nvml.field_values(handle,
                              [(binding.NVML_FI_DEV_POWER_INSTANT, 0)])
        else:
            nvml.field_values(handle,
                              [(binding.NVML_FI_DEV_NVLINK_LINK_COUNT, 0)])
    nvml.shutdown()
    return out


def run_one(variant: str, reads: int, env: dict) -> tuple[int, str, dict]:
    proc = subprocess.run(
        [sys.executable, "-X", "faulthandler", "-m", __spec__.name,
         "--child", variant, "--reads", str(reads)],
        capture_output=True, text=True, timeout=300, env=env)
    row = {}
    if proc.returncode == 0 and proc.stdout.strip():
        row = json.loads(proc.stdout.strip().splitlines()[-1])
    return proc.returncode, proc.stderr, row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--processes", type=int, default=48)
    parser.add_argument("--reads", type=int, default=400)
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--child", choices=VARIANTS)
    args = parser.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child, args.reads)), flush=True)
        return 0
    variants = args.variants.split(",")
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        parser.error(f"unknown variants {unknown}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(card.strip(), flush=True)
    env, armed = malloc_check_env()
    print(f"malloc check: {armed}", flush=True)
    for variant in variants:
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            results = list(pool.map(
                lambda _: run_one(variant, args.reads, env),
                range(args.processes)))
        codes = collections.Counter(rc for rc, _, _ in results)
        aborts = collections.Counter(
            match.group(1) for rc, err, _ in results if rc != 0
            for match in [re.search(r"^(.*?)Fatal Python error", err,
                                    re.M)] if match)
        rows = [row for _, _, row in results if row]
        print(json.dumps({
            "variant": variant, "processes": len(results),
            "reads": args.reads, "exit_codes": dict(codes),
            "aborts": dict(aborts),
            "links": max((row["links"] for row in rows), default=None),
            "calls_past_count": sum(row["past_count"] for row in rows),
            "furthest_byte_past": max((row["furthest"] for row in rows),
                                      default=0),
            "first_death": next((err[-1500:] for rc, err, _ in results
                                 if rc != 0), None)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
