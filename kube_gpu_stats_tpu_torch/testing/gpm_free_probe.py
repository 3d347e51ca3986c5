"""Does freeing a refused GPM sample corrupt the process's heap?

    python -m kube_gpu_stats_tpu_torch.testing.gpm_free_probe \\
        [--processes 200] [--reads 300]

On a card whose container refuses GPM sampling (``nvmlGpmSampleGet``
answers 999, as the test machine's H100 does), the NVML exporter's first
read allocates two GPM samples, takes a refused sample and frees both;
then come its NVLink field reads. This probe starts ``--processes``
fresh processes per variant (four at a time), each of which opens NVML
on card 0, does its variant's GPM step, then ``--reads`` rounds of the
exporter's reads (the 36-field NVLink read and the one-field
instantaneous power read), and counts the processes that die of a
signal:

- ``free``: the exporter's GPM step (alloc two, refused get, free two);
- ``keep``: the same without the frees;
- ``none``: no GPM step;
- ``free-threads``: the ``free`` step on one thread, then the NVLink
  reads on a second while a third reads the power field, as the
  exporter's sampler pool and burst sampler do.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
line per variant: processes, deaths by exit code, and the first lines a
dead one printed.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import json
import subprocess
import sys
import threading

from ..native import nvml as binding

VARIANTS = ("free", "keep", "none", "free-threads")


def child(variant: str, reads: int) -> None:
    """One process's work; dies of SIGABRT if NVML corrupts its heap."""
    nvml = binding.Nvml()
    nvml.init()
    handle = nvml.handle(0)
    [(_, count)] = nvml.field_values(
        handle, [(binding.NVML_FI_DEV_NVLINK_LINK_COUNT, 0)])
    links = [(field, link) for link in range(int(count or 0))
             for field in (binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_TX,
                           binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_RX)]
    power = [(binding.NVML_FI_DEV_POWER_INSTANT, 0)]
    if variant != "none":
        samples = [nvml.gpm_sample_alloc(), nvml.gpm_sample_alloc()]
        try:
            nvml.gpm_sample_get(handle, samples[0])
        except binding.NvmlError:
            pass
        if variant != "keep":
            for sample in samples:
                nvml.gpm_sample_free(sample)

    def read_links() -> None:
        for _ in range(reads):
            nvml.field_values(handle, links)
            nvml.memory(handle)

    def read_power() -> None:
        for _ in range(reads):
            nvml.field_values(handle, power)

    if variant == "free-threads":
        threads = [threading.Thread(target=read_links),
                   threading.Thread(target=read_power)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
    else:
        for _ in range(reads):
            nvml.field_values(handle, links)
            nvml.field_values(handle, power)
    nvml.shutdown()


def run_one(variant: str, reads: int) -> tuple[int, str]:
    proc = subprocess.run(
        [sys.executable, "-X", "faulthandler", "-m", __spec__.name,
         "--child", variant, "--reads", str(reads)],
        capture_output=True, text=True, timeout=120)
    return proc.returncode, proc.stderr[:300]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--processes", type=int, default=200)
    parser.add_argument("--reads", type=int, default=300)
    parser.add_argument("--child", choices=VARIANTS)
    args = parser.parse_args(argv)
    if args.child:
        child(args.child, args.reads)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(card.strip(), flush=True)
    for variant in VARIANTS:
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            results = list(pool.map(lambda _: run_one(variant, args.reads),
                                    range(args.processes)))
        codes = collections.Counter(rc for rc, _ in results)
        dead = [err for rc, err in results if rc != 0]
        print(json.dumps({"variant": variant, "processes": len(results),
                          "exit_codes": dict(codes),
                          "first_death": dead[0] if dead else None}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
