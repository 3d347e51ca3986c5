"""kube_gpu_stats_tpu_torch — the PyTorch and CUDA port of kube_gpu_stats_tpu
for NVIDIA Hopper cards (H100).

The JAX package stays the reference; this package stands beside it and
imports neither JAX nor anything of ``kube_gpu_stats_tpu``: what it needs
from there, it keeps its own copy of. Its entry points run on the CUDA card
unless the caller passes ``device="cpu"``; without CUDA they raise rather
than fall back to the CPU.

Ported so far: the load generator's matmul burn (``loadgen/``), with the
hand-written sm_90a tiled GEMM (``csrc/tiled_gemm.cu``) that replaces the
Pallas kernel; the embedded exporter (``embedded.py``) with its own copy of
the serving stack — poll loop, registry, HTTP exposition and the schema
they render; and the flagship entry point (``entry.py``). The DaemonSet,
hub and NVML backend come in later slices.

Layer map:

    entry.py          entry point: the single-card burn step at size 512
    loadgen/burn.py   run_burn / sweep_burn / main over every local card
                      (main --embedded-port serves the exporter meanwhile)
    loadgen/tiled_burn.py  tiled_matmul wrapper + plain version, per-card step
    _build.py         nvcc over csrc/*.cu at first use, loaded with ctypes
    csrc/             CUDA C++ kernels
    embedded.py       TorchIntrospectCollector (steps, FLOPs, MFU, allocator
                      memory per card), EmbeddedExporter, start()
    exposition.py     MetricsServer (/metrics, /healthz, /readyz), textfile
    poll.py           PollLoop: per-device sampling with a deadline, tick plans
    registry.py       snapshots, their Prometheus/OpenMetrics render
    schema.py         the metric families (the reference's, unchanged)
    collectors/       the collector trait; tracing, workers, supervisor,
                      resilience, procstats, ici, wal, history, fleetlens,
                      delta, topology: the parts of them the stack uses
    device.py         device resolution and the Hopper probe
"""

__version__ = "0.1.0"
