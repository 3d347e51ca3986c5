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
they render; the DaemonSet exporter (``python -m kube_gpu_stats_tpu_torch``)
on its NVML backend, with process holders and pod attribution; the
multi-card load generator (a sharded train step and an NVLink ring over
a process group of one rank per card); the exposition-contract validator
(``validate.py``); the node doctor (``doctor.py``) with the flight
recorder's read side and event journal (``tracing.py``), the server's
``/debug/*`` endpoints, TLS/mTLS and basic auth; the daemon's pipelined
sampling, host signals (``hoststats.py``) and sub-tick power burst
sampler (``burstsampler.py``); the per-pod energy accountant
(``energy.py``) on the write-ahead stores (``wal.py``); push egress
(the delta publisher with its disk spill queue, durable remote write
1.0/2.0, the Pushgateway pusher); the slice hub (``hub.py``: delta
ingest with its lanes, admission guards and warm-restart checkpoint,
the series accountant, the merged exposition with slice rollups, the
history ring behind ``/query``, the SO_REUSEPORT ingest processes, and
the fleet lens: per-target baselines, slow-node attribution, SLO burn
windows, the link localizer and the efficiency lens with its signed
attestation) and ``top``; the measurement module (``bench.py``: the
reference's measurements and its two real-mode harnesses, over NVML and
the embedded collector); the H100 deploy assets (``deploy/``); and the
entry points (``entry.py``). The daemon, hub, top and doctor paths
import no torch. Still off in the hub: the native frame fold and slot
store (the Python paths always run).

Layer map:

    cli.py, __main__.py  the daemon's command line (bare flags); the
                      loadgen, validate, doctor, hub and top subcommands
    hub.py            Hub: push sessions and pulled targets merged into
                      one exposition with slice_* rollups; main()
    history.py        HistoryStore: the rollups' bounded ring, /query
    fleetlens.py      FleetLens: per-target baselines and anomalies,
                      slow-node attribution, SLO burn windows
                      (/debug/fleet, kts_fleet_*)
    efficiency.py     EfficiencyLens: per-pod waste verdicts;
                      build_attestation (/debug/efficiency)
    linkloc.py        LinkLocalizer: link verdicts over the graph
                      (inert on nvlink<N> labels)
    ingestproc.py     IngestProcPool: SO_REUSEPORT acceptor processes
                      relaying frames to the hub (--ingest-procs)
    top.py            the live per-card table over exporters or a hub
    cardinality.py    SeriesAccountant (the hub's series ledger),
                      LabelFence (the daemon's label-churn fence)
    doctor.py         node preflight: nvml, attribution, topology, poll,
                      --url scrape and live breakers, --trace post-mortem,
                      --host summary, --energy digest, --stores health,
                      --egress and --skew, the remote-write probe, a
                      hub's --cardinality, --fleet, --efficiency, --at
    daemon.py         Daemon: backend choice, watchers, supervisor, server
    config.py         its flags and KTS_* environment
    collectors/nvml.py  NvmlCollector over native/nvml.py (ctypes NVML)
    collectors/mock.py  mock and null backends
    procopen.py       device holders from /proc/*/fd
    attribution/      pod labels from the kubelet (PodResources, checkpoint)
    supervisor.py     crash-only restarts and the /healthz reasons
    entry.py          entry(): the single-card burn step at size 512;
                      dryrun_multichip(n): one sharded step in n ranks
    loadgen/burn.py   run_burn / sweep_burn / main over every local card
                      (main --embedded-port serves the exporter meanwhile,
                      --mode ici runs the ring); make_sharded_train_step
    loadgen/mesh.py   the ("data", "model") mesh of ranks, run_ranks
    loadgen/ici_burn.py  the NVLink ring (batch_isend_irecv rotations)
    loadgen/tiled_burn.py  tiled_matmul wrapper + plain version, per-card step
    _build.py         nvcc over csrc/*.cu at first use, loaded with ctypes
    csrc/             CUDA C++ kernels
    embedded.py       TorchIntrospectCollector (steps, FLOPs, MFU, allocator
                      memory per card), EmbeddedExporter, start()
    exposition.py     MetricsServer (/metrics, /healthz, /readyz, /debug/*;
                      TLS, mTLS, basic auth), textfile, PushgatewayPusher
    delta.py          the push-delta frame codec, DeltaEncoder and
                      DeltaPublisher (node -> hub), DeltaIngest (the hub's
                      sessions, lanes, sheds, quarantine, checkpoint)
    spillq.py         the publisher's disk spill queue (a wal.SegmentRing)
    remote_write.py   RemoteWriter: remote write 1.0/2.0, durable shards
    snappy.py         snappy block codec (remote write, delta frames)
    proto/            protobuf codec: PodResources, prompb, prompb2
    testing/egress_sink.py  one receiver for all three push paths
    testing/host_fixture.py  fake /proc, /sys and cgroup trees
    tracing.py        the flight recorder: tick spans, event journal, and
                      their read side (/debug/ticks|trace|events)
    profiler.py       stack sampling behind /debug/profile;
                      profile_ingest (cProfile of the delta apply path)
    bench.py          the measurements: hub, ingest, query, stores, node
                      costs, fleet lens; try_real_harness (NVML under a
                      co-launched burn), try_embedded_harness
    poll.py           PollLoop: per-device sampling with a deadline,
                      pipelined rounds, tick plans
    hoststats.py      PSI, IRQ, NIC, thermal and pod-cgroup signals
    burstsampler.py   the sub-tick power ring behind kts_power_burst_*
    energy.py         per-pod joules, their checkpoint, the signed digest
    wal.py            write-ahead state files, segment rings, store health
    registry.py       snapshots, their Prometheus/OpenMetrics render
    schema.py         the metric families (the reference's, unchanged)
    validate.py       the accelerator_* contract checker and its parsers
    collectors/       the collector trait; workers, resilience,
                      procstats: the parts of them the stack uses
    ici.py            RateTracker, LinkBaselineEngine
    topology.py       the KTS_* labels, InterconnectGraph
    kinds.py          accel_type and the per-kind datasheet tables
    device.py         device resolution and the Hopper probe
"""

__version__ = "0.1.0"
