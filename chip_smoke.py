#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``kube_gpu_stats_tpu_torch``).

Run from the repository root on a machine with one H100:

    python3 chip_smoke.py

``python3 chip_smoke.py egress:3 hub:2`` instead builds the kernel and
runs only the named phases (``daemon``, ``native``, ``doctor``, ``c5``,
``burst``, ``energy``, ``egress``, ``hub``, ``fleet``, ``faults``,
``bench``, ``sims``, ``operator``), each the given number of times, and
prints one ``phases_alone`` line with each run's outcome: the way to
measure how often a phase's check fails.

Phases, each raising on failure (so the script exits non-zero and never
prints its result line after one):

1. the card: ``nvidia-smi`` name and power limit, capability; TF32 off;
2. build the tiled GEMM kernel from ``csrc/`` (nvcc, first use) and print
   what ptxas reports for it: registers, shared memory, spills, warnings;
2b. ``native``: the host extension (``native/wirefast.cc``, built by g++ at
   first use; host code, not a kernel): the g++ version, the paths of
   ``Python.h`` and ``zlib.h`` and one fresh build's seconds; then, byte
   for byte against the Python paths on this interpreter, the render and
   gzip (levels 1, 3, 6, 9) of an 8-card daemon snapshot and of a
   ~6,000-series hub snapshot in both formats, 10,000 seeded DELTA frames
   (a tenth of them corrupted) through both decoders with equal frames or
   verdicts, snappy round trips and cut streams, and the data series of a
   65-target hub fed one seeded frame sequence with its native paths
   against the same hub under ``--no-native-ingest``; one line with the
   render, gzip, decode, snappy and apply ms of both paths;
3. hold the kernel against its plain version at small shapes, at the
   shapes that reach the edges of its design (K shorter than the ring, a
   partial last wave, the 128-wide instance, several tiles per block, two
   launches back to back) and at every shape the main path gives it (up to
   8192^3); hold the Python mirror of its plan against the kernel's own;
   check its ValueError/TypeError contract;
4. the main path at full width: ``run_burn`` at size 4096 through the
   kernel and through the torch chain (the card's SM clock and power draw
   sampled meanwhile), then the size sweep up to 8192,
   with the launch counter set to 0 before and read after, then the
   per-card burn step against its plain version;
5. trace 100 steps of the ``cuda`` burn at size 4096 with torch.profiler:
   device time per step by kernel, and the device's busy share;
6. ``entry()`` once on the card;
6b. the multi-card load generator (``multichip``), in spawned ranks so no
   process group stays up in this process: ``dryrun_multichip(1)`` over
   NCCL; one ``make_sharded_train_step`` step at the reference's default
   widths on the card held against the same step on the CPU, and its
   time; ``run_ici_burn`` for 3 s at ``shard_mb=4``; ``python -m
   kube_gpu_stats_tpu_torch loadgen --mode ici --seconds 3``;
7. the embedded exporter: ``python -m kube_gpu_stats_tpu_torch.loadgen
   --kernel cuda --size 4096 --embedded-port 0`` as a subprocess, its
   ``/metrics`` scraped while it burns (per-card steps, MFU, peak FLOPs,
   memory) and its ``/healthz``; then the same burn in this process under
   ``embedded.start(0)`` with ``step_hook=exporter.record_step`` (launch
   counter set to 0 before, read after), its exported counters held
   against the burn's own, and the burn without the exporter beside it;
   every scrape held to the ``accelerator_*`` contract by the port's
   ``validate.check`` against the scrape before it;
8. the DaemonSet exporter: ``python -m kube_gpu_stats_tpu_torch
   --backend nvml --listen-port 0 --interval 0.5 --attribution off
   --textfile-dir <tmp>`` as a subprocess, scraped once while the card
   idles and three times during the ``cuda`` burn on card 0 in this
   process (launch counter set to 0 before, read after), each scrape
   held against ``nvidia-smi`` and NVML's energy counter read beside it:
   one ``accelerator_up 1`` per card with the same UUIDs, the embedded
   exporter's ``device_path`` equal to the daemon's for the same UUID,
   duty cycle, memory used within MEM_TOL_MIB of ``nvidia-smi``'s, power,
   temperature, energy, the GPM families (or, where the container refuses
   GPM, their absence and the return code), this process among the
   card's holders, every scrape through ``validate.check``; ``python -m
   kube_gpu_stats_tpu_torch validate --two-scrapes``, the textfile,
   ``/healthz``, exit 0 on SIGTERM; then the tick, render and scrape
   costs and the median time of each bound NVML call;
8b. the node doctor: the NVML daemon at 10 Hz under the ``cuda`` burn on
   card 0 (launch counter set to 0 before, read after); ``python -m
   kube_gpu_stats_tpu_torch doctor --backend nvml --attribution off
   --json --url <daemon> --trace --host`` must exit 0, ready, with its
   ``nvml`` row matching ``nvidia-smi`` (card count, driver version),
   ``poll`` OK with every card up, ``scrape`` OK with the daemon's series
   count, ``live-resilience`` not failing, ``trace`` naming a worst phase
   no slower than the daemon's ``kts_slowest_tick_seconds`` and ``host``
   ok or warn on an enabled collector; then ``/debug/ticks|trace?last=20|
   events|threads|host|profile?seconds=1`` (the pipelined tick's contract
   on the recorded ticks: every card served up on every tick outside a
   journaled fence window, each card's reads completing once per fence
   window; the poll thread's stack; PSI present or its absence named),
   with the daemon's tick p50 while the doctor ran, during the profile
   and before it; then a second daemon with a self-signed cert from
   ``openssl`` and basic auth: HTTPS ``/metrics`` with the cert trusted
   and the credentials conforms, 401 without them, ``/healthz`` 200
   without them, the doctor's scrape row WARN, and the scrape ms over
   TLS (a fresh connection each) beside plain HTTP;
8c. ``c5``: the NVML daemon at 10 Hz under the ``cuda`` burn for 60 s,
   pipelined and then with ``--no-pipeline-fetch``, each published tick's
   ``accelerator_up`` read off ``/metrics``, its ticks off ``/debug/trace``
   and its journal; the pipelined run must serve the card down on no
   tick outside a ``pipeline_fence`` window;
8d. ``burst``: NVML's answer for the instantaneous power field on its
   own line; the daemon at ``--burst-mode auto``, armed through
   ``/debug/burst?arm=N`` idle and then for 6 s under a ``cuda`` burn
   pulsed 100 ms on and off, ``nvidia-smi``'s instantaneous and average
   draw sampled beside it and ``read_burst`` timed in this process: the
   samples at 80% of ``--burst-hz`` or more, the pulses in max - min,
   the mean within 15% of ``nvidia-smi``'s instantaneous draw, disarmed
   after the hold (where the card refuses the field: no samples, and the
   reason in the status);
8e. ``energy``: a kubelet device-plugin checkpoint that gives card 0 to
   one pod; the daemon at 10 Hz with ``--attribution checkpoint
   --burst-mode continuous --burst-hz 100`` and a write-ahead energy
   checkpoint every second signed with a random audit key, under the
   ``cuda`` burn pulsed 100 ms on and off for ENERGY_SECONDS: the pod's
   ``kts_energy_pod_joules_total`` and ``accelerator_energy_joules_total``
   over the window each within ENERGY_PHASE_TOL of NVML's energy counter
   read at the same moments, ``kts_energy_coverage_ratio`` at
   ENERGY_COVERAGE_MIN or more, checkpoint writes, every scrape through
   ``validate.check``; SIGTERM (its forced final checkpoint) and a second
   daemon on the same checkpoint whose first scrape serves a pod total no
   lower than the first daemon's last; ``doctor --energy`` OK with the key
   and FAIL with a wrong one, ``doctor --stores`` with the ``energy``
   store healthy;
8f. ``egress``: the daemon at 10 Hz under the ``cuda`` burn on card 0
   with all three push senders on — ``--hub-url`` with
   ``--hub-spill-dir``, ``--remote-write-url`` with
   ``--remote-write-protocol 2.0``, ``--remote-write-wal-dir`` and
   ``--remote-write-shards 2``, ``--pushgateway-url`` — into one
   ``testing.egress_sink`` on threads of this process; a live window,
   the sink blacked out, the recovery drain, the sink restarted at wire
   v1..v1 (a downgrade) and at a disjoint v3..v3 (counted refusals),
   then back at v1..v2. Every scrape through ``validate.check``; the
   sink's delta state, remote-write samples (plus ``job``/``instance``,
   less empty labels) and Pushgateway bodies equal the scrape of the
   same tick; spooled about once per tick in the blackout, drained ==
   spooled, none dropped, at most one resync FULL per reconnect, no
   409, every tick of the phase at the sink or among the publisher's
   ``skipped_total``; every remote-write snapshot once per shard,
   oldest-first, none pending, dropped or parked, lag under two
   intervals; ``doctor --egress|--skew`` and the ``remote-write`` row OK
   live, ``--egress`` WARN (link down) in the blackout, ``--skew`` WARN
   naming the refusal; tick p50 under 50 ms in each window; frame
   bytes, the publisher's render and encode ms, the writer's serialize
   ms and a shard WAL append's ms;
8g. ``hub``: the hub core over a 64-node H100 cluster as one hub sees
   it, on its host fast paths (the default; its ``kts_ingest_native``
   must read 1, the line's ``native_active``). ``python -m kube_gpu_stats_tpu_torch hub --interval 1
   --ingest-checkpoint <tmp> --expect-workers 64 --targets-file <tmp>`` as
   a subprocess; the NVML daemon at 10 Hz (``KTS_SLICE=h100-a
   KTS_WORKER=node-00``) pushing to it with ``--hub-url``; the ``cuda``
   burn on card 0 in this process with its embedded exporter, named in
   the targets file (pulled); 63 synthetic 8-card nodes, the port's
   ``DeltaPublisher`` on threads here, each republishing the daemon's
   newest scrape every second relabelled per card. A live window, a
   SIGTERM and restart of the hub on the same port and checkpoint, a
   second live window. Within 3 refreshes of the start and of the
   restart: 65 targets all up, 64 push-served, the daemon's and the
   embedded exporter's per-card series in the hub's ``/metrics`` equal
   to their own scrapes (the daemon's series both serve counted as
   duplicates instead), the slice rollups equal to what this script
   folds from the same refresh's inputs, 64 workers; node-00's step
   rate within 5% of the burn's own; the warm restart: 95% of sessions
   continue their delta chains, ``/readyz`` 200 only after the replay,
   the rollup whole within one refresh of it; ``top --once --json``
   rows equal the hub's merged rows, the table shows every worker and
   the footer; ``doctor --cardinality --skew --stores`` against the
   hub OK; refresh, ingest apply, RSS and series costs. The history
   ring: every generation the hub publishes read as it is published;
   ``kts_history_series`` + shed equal to the ring identities the hub
   served (the rollup series and 65 ``slice_target_up``), the slab bytes
   series x 16,320, ``/query`` listing exactly those identities; each
   ``slice_duty_cycle_mean`` bucket of ``1h`` and ``24h`` equal to the
   mean of the values published in it (within their min and max where
   a generation may lie in either of two buckets); ``at=`` 5 s back the
   nearest bucket; 304 on the ETag, gzip the same document; 200 reads
   at once from one client shed with 429 and Retry-After, counted
   exactly by ``kts_query_shed_total``; after the restart a ring with
   nothing from before it and ETags that differ at the same generation.
   A third leg: the hub restarted on the same port and checkpoint with
   ``--ingest-procs 2``; the fleet and the daemon push through the two
   ``SO_REUSEPORT`` children (both carry frames), the merged view and
   rollups exact again, chains continued, ``/readyz`` and ``/query``
   through the proxy; one child killed with SIGKILL, started again,
   every publisher pushing again and the view exact; once nothing
   pushes, the children's accepted frames equal the hub's applied ones;
   relay round trip, apply, refresh, RSS (children too) and a child's
   start time beside the single-process legs;
8h. ``fleet``: the fleet lens at the hub phase's scale. The hub with the
   lens and efficiency at their defaults, ``--interval 1``, the history
   ring and an ``--energy-audit-key``; the NVML daemon at 10 Hz as
   node-00 pushing, with the same key and a kubelet checkpoint that
   gives card 0 to the burn's pod; the ``cuda`` burn in this process with
   its exporter pulled (its poll loop given the same pod for the card);
   63 synthetic 8-card nodes, each its own pod, frozen card values and a
   step counter at the burn's rate, pushed from a process of their own
   that also reads every generation the hub publishes (each one held to the
   contract by ``validate.check`` in a third process). Windows, counted
   in hub refreshes: a warm-up past the waste warm-up with no anomaly
   and no waste; the burn paused with 4 GiB held (node-00's duty anomaly
   once, the pod ``idle-reservation`` within 8 refreshes, no other
   target or pod, recovery then the 0.0 tombstone within 4); the burn
   stepping with no step recorded (``low-goodput``, cleared); one node
   at half the step rate (``slice_straggler_ratio`` 0.5 ± 0.05); one node
   silent (``freshness`` at its third miss, its 8 last-known cards in the
   freshness burn, cleared when it pushes again); ``doctor --fleet``
   naming the straggler, the silent node and the worst node;
   ``--efficiency`` OK with the key, FAIL with a wrong one, WARN with
   none; ``--fleet --at`` and ``--efficiency --at`` inside the pause
   naming node-00 and the pod; the straggler and freshness SLO bad
   ratios equal to the refreshes seen; the worst tick node-00's own
   ``kts_slowest_tick_seconds``; the attestation (node-00's digest
   verbatim with its HMAC, totals, 7 unreachable leaves as stubs of 65);
   the ``fleet_score`` span and refresh ms, the hub's RSS, and the
   pod's steps per joule within 15% of the burn's steps/s over
   ``nvidia-smi``'s power draw;
8h2. ``faults``: the survival layer, the NVML daemon over
   ``testing.nvml_faults`` (faults scripted over the real binding) in a
   process of its own with no torch (``python -m
   kube_gpu_stats_tpu_torch.testing.nvml_faults``) at FAULTS_INTERVAL_S,
   under this process's ``cuda`` burn on card 0: card 0 lost for
   5 ticks (down within 2, nothing of it served, up within 2 of the fault
   clearing, then duty >= DUTY_MIN and memory within MEM_TOL_MIB of
   ``nvidia-smi``); NVML's answers gone until the ``nvml`` breaker
   opens (``kts_breaker_state{component="nvml"} 2`` in a scrape, the
   doctor's ``resilience`` row FAIL naming it), then back: the probe's
   real ``nvmlShutdown`` closing the library and ``nvmlInit_v2`` opening a
   fresh session under the burn, the card up and
   fresh within 2 ticks of it, joules monotone, no negative NVLink rate; a
   ``begin_tick`` hung past the watchdog's timeout (the loop respawned,
   ``kts_component_restarts_total`` +1, ``/metrics`` answering
   throughout); a FAULTS_SOAK_S soak with card 0 flapping every
   FAULTS_FLAP_S under FAULTS_SCRAPERS scrapers (threads within 8, every
   scrape through ``validate.check``, the generation advancing). The
   ``faults`` line gives each scenario's ticks to detect and recover,
   trips, restarts, threads, the re-init's ms and B1's launches;
8i. ``bench``: the measurement module (``bench.py``) at the reference's
   defaults (no cut; the line's ``cuts`` is empty): ``try_real_harness`` (the
   NVML backend through the pipelined poll loop while a co-launched
   ``python -m kube_gpu_stats_tpu_torch.loadgen --kernel cuda`` loads the
   card: card 0's duty in the loop's last snapshot at least 90, the burn
   reaped), ``try_embedded_harness`` at 4096 (the ``cuda`` burn in this
   process through B1, launch counter set to 0 before, read after: busy
   fraction at least 0.9, MFU, the sweep at 2048-8192 with no error),
   every host measurement (hub merge, delta federation, the ingest storm
   in process and through the acceptor processes, warm restart, sheds,
   the cardinality accountant, ``/query``, the partition drain, the
   degraded stores, the burst sampler, host signals, the fleet localizer
   and the efficiency lens), ``tracing.measure_overhead_ns`` and
   ``profiler.profile_ingest``: each returns a dict with the reference's
   keys and its exact figures (bytes, series, frames, sheds counted once,
   conservation, none dropped), every other figure finite; each timing
   is printed beside the budget the reference's ``tests/test_latency.py``
   pins on it, with ``budget_ok`` (reported, not required); the hub runs
   them with its host fast paths on (the default), and the delta
   federation, hub merge and ingest storm run again with them off
   (``native=False``), each pair beside its budget (``native_pairs``);
8j. ``sims``: the hub and protocol sims on the card's host, each at the
   reference's full parameters in a torch-free process of its own
   (``python -m kube_gpu_stats_tpu_torch.sims <name>``), with nothing on
   the card: ``partition`` (hub blackout over 2 NVML daemons, beyond
   bounds, drain rate and shed, TSDB blackout), ``skew`` (the wire matrix,
   a pre-negotiation hub, a daemon upgraded onto an older build's disk
   state, a hub upgraded on the same port under live publishers, a
   census-gated refusal named by the doctor), ``query`` (256 keep-alive
   readers on a refreshing hub, conditionals, the tightened gate's shed
   counted three ways, the ring's bytes) and ``cardinality`` (2 label
   bombs of 50,000 series x 10 waves beside 14 healthy pushers). Each
   child exits 0 with every figure its scenarios fix as SIMS_EXACT holds
   it and no torch loaded; the cardinality child's RSS grows less than
   384 MB. The ``sims`` line gives each sim's figures, timings and
   seconds, the query p50/p99 beside the reference's 15/25 ms pins, the
   RSS growth beside its pin and the peak it was read from, the drain
   rate beside its cap, the hub upgrade's resumed sessions and the skew
   publishers' FULLs forced by a change of the daemon's series keys
   (reported, not required);
8k. ``operator``: the operator surface, under its own SIGALRM limit of
   OPERATOR_LIMIT_S, with nothing on the card: the project's wheel built
   from this checkout (``pip wheel --no-deps --no-build-isolation``) with
   the port's sources and no built library in it, installed with
   ``--no-index --no-deps`` into a ``--system-site-packages`` venv in a
   temp dir, as the reference's ``make ci`` does; the venv's
   ``kube-tpu-stats-h100 --backend nvml`` on a free port with the host
   fast paths on (the default), its ``/metrics`` serving as many cards as
   ``nvidia-smi -L`` lists, all up, and ``/healthz``; the venv's doctor
   with its ``native`` row OK on the venv's library; the venv's hub over
   the daemon for OPERATOR_HUB_REFRESHES refreshes; every family the
   port's alert rules, recording rules and board name served by the
   daemon or the hub, or listed in ``deploy/assets.CONDITIONAL`` (none
   missing); ``helm template`` of the chart where ``helm`` exists, else
   ``helm: absent``. The ``operator`` line gives the wheel's build
   seconds, the served families, how many the assets name and how many
   of those were served, conditional or missing, and the card;
9. time the kernel, its plain version and one library call
   (``torch.mm`` with f32 out) at the main path's and the sweep's sizes,
   each as the median of batches of back-to-back calls;
10. one JSON line describing every kernel of the path;
11. every process the run started has ended: the smoke adopts its
    descendants' orphans (``PR_SET_CHILD_SUBREAPER``), stops
    multiprocessing's resource tracker, reaps what has exited and fails
    on (and stops) any that still runs; last, the ``ok`` line with the
    device.

Exits non-zero, printing no result, when CUDA is unavailable.
"""

from __future__ import annotations

import base64
import bisect
import collections
import ctypes
import gc
import gzip
import hashlib
import inspect
import json
import logging
import math
import os
import pathlib
import queue
import re
import shutil
import signal
import socket
import ssl
import stat
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zipfile

import torch

from kube_gpu_stats_tpu_torch import (_build, config, daemon, delta, doctor,
                                      embedded, history, ingestproc, schema,
                                      validate, wal)
from kube_gpu_stats_tpu_torch.deploy import assets
from kube_gpu_stats_tpu_torch.kinds import _kind_lookup, _kind_peak_flops
from kube_gpu_stats_tpu_torch.entry import dryrun_multichip, entry
from kube_gpu_stats_tpu_torch.loadgen import tiled_burn
from kube_gpu_stats_tpu_torch.loadgen.burn import (make_all_device_burn,
                                                   make_sharded_train_step,
                                                   run_burn, sweep_burn)
from kube_gpu_stats_tpu_torch.loadgen.tiled_burn import (
    tiled_all_device_burn, tiled_matmul, tiled_matmul_reference)
from kube_gpu_stats_tpu_torch.loadgen.ici_burn import run_ici_burn
from kube_gpu_stats_tpu_torch.loadgen.mesh import (run_ranks,
                                                   stop_resource_tracker)
from kube_gpu_stats_tpu_torch.native import nvml as nvml_binding
from kube_gpu_stats_tpu_torch.testing import ranks

MAIN_SIZE = 4096
SWEEP_SIZES = (1024, 2048, 4096, 8192)
BURN_SECONDS = 5.0
SWEEP_SECONDS = 3.0
TORCH_DEPTH = 16
# Kernel vs plain version: both sum exact bf16 products in f32 and differ
# only in the order of the sums.
REL_TOL = 1e-4
# Burn step vs its plain version: one bf16 ulp of a tanh output in [0.5, 1)
# is 2**-8; a product that rounds across a bf16 edge moves the output by one.
STEP_ATOL = 1e-2
# Timing: each batch replays one captured call back to back for at least
# BATCH_MS, so neither launch gaps nor the host's own time per call count;
# the median over TIMING_BATCHES batches, with their min and max.
BATCH_MS = 10.0
TIMING_BATCHES = 7
TIMING_WARMUP = 3
TRACE_STEPS = 100
SAMPLE_MS = 200
# Device memory rate per card (NVIDIA H100 datasheet), for the bound; the
# peak FLOP/s comes from the port's own device-kind table.
HBM_BYTES_PER_S = (("h100 nvl", 3.9e12), ("h100 pcie", 2.0e12),
                   ("h100", 3.35e12))
# The embedded phase: the CLI's burn length, the wait between its scrapes
# (the poll loop ticks at 1 Hz), and how long the CLI may take to come up.
EMBEDDED_SECONDS = 8.0
SCRAPE_GAP_S = 1.5
CLI_START_S = 180.0
# MFU may read a little over 100 where a tick window's FLOPs land late.
MFU_MAX = 105.0
# The daemon phase: its poll interval, the burn it watches (its three
# scrapes come 1.5 s apart, each on a fresh tick, from 3 s into the burn,
# once NVML's one-second power average has left the ramp), the checks'
# limits, the NVML calls timed, and the collection budget the tick is held
# against (BASELINE.md).
DAEMON_INTERVAL_S = 0.5
DAEMON_BURN_S = 8.0
DAEMON_SCRAPE_START_S = 3.0
DAEMON_SCRAPE_GAP_S = 1.5
DAEMON_SCRAPES = 3
DUTY_MIN = 90.0
# The burn keeps DAEMON_BATCH to twice that many steps queued (27-54 ms of
# work at 4096^3), the phase takes the interpreter's lock in
# DAEMON_SWITCH_S turns, not 5 ms, and it freezes what the earlier phases
# left on the heap, so no full collection walks it mid-burn: the scraper
# thread parses each body in this process, and with 32 steps (about 6 ms)
# queued a late burn thread left the card idle for a third of NVML's
# sample window (the fleet phase guards its burn the same way).
DAEMON_BATCH = 128
DAEMON_SWITCH_S = 0.001
POWER_TOL = 0.15
ENERGY_TOL = 0.15
NVML_CALLS = 200
TICK_BUDGET_MS = 50.0
# The daemon's per-tick sampling deadline (its --deadline default).
TICK_DEADLINE_MS = config.Config.deadline * 1e3
# The pipelined tick's freshness fence, in ticks (2x the interval).
FENCE_TICKS = 2
# Served memory used against nvidia-smi's memory.used, read right after
# the scrape: nvidia-smi reports whole MiB, and between the tick and the
# read the burn's caching allocator may map one more segment (2 or 20
# MiB). The bound is a fifteenth of the driver's reservation (480 MiB on
# an H100 80GB), which version 1 of the memory struct counted as used.
MEM_TOL_MIB = 32
# The multichip phase: the ring's length and shard, the step's timing
# (batches of STEP_CALLS steps, median of TIMING_BATCHES), and the step
# on the card against the CPU: f32 both, TF32 off, the sums of the
# products and all-reduces in another order.
ICI_SECONDS = 3.0
ICI_SHARD_MB = 4.0
STEP_CALLS = 20
SHARDED_RTOL, SHARDED_ATOL = 1e-5, 1e-6
# The doctor phase: its daemon ticks at 10 Hz (the flight recorder's ring
# of 128 ticks then spans 12.8 s); the burn runs in chunks until the
# doctor and the /debug fetches are done, from DOCTOR_BURN_LEAD_S in;
# the profile's ticks are held against the DOCTOR_WINDOW ticks before it;
# the TLS leg times DOCTOR_TLS_SCRAPES scrapes of each kind.
DOCTOR_INTERVAL_S = 0.1
DOCTOR_BURN_CHUNK_S = 2.0
DOCTOR_BURN_LEAD_S = 2.0
DOCTOR_WINDOW = 10
DOCTOR_TLS_SCRAPES = 20
DOCTOR_PASSWORD = "chip-smoke"
# The c5 phase: the NVML daemon at 10 Hz under the cuda burn for 60 s
# (600 ticks), pipelined and with --no-pipeline-fetch; the burn runs in
# chunks of C5_BURN_CHUNK_S.
C5_INTERVAL_S = 0.1
C5_SECONDS = 60.0
C5_BURN_CHUNK_S = 5.0
# The burst phase: the sampler at BURST_HZ, armed for BURST_IDLE_ARM_S
# idle, then for BURST_ARM_S from BURST_LEAD_S into a burn pulsed
# BURST_PULSE_MS on and off; nvidia-smi beside it every BURST_SMI_MS. Its
# checks: samples at BURST_RATE_MIN of the rate or more; the pulsed
# max - min at least BURST_SPREAD_X_IDLE times the idle one and
# BURST_SPREAD_MIN_W; the burst mean within BURST_MEAN_TOL of
# nvidia-smi's instantaneous draw over the same window.
BURST_HZ = 100.0
BURST_IDLE_ARM_S = 2.0
BURST_ARM_S = 6.0
BURST_LEAD_S = 3.0
BURST_CHUNK_S = 2.0
BURST_PULSE_MS = 100.0
BURST_SMI_MS = 50
BURST_RATE_MIN = 0.8
BURST_SPREAD_X_IDLE = 3.0
BURST_SPREAD_MIN_W = 100.0
BURST_MEAN_TOL = 0.15
# The energy phase: the daemon at ENERGY_INTERVAL_S with the sampler
# continuous at BURST_HZ and a checkpoint every ENERGY_CKPT_INTERVAL_S;
# ENERGY_LEAD_S of burn before the window of ENERGY_SECONDS opens; the
# joules over the window within ENERGY_PHASE_TOL of NVML's counter; the
# burst share of the integrated time at least ENERGY_COVERAGE_MIN; the
# checkpoint's write timed ENERGY_FSYNC_WRITES times in this process.
ENERGY_INTERVAL_S = 0.1
ENERGY_CKPT_INTERVAL_S = 1.0
ENERGY_LEAD_S = 2.0
ENERGY_SECONDS = 8.0
ENERGY_PHASE_TOL = 0.10
ENERGY_COVERAGE_MIN = 0.8
ENERGY_FSYNC_WRITES = 20
ENERGY_POD_UID = "0c1d2e3f-4a5b-6c7d-8e9f-a0b1c2d3e4f5"
# The egress phase: the daemon at EGRESS_INTERVAL_S, the delta publisher
# free to push every tick (EGRESS_PUSH_INTERVAL_S), remote write every
# EGRESS_RW_INTERVAL_S; a live window of EGRESS_LIVE_S, the sink blacked
# out for EGRESS_BLACKOUT_S, each drain capped at EGRESS_RECOVERY_MAX_S;
# the burn in chunks of EGRESS_BURN_CHUNK_S; a shard WAL append timed
# EGRESS_WAL_WRITES times.
EGRESS_INTERVAL_S = 0.1
EGRESS_PUSH_INTERVAL_S = 0.01
EGRESS_RW_INTERVAL_S = 0.5
EGRESS_LIVE_S = 8.0
EGRESS_BLACKOUT_S = 6.0
EGRESS_RECOVERY_MAX_S = 20.0
EGRESS_BURN_CHUNK_S = 2.0
EGRESS_WAL_WRITES = 20
# The hub phase: one hub over a 64-node H100 cluster — the real node (the
# NVML daemon, pushing) plus 63 synthetic 8-card nodes (pushing) and the
# burn's embedded exporter (pulled from the targets file).
HUB_INTERVAL_S = 1.0
HUB_NODES = 64
HUB_CARDS = 8
HUB_SLICE = "h100-a"
HUB_DAEMON_INTERVAL_S = 0.1
HUB_EMBEDDED_INTERVAL_S = 0.05
HUB_LIVE_S = 10.0
HUB_LIVE2_S = 5.0
HUB_BURN_CHUNK_S = 2.0
HUB_CONVERGE_REFRESHES = 3
HUB_RATE_TOL = 0.05
HUB_RATE_REFRESHES = 8
HUB_WARM_MIN = 0.95
STOP_GRACE_HUB_S = 15.0
# The hub's history ring: the phase reads every generation the hub
# publishes (a poll every HUB_POLL_S). Where /query did not report a
# generation's commit time, it lies after the last read that still
# answered an older generation and before HUB_COMMIT_EARLY_S past the
# moment this script saw it (the ring commits just after the publish).
# A bucket's mean and the mean of its generations' values (the same
# floats, summed in another order) agree within HISTORY_REL_TOL. The
# stampede: HUB_STAMPEDE /query reads from this one client against the
# hub's default 50 qps, burst 100.
HUB_POLL_S = 0.05
HUB_COMMIT_EARLY_S = 0.25
HISTORY_REL_TOL = 1e-9
HUB_STAMPEDE = 200
HUB_STAMPEDE_THREADS = 16
HUB_QUERY_QPS, HUB_QUERY_BURST = 50.0, 100.0
# The third leg: the hub restarted with --ingest-procs HUB_PROCS; its
# live window, and HUB_PROBES relay probes each way.
HUB_PROCS = 2
HUB_LIVE3_S = 8.0
HUB_PROBES = 40
HUB_RESPAWN_S = 20.0
# This process holds the burn, the embedded exporter the hub pulls, the
# daemon's watcher and 63 publisher threads: the phase takes the
# interpreter's lock in HUB_SWITCH_S turns, not 5 ms, and freezes what
# the earlier phases left on the heap, as the fleet phase does, so a
# waiting server or watcher thread gets its turn within a refresh.
HUB_SWITCH_S = 0.001
# The faults phase: the NVML daemon in a process of its own over
# testing.nvml_faults at FAULTS_INTERVAL_S under the cuda burn on card 0;
# its soak flaps card 0 every FAULTS_FLAP_S for FAULTS_SOAK_S under
# FAULTS_SCRAPERS scrapers; the burn warms for FAULTS_LEAD_S first and
# ends by FAULTS_MAX_S at the latest.
FAULTS_INTERVAL_S = 0.2
FAULTS_SOAK_S = 30.0
FAULTS_FLAP_S = 2.0
FAULTS_SCRAPERS = 4
FAULTS_LEAD_S = 2.0
FAULTS_MAX_S = 300.0
# After its burn, the phase waits (at most FAULTS_IDLE_S) until card 0's
# utilization reads 0: NVML averages it over a trailing window, and a
# harness of the next phase would read the faults burn's load as its own
# burn's.
FAULTS_IDLE_S = 30.0
# The sims phase: each hub and protocol sim in a torch-free child at the
# reference's full parameters, each child ended by SIMS_MAX_S; the phase
# aims to stay under SIMS_SOFT_S in all.
SIMS_PHASE = ("partition", "skew", "query", "cardinality")
SIMS_MAX_S = 300.0
SIMS_SOFT_S = 120.0
# The operator surface: the wheel built from this checkout into a venv,
# its console script's daemon and hub, every family the rule files and
# the board name held to their live bodies, all within one SIGALRM limit.
OPERATOR_LIMIT_S = 120
OPERATOR_SCRIPT = "kube-tpu-stats-h100"
OPERATOR_DAEMON_INTERVAL_S = 0.5
OPERATOR_HUB_REFRESHES = 3
OPERATOR_STEP_S = 30.0
# The figures each sim's scenarios fix, as the CPU tests hold them equal
# to the reference's (tests/test_torch_sim_<name>.py).
SIMS_EXACT = {
    "partition": {
        "blackout.daemons": 2, "blackout.dropped": 0, "blackout.lost": 0,
        "blackout.resyncs": 0, "blackout.drained_to_zero": True,
        "blackout.full_amplification": False,
        "blackout.live_resumed": True, "blackout.journaled": True,
        "bounds.frames": 401, "bounds.dropped": 278, "bounds.drained": 123,
        "bounds.oldest_first": True, "bounds.journaled": True,
        "bounds.left": 0, "bounds.accounting_closes": True,
        "drain.backlog": 80, "drain.rate_cap": 25.0, "drain.undrained": 0,
        "drain.over_rate": False, "drain.faster_than_knob": False,
        "drain.shed_honoured": True, "drain.fulls_under_shed": 1,
        "drain.fulls": 1, "drain.resyncs": 0, "drain.stuck": 0,
        "tsdb.requests": 21, "tsdb.expected": 21, "tsdb.backlog": 0,
        "tsdb.in_order": True, "tsdb.lag_metered": True,
        "tsdb.dropped_in_bounds": 0, "tsdb.bounds_snapshots": 120,
        "tsdb.bounds_dropped": 103, "tsdb.bounds_delivered": 17,
        "tsdb.bounds_oldest_first": True, "tsdb.bounds_stuck": 0},
    "skew": {
        "matrix.negotiated": {"old": 1, "new": 2, "vs-old": 1},
        "matrix.upgrades": 1,
        "matrix.refusals": {"old": 0, "new": 0, "vs-old": 0},
        "matrix.version_fulls": {"old": 0, "new": 0, "vs-old": 0},
        "matrix.census": {"wire-v1": 1, "current": 1},
        "prenegotiation.downgraded": True, "prenegotiation.negotiated": 1,
        "prenegotiation.version_fulls": 0, "prenegotiation.resyncs": 0,
        "daemon-upgrade.recovered": 5, "daemon-upgrade.reencoded": 1,
        "daemon-upgrade.undecodable": 1, "daemon-upgrade.drained": True,
        "daemon-upgrade.totals_kept": True,
        "daemon-upgrade.future_loaded": False,
        "daemon-upgrade.aside_identical": True,
        "daemon-upgrade.quarantined": 1,
        "hub-upgrade.sessions": 3, "hub-upgrade.negotiated_up": True,
        "hub-upgrade.resyncs": 0, "hub-upgrade.over_one_full": 0,
        "hub-upgrade.census_flipped": True,
        "hub-upgrade.census": {"current": 3},
        "stuck-skew.pushes": 0, "stuck-skew.journal_events": 1,
        "stuck-skew.doctor": "warn", "stuck-skew.doctor_names_peer": True},
    "query": {
        "readers": 256, "requests": 1024, "reader_errors": 0,
        "ring_bytes": 2872320, "ring_bound": 16711680, "ring_flat": True,
        "shed": True, "shed_equals_gate": True,
        "exported_equals_gate": True, "bad_retry_after": 0,
        "other_statuses": []},
    "cardinality": {
        "attempted": 1_000_000, "bomb_shed": [495_000, 495_000],
        "bomb_statuses": {"200": 20}, "intruder_at_cap": [413, True],
        "live_at_peak": 700, "shed_rows": 4, "shed_total": 993_841,
        "exported_equal": True, "debug_equal": True, "healthy_equal": True,
        "healthy_failed": 0, "evicted_idle": 500, "late_joiner": 200,
        "rss_growth_under_pin": True},
}
SIMS_RATIO_FLOOR = 0.5
SIMS_RSS_PIN_MB = 384
STARTED = time.monotonic()
MIB = 1024**2
ROOT = pathlib.Path(__file__).resolve().parent
KERNEL_NAME = "tiled_gemm_bf16_f32"
KERNEL_SOURCE = "kube_gpu_stats_tpu_torch/csrc/tiled_gemm.cu"
KERNEL_REPLACES = "kube_gpu_stats_tpu/loadgen/pallas_burn.py:46"
KERNEL_DESIGN = ("wgmma m64n256k16 / m64n128k16 + TMA, 4- or 6-stage mbarrier"
                 " ring, warp-specialised, persistent grouped tiles")


def require(cond: bool, message: str) -> None:
    if not cond:
        raise RuntimeError(message)


def emit(tag: str, payload) -> None:
    print(json.dumps({tag: payload}), flush=True)


def randn_bf16(shape, seed: int) -> torch.Tensor:
    gen = torch.Generator("cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


def _batch_ms(run, calls: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def time_ms(fn) -> dict:
    """Device time of one call of ``fn``: a CUDA graph of one call, replayed
    back to back in TIMING_BATCHES batches of at least BATCH_MS, one event
    pair around each batch. Returns the median, min and max per call, and
    the calls per batch. ``eager_ms`` is the same over eager calls, where
    the host's time per call shows whenever it exceeds the device's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(TIMING_WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    calls = max(1, math.ceil(BATCH_MS / _batch_ms(graph.replay, 1)))
    per_call = [_batch_ms(graph.replay, calls)
                for _ in range(TIMING_BATCHES)]
    eager = statistics.median(_batch_ms(fn, calls) for _ in range(3))
    del graph
    return {"ms": statistics.median(per_call), "min_ms": min(per_call),
            "max_ms": max(per_call), "calls_per_batch": calls,
            "eager_ms": eager}


class CardSampler:
    """The card's SM clock and power draw from ``nvidia-smi``, sampled every
    SAMPLE_MS while the with-block runs; ``summary`` holds their medians and
    extremes afterwards."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", str(SAMPLE_MS)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc) -> None:
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        mhz, watts = [], []
        for line in out.splitlines():
            try:
                clock, power = map(float, line.split(","))
            except ValueError:  # "[N/A]" or a cut line
                continue
            mhz.append(clock)
            watts.append(power)
        self.summary = {"samples": len(mhz)}
        if mhz:
            self.summary.update(
                sm_mhz=statistics.median(mhz), sm_mhz_min=min(mhz),
                power_w=statistics.median(watts), power_w_max=max(watts))


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    capability = torch.cuda.get_device_capability(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("card", {"nvidia_smi": card, "torch_name": name,
                  "capability": list(capability),
                  "torch": torch.__version__, "cuda": torch.version.cuda,
                  "python": sys.version.split()[0]})
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    tiled_burn._kernel()
    seconds = time.perf_counter() - t0
    report = _build.ptxas_report(_build.build_log())
    emit("build", {"seconds": seconds, **report})
    require(report["kernels"], "ptxas reported no kernel")
    for line in report["warnings"]:
        print(f"build warning: {line}", flush=True)


def check(got: torch.Tensor, want: torch.Tensor, what: dict) -> float:
    """max |got - want|, which must be within REL_TOL * max |want|."""
    m, n = want.shape
    require(got.dtype == torch.float32 and got.shape == (m, n),
            f"bad output {got.dtype} {tuple(got.shape)}")
    require(bool(torch.isfinite(got).all()), "non-finite output")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    emit("check", {**what, "max_abs_err": err, "max_abs_plain": scale,
                   "limit": REL_TOL * scale})
    require(err <= REL_TOL * scale,
            f"kernel disagrees at {what}: {err} > {REL_TOL * scale}")
    return err


def phase_correctness() -> float:
    """Returns max |kernel - plain| at the main path's shape."""
    cases = [  # (m, k, n, tiles)
        (256, 512, 384, dict(tile_m=128, tile_n=128, tile_k=128)),
        (128, 1024, 128, dict(tile_m=128, tile_n=128, tile_k=256)),
        (384, 384, 384, {}),  # the 128-wide instance
        (128, 128, 128, {}),  # K shorter than the ring
        # 9 x 10 tiles of 128 x 128 on a partial wave; 10 K stages, not a
        # multiple of the ring's 6
        (1152, 640, 1280, {}),
    ] + [(size, size, size, {}) for size in SWEEP_SIZES]  # the main path's
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    main_err = None
    for seed, (m, k, n, tiles) in enumerate(cases):
        plan = tiled_burn.gemm_plan(m, n, sms)
        require(plan == tiled_burn.kernel_plan(m, n, sms),
                f"plan mirror {plan} != the kernel's at {(m, k, n)}")
        a = randn_bf16((m, k), 2 * seed)
        b = randn_bf16((k, n), 2 * seed + 1)
        before = tiled_burn.launches
        got = tiled_matmul(a, b, **tiles)
        want = tiled_matmul_reference(a, b)
        torch.cuda.synchronize()
        require(tiled_burn.launches == before + 1,
                "the launch counter did not move")
        err = check(got, want, {"m": m, "k": k, "n": n, "tiles": tiles,
                                "block_n": plan[0], "grid": plan[1]})
        if (m, k, n) == (MAIN_SIZE,) * 3:
            main_err = err
        del a, b, got, want

    # Two launches back to back on new inputs, no synchronisation between.
    pairs = [(randn_bf16((2048, 1024), 50 + i), randn_bf16((1024, 1536), 60 + i))
             for i in range(2)]
    outs = [tiled_matmul(a, b) for a, b in pairs]
    for i, ((a, b), got) in enumerate(zip(pairs, outs)):
        check(got, tiled_matmul_reference(a, b),
              {"m": 2048, "k": 1024, "n": 1536, "back_to_back": i})
    del pairs, outs

    def raises(exc, fn) -> bool:
        try:
            fn()
        except exc:
            return True
        return False

    z = torch.zeros
    bf16 = dict(dtype=torch.bfloat16, device="cuda")
    require(raises(ValueError, lambda: tiled_matmul(
        z((128, 128), **bf16), z((256, 128), **bf16))), "K mismatch passed")
    require(raises(ValueError, lambda: tiled_matmul(
        z((100, 128), **bf16), z((128, 128), **bf16), tile_m=100)),
        "tile_m=100 passed")
    require(raises(TypeError, lambda: tiled_matmul(
        z((128, 128), device="cuda"), z((128, 128), device="cuda"))),
        "f32 inputs passed")
    require(raises(ValueError, lambda: tiled_matmul(
        z((256, 256), **bf16).t()[:128], z((256, 128), **bf16))),
        "a non-contiguous input passed")
    emit("contract", "ok")
    return main_err


class StepCounter:
    """Stands in for the embedded exporter's record_step."""

    def __init__(self) -> None:
        self.steps = 0
        self.flops = 0.0
        self.seconds = 0.0

    def __call__(self, n: int, *, seconds: float, flops: float) -> None:
        self.steps += n
        self.seconds += seconds
        self.flops += flops


def run_main_burn(kernel: str, depth: int) -> tuple[int, int, float]:
    """One run_burn at MAIN_SIZE; returns (steps, devices, steps/s)."""
    hook = StepCounter()
    result: dict = {}
    with CardSampler() as sampler:
        steps = run_burn(seconds=BURN_SECONDS, size=MAIN_SIZE,
                         report_every=1e9, kernel=kernel, step_hook=hook,
                         depth=depth, result=result)
    per_step = 2 * MAIN_SIZE**3 * result["devices"]
    if kernel == "torch":
        per_step *= depth
    emit("run_burn", {"kernel": kernel, "steps": steps,
                      "hook_steps": hook.steps, "hook_flops": hook.flops,
                      "hook_seconds": hook.seconds, "card": sampler.summary,
                      **result})
    require(steps > 0, f"{kernel}: no steps")
    require(set(result) == {"steps_per_s", "tflops_per_s", "devices", "size",
                            "depth"}, f"{kernel}: result keys {sorted(result)}")
    require(result["depth"] == (depth if kernel == "torch" else None),
            f"{kernel}: depth {result['depth']}")
    require(hook.steps == steps, f"{kernel}: hook saw {hook.steps} steps")
    require(math.isclose(hook.flops, per_step * steps, rel_tol=1e-12),
            f"{kernel}: hook FLOPs {hook.flops} != {per_step} x {steps}")
    require(result["tflops_per_s"] > 0, f"{kernel}: no throughput")
    return steps, result["devices"], result["steps_per_s"]


def phase_main_path() -> tuple[int, float]:
    """The port's main path; returns the kernel launches it made and the
    ``cuda`` burn's steps/s."""
    tiled_burn.launches = 0
    steps, n_devices, cuda_steps_per_s = run_main_burn("cuda", TORCH_DEPTH)
    cuda_launches = tiled_burn.launches
    run_main_burn("torch", TORCH_DEPTH)
    torch_launches = tiled_burn.launches - cuda_launches
    rows = sweep_burn(SWEEP_SIZES, seconds_per_size=SWEEP_SECONDS,
                      kernel="cuda")
    launches = tiled_burn.launches
    for row in rows:
        emit("sweep", row)
    emit("launches", {"run_burn_cuda": cuda_launches,
                      "run_burn_torch": torch_launches,
                      "main_path": launches})
    # One launch per card per step, plus the first (warm-up) step.
    require(cuda_launches == (steps + 1) * n_devices,
            f"{cuda_launches} launches for {steps} steps on {n_devices} cards")
    require(torch_launches == 0, "the torch chain launched the tiled kernel")
    for row in rows:
        require("error" not in row and "skipped" not in row,
                f"sweep row failed: {row}")
        require(row["tflops_per_s"] > 0 and "mfu_pct" in row,
                f"sweep row incomplete: {row}")
    require(launches > cuda_launches, "the sweep did not launch the kernel")

    # What comes out: the per-card step against its plain version, and the
    # torch chain's output finite.
    step, xs, ws, _, _ = tiled_all_device_burn(MAIN_SIZE)
    outs = step(xs, ws)
    for x, w, out in zip(xs, ws, outs):
        want = torch.tanh(tiled_matmul_reference(x, w)).to(torch.bfloat16)
        err = (out.float() - want.float()).abs().max().item()
        require(out.shape == x.shape and out.dtype == torch.bfloat16,
                f"step output {out.dtype} {tuple(out.shape)}")
        require(err <= STEP_ATOL, f"burn step disagrees: {err}")
    step, xs, ws, _, _ = make_all_device_burn(MAIN_SIZE, TORCH_DEPTH)
    outs = step(xs, ws)
    torch.cuda.synchronize()
    for out in outs:
        require(bool(torch.isfinite(out.float()).all()),
                "torch chain output not finite")
    emit("step_outputs", "ok")
    return launches, cuda_steps_per_s


def phase_trace() -> None:
    """Where the ``cuda`` burn step's device time goes at MAIN_SIZE."""
    step, xs, ws, _, _ = tiled_all_device_burn(MAIN_SIZE)
    for _ in range(10):
        xs = step(xs, ws)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACE_STEPS):
            xs = step(xs, ws)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        emit("trace", "not measured: the profiler saw no device time")
        return
    per_kernel: collections.Counter = collections.Counter()
    for e in kernels:
        per_kernel[e.name[:80]] += e.time_range.elapsed_us()
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels))
    emit("trace", {
        "steps": TRACE_STEPS, "size": MAIN_SIZE,
        "step_ms_host_clock": wall_s / TRACE_STEPS * 1e3,
        "device_busy_share": sum(per_kernel.values()) / span_us,
        "device_us_per_step": {k: v / TRACE_STEPS
                               for k, v in per_kernel.most_common()}})


def phase_entry() -> None:
    fn, (x, w) = entry()
    y = fn(x, w)
    torch.cuda.synchronize()
    require(y.shape == (512, 512) and y.dtype == torch.bfloat16
            and y.is_cuda, f"entry output {y.dtype} {tuple(y.shape)}")
    require(bool(torch.isfinite(y.float()).all()), "entry output not finite")
    emit("entry", {"shape": list(y.shape), "dtype": str(y.dtype)})


def conforms(text: str, previous: str | None, what: str) -> None:
    """The scrape holds to the ``accelerator_*`` contract, and its
    counters did not go backwards since ``previous``."""
    problems = validate.check(text, previous)
    require(not problems, f"{what}: {problems[:10]}")


def scrape(port: int, path: str = "/metrics") -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as resp:
        require(resp.status == 200, f"{path} answered {resp.status}")
        return resp.read().decode()


def per_card(series, name: str) -> dict[int, float]:
    """chip index -> value of one per-device family."""
    return {int(labels["chip"]): value
            for family, labels, value in series if family == name}


def one(series, name: str) -> float:
    values = [value for family, _, value in series if family == name]
    require(len(values) == 1, f"{name}: {len(values)} series")
    return values[0]


def check_card_families(series, n_cards: int) -> dict:
    """What the embedded exporter must serve for every card during the
    ``cuda`` burn at MAIN_SIZE; returns chip -> steps."""
    ups = [labels for family, labels, value in series
           if family == schema.DEVICE_UP.name and value == 1.0]
    require(len(ups) == n_cards, f"{len(ups)} accelerator_up series at 1 "
            f"for {n_cards} cards")
    for labels in ups:
        require(labels["accel_type"] == "gpu-h100",
                f"accel_type {labels['accel_type']!r}")
        # NVML is there: the minor number's file, never the UUID.
        require(re.fullmatch(r"/dev/nvidia\d+", labels["device_path"])
                is not None, f"device_path {labels['device_path']!r}")
    info = [labels for family, labels, _ in series
            if family == schema.SELF_INFO.name]
    require(len(info) == 1 and info[0]["backend"] == "torch-embedded",
            f"exporter info {info}")
    steps = per_card(series, schema.WORKLOAD_STEPS.name)
    require(len(steps) == n_cards and min(steps.values()) > 0,
            f"steps {steps}")
    peak = per_card(series, schema.PEAK_FLOPS.name)
    require(set(peak.values()) == {989e12}, f"peak FLOP/s {peak}")
    used = per_card(series, schema.MEMORY_USED.name)
    total = per_card(series, schema.MEMORY_TOTAL.name)
    high = per_card(series, schema.MEMORY_PEAK.name)
    # Between two steps the burn holds x and w (bf16, size^2 each): the
    # fresh output has just replaced x. Within a step it also holds the
    # f32 product and its f32 tanh, so the allocator's peak is at least
    # x + w + 2 f32 blocks.
    live = 2 * MAIN_SIZE**2 * 2
    step_peak = live + 2 * MAIN_SIZE**2 * 4
    for chip in range(n_cards):
        free_total = torch.cuda.mem_get_info(chip)[1]
        require(used[chip] >= live, f"card {chip}: used {used[chip]} < {live}")
        require(used[chip] <= total[chip], f"card {chip}: used > total")
        require(high[chip] >= max(used[chip], step_peak),
                f"card {chip}: peak {high[chip]}")
        require(total[chip] == free_total,
                f"card {chip}: total {total[chip]} != mem_get_info "
                f"{free_total}")
    count = one(series, schema.WORKLOAD_STEP_DURATION.name + "_count")
    require(all(v == count for v in steps.values()),
            f"step histogram count {count} != steps {steps}")
    return steps


def embedded_cli() -> dict:
    """The user's entry point: the loadgen CLI with the embedded exporter,
    scraped over HTTP while it burns."""
    cmd = [sys.executable, "-m", "kube_gpu_stats_tpu_torch.loadgen",
           "--kernel", "cuda", "--size", str(MAIN_SIZE),
           "--seconds", str(EMBEDDED_SECONDS), "--embedded-port", "0"]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(line) for line in proc.stdout] + [
            lines.put(None)], daemon=True)
    reader.start()
    out: list[str] = []

    def next_line(deadline: float) -> str | None:
        line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
        if line is not None:
            out.append(line.rstrip("\n"))
        return line

    try:
        deadline = time.monotonic() + CLI_START_S
        port = None
        while port is None:
            line = next_line(deadline)
            require(line is not None, f"the CLI exited before serving: {out}")
            if line.startswith("embedded-exporter-port:"):
                port = int(line.split(":", 1)[1])
        n_cards = torch.cuda.device_count()
        # Scrape 1: the first one with steps counted; then two more,
        # SCRAPE_GAP_S apart, while the burn runs.
        deadline = time.monotonic() + CLI_START_S
        previous = None
        while True:
            text = scrape(port)
            conforms(text, previous, "embedded CLI scrape")
            previous = text
            series = validate.parse_exposition(text)
            steps = per_card(series, schema.WORKLOAD_STEPS.name)
            if steps and min(steps.values()) > 0:
                break
            require(time.monotonic() < deadline, "no steps counted")
            time.sleep(0.2)
        scrapes = [(time.monotonic(), series)]
        for _ in range(2):
            time.sleep(SCRAPE_GAP_S)
            text = scrape(port)
            conforms(text, previous, "embedded CLI scrape")
            previous = text
            scrapes.append((time.monotonic(), validate.parse_exposition(text)))
        healthz = scrape(port, "/healthz")
        require(healthz == "ok\n", f"/healthz said {healthz!r}")
        steps_seen = [check_card_families(series, n_cards)
                      for _, series in scrapes]
        for before, after in zip(steps_seen, steps_seen[1:]):
            require(all(after[c] > before[c] for c in before),
                    f"steps did not rise between scrapes: {steps_seen}")
        mfu = per_card(scrapes[-1][1], schema.WORKLOAD_MFU.name)
        require(len(mfu) == n_cards
                and all(0 < v <= MFU_MAX for v in mfu.values()),
                f"MFU {mfu}")
        rc = proc.wait(timeout=EMBEDDED_SECONDS + 120)
        while next_line(time.monotonic() + 10) is not None:
            pass
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    require(rc == 0, f"the CLI exited {rc}: {out}")
    steady = [json.loads(line)["steady_state"] for line in out
              if line.startswith('{"steady_state"')]
    require(len(steady) == 1, f"no steady_state line: {out}")
    paths = {int(labels["chip"]): labels["device_path"]
             for family, labels, _ in scrapes[-1][1]
             if family == schema.DEVICE_UP.name}
    return {"scrapes": len(scrapes),
            "scrape_gap_s": [b[0] - a[0] for a, b in zip(scrapes,
                                                         scrapes[1:])],
            "steps": [s[0] for s in steps_seen], "mfu_pct": mfu,
            "steps_per_s": steady[0]["steps_per_s"], "device_paths": paths}


def burn_under_exporter() -> dict:
    """The ``cuda`` burn at MAIN_SIZE in this process with the embedded
    exporter fed by its step hook and scraped like Prometheus would (gzip,
    every half second); its exported counters held against the burn's
    own after the last tick. Returns what it measured."""
    exporter = embedded.start(0)
    n_cards = torch.cuda.device_count()
    hook = StepCounter()

    def tee(n: int, *, seconds: float, flops: float) -> None:
        hook(n, seconds=seconds, flops=flops)
        exporter.record_step(n, seconds=seconds, flops=flops)

    stop = threading.Event()
    problems: list = []
    checked = [0]

    def scraper() -> None:
        previous = None
        while not stop.wait(0.5):
            request = urllib.request.Request(
                f"http://127.0.0.1:{exporter.port}/metrics",
                headers={"Accept-Encoding": "gzip"})
            with urllib.request.urlopen(request, timeout=10) as resp:
                body = resp.read()
                if resp.headers.get("Content-Encoding") == "gzip":
                    body = gzip.decompress(body)
            text = body.decode()
            problems.extend(validate.check(text, previous))
            checked[0] += 1
            previous = text

    try:
        scraping = threading.Thread(target=scraper, daemon=True)
        scraping.start()
        before = tiled_burn.launches
        result: dict = {}
        steps = run_burn(seconds=BURN_SECONDS, size=MAIN_SIZE,
                         report_every=1e9, kernel="cuda", step_hook=tee,
                         result=result)
        launches = tiled_burn.launches - before
        stop.set()
        scraping.join(timeout=30)
        # Two publishes after the burn: the second tick began after the
        # last record_step.
        generation = exporter.registry.generation
        require(exporter.registry.wait_for_publish(generation + 1, 10),
                "no publish after the burn")
        snapshot = exporter.registry.snapshot()
        poll_hist = exporter.poll.poll_histogram
    finally:
        stop.set()
        exporter.stop()
    require(not problems and checked[0] > 0,
            f"in-process scrapes: {checked[0]} checked, {problems[:10]}")
    series = [(s.spec.name, dict(s.labels), s.value) for s in snapshot.series]
    exported = per_card(series, schema.WORKLOAD_STEPS.name)
    flops = per_card(series, schema.WORKLOAD_FLOPS.name)
    require(launches == (steps + 1) * n_cards,
            f"{launches} launches for {steps} steps on {n_cards} cards")
    require(set(exported.values()) == {float(steps)}
            and len(exported) == n_cards,
            f"exported steps {exported} != run_burn's {steps}")
    require(len(flops) == n_cards
            and all(math.isclose(v, hook.flops / n_cards, rel_tol=1e-12)
                    for v in flops.values()),
            f"exported FLOPs {flops} != hook {hook.flops} / {n_cards}")
    hists = {(h.spec.name, h.labels): h for h in snapshot.histograms}
    step_hist = hists[(schema.WORKLOAD_STEP_DURATION.name, ())]
    require(step_hist.total == steps, f"step histogram {step_hist.total}")
    scrape_hist = hists.get((schema.SELF_SCRAPE_DURATION.name,
                             (("output", "http"),)))
    require(scrape_hist is not None and scrape_hist.total > 0,
            "no scrape observed")
    render_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        snapshot.render()
        render_ms.append((time.perf_counter() - t0) * 1e3)
    return {
        "steps_per_s": result["steps_per_s"], "launches": launches,
        "poll_tick_ms": {
            "ticks": poll_hist.total,
            "mean": poll_hist.sum / poll_hist.total * 1e3,
            "p50_bucket_le": poll_hist.quantile(0.5) * 1e3,
            "p99_bucket_le": poll_hist.quantile(0.99) * 1e3},
        "scrape_ms": {"scrapes": scrape_hist.total,
                      "mean": scrape_hist.sum / scrape_hist.total * 1e3},
        "render_ms": {"median": statistics.median(render_ms),
                      "min": min(render_ms), "max": max(render_ms),
                      "series": len(snapshot.series)}}


def phase_embedded(card: str, main_cuda_steps_per_s: float
                   ) -> tuple[int, dict]:
    """The embedded exporter on the card; returns the kernel launches of
    its in-process burns and the ``device_path`` it served per chip."""
    cli = embedded_cli()
    emit("embedded_cli", cli)
    # In turns, with and without the exporter: with, without, without,
    # with (the launch counter counts all four).
    tiled_burn.launches = 0
    runs: dict[str, list] = {"with": [], "without": []}
    for turn in ("with", "without", "without", "with"):
        if turn == "with":
            runs["with"].append(burn_under_exporter())
        else:
            result: dict = {}
            run_burn(seconds=BURN_SECONDS, size=MAIN_SIZE, report_every=1e9,
                     kernel="cuda", result=result)
            runs["without"].append(result["steps_per_s"])
    launches = tiled_burn.launches
    emit("embedded_cost", {
        "card": card,
        "poll_tick_ms": [run["poll_tick_ms"] for run in runs["with"]],
        "scrape_ms": [run["scrape_ms"] for run in runs["with"]],
        "render_ms": runs["with"][0]["render_ms"],
        "cuda_steps_per_s": {
            "order": "with, without, without, with",
            "with_exporter": [run["steps_per_s"] for run in runs["with"]],
            "without_exporter": runs["without"],
            "without_exporter_main_path": main_cuda_steps_per_s,
            "with_exporter_cli": cli["steps_per_s"]},
        "launches": {"with_exporter": [run["launches"]
                                       for run in runs["with"]],
                     "all": launches}})
    return launches, cli["device_paths"]

def _step_rank(rank: int, world: int) -> dict:
    """A spawned NCCL rank: one sharded step at the reference's default
    widths (TF32 off), then the step's time, median of batches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = ranks.train_step(rank, world, "cuda")
    _, train_step, params, x = make_sharded_train_step(world)
    for _ in range(TIMING_WARMUP):
        params, _ = train_step(params, x)
    per_step = [_batch_ms(lambda: train_step(params, x), STEP_CALLS)
                for _ in range(TIMING_BATCHES)]
    out["step_ms"] = {"median": statistics.median(per_step),
                      "min": min(per_step), "max": max(per_step),
                      "steps_per_batch": STEP_CALLS}
    out["nccl"] = torch.cuda.nccl.version()
    return out


def phase_multichip(card: str) -> None:
    """The multi-card load generator on this machine's cards, each part
    in spawned ranks (NCCL), so no process group is left up here: it
    would change the burn's and the embedded exporter's world size."""
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    dryrun_multichip(n)
    dryrun_s = time.perf_counter() - t0

    [step] = run_ranks(_step_rank, 1, device="cuda")
    [plain] = run_ranks(ranks.train_step, 1, device="cpu", args=("cpu",))
    errors = {}
    for key in ("w1", "w2", "x"):
        require((step[key] == plain[key]).all(),
                f"the card and the CPU started from other {key}")
    for key in ("new_w1", "new_w2"):
        err = float(abs(step[key] - plain[key]).max())
        limit = SHARDED_ATOL + SHARDED_RTOL * float(abs(plain[key]).max())
        errors[key] = err
        require(err <= limit, f"sharded step {key} on the card vs the CPU: "
                f"{err} > {limit}")
    require(step["loss"] > 0 and math.isclose(
        step["loss"], plain["loss"], rel_tol=SHARDED_RTOL),
        f"loss {step['loss']} on the card vs {plain['loss']} on the CPU")

    ring: dict = {}
    rounds = run_ici_burn(ICI_SECONDS, shard_mb=ICI_SHARD_MB,
                          report_every=1e9, result=ring)
    require(rounds > 0 and ring["rounds"] == rounds and ring["devices"] == n,
            f"ring {ring}")
    cli = subprocess.run(
        [sys.executable, "-m", "kube_gpu_stats_tpu_torch", "loadgen",
         "--mode", "ici", "--seconds", str(ICI_SECONDS)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    reports = [line for line in cli.stdout.splitlines()
               if line.startswith("ici-burn:")]
    require(cli.returncode == 0 and reports,
            f"loadgen --mode ici exited {cli.returncode}: "
            f"{cli.stdout[-2000:]} {cli.stderr[-2000:]}")
    emit("multichip", {
        "card": card, "cards": n, "backend": "nccl",
        "nccl": step["nccl"],
        # One rank: no hop leaves the card, so no NVLink byte moves.
        "links": n if n > 1 else 0,
        "dryrun_multichip_s": dryrun_s,
        "step": {"mesh": [step["dp"], step["tp"]], "loss": step["loss"],
                 "loss_cpu": plain["loss"], "max_abs_err": errors,
                 "rtol": SHARDED_RTOL, "atol": SHARDED_ATOL,
                 "ms": step["step_ms"]},
        "ici": {**ring, "shard_mb": ICI_SHARD_MB},
        "ici_cli": {"rc": cli.returncode, "last_report": reports[-1]}})


def smi(fields: str) -> list[list[str]]:
    """One ``nvidia-smi --query-gpu`` row per card, without units."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [[cell.strip() for cell in line.split(",")]
            for line in out.strip().splitlines()]


def start_logged(cmd: list[str], pattern: str, what: str, *,
                 cwd: pathlib.Path = ROOT, env: dict | None = None,
                 limit_s: float = CLI_START_S
                 ) -> tuple[subprocess.Popen, int, list]:
    """``cmd`` with its stderr read on a thread until it exits; returns
    it, the port the first log line matching ``pattern`` names, and its
    log lines."""
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stderr=subprocess.PIPE,
                            stdout=subprocess.DEVNULL, text=True)
    lines: queue.Queue = queue.Queue()
    log: list[str] = []

    def read() -> None:
        for line in proc.stderr:
            log.append(line.rstrip("\n"))
            lines.put(line)
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    deadline = time.monotonic() + limit_s
    try:
        while True:
            line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
            require(line is not None, f"{what} exited before serving: {log}")
            match = re.search(pattern, line)
            if match:
                return proc, int(match.group(1)), log
    except BaseException:
        proc.kill()
        proc.wait(timeout=30)
        raise


def start_daemon(textfile_dir: str, extra: tuple = ()
                 ) -> tuple[subprocess.Popen, int, list]:
    """The DaemonSet entry point on the card; returns it, the port its
    log names, and its log lines (read on until it exits). ``extra``
    flags follow the phase's own (a repeated flag's last value wins)."""
    # faulthandler: a native abort leaves its Python stacks in the log.
    cmd = [sys.executable, "-X", "faulthandler", "-m",
           "kube_gpu_stats_tpu_torch", "--backend",
           "nvml", "--listen-port", "0", "--interval",
           str(DAEMON_INTERVAL_S), "--attribution", "off",
           "--textfile-dir", textfile_dir, *extra]
    return start_logged(cmd, r"listening on \S+:(\d+)", "the daemon")


def poll_count(series) -> float:
    """Ticks the daemon has published; 0 before its first publish."""
    name = schema.SELF_POLL_DURATION.name + "_count"
    return sum(value for family, _, value in series if family == name)


def fresh_scrape(port: int, after: float) -> tuple[str, list]:
    """The first scrape whose tick count passed ``after``, as text and
    parsed: read right at a publish, so what is read beside it lines up
    with the tick."""
    deadline = time.monotonic() + 10
    while True:
        text = scrape(port)
        series = validate.parse_exposition(text)
        if poll_count(series) > after:
            return text, series
        require(time.monotonic() < deadline, "the daemon stopped ticking")
        time.sleep(0.02)


def card_series(series, uuid: str) -> dict:
    """family -> (labels, value) of one card's per-device series."""
    out = {}
    for family, labels, value in series:
        if labels.get("uuid") == uuid and "pid" not in labels:
            out[family] = (labels, value)
    return out


def holders(series, device_path: str) -> set[str]:
    return {labels["pid"] for family, labels, _ in series
            if family == schema.PROCESS_OPEN.name
            and labels["device_path"] == device_path}


def histogram_summary(series, name: str, labels: dict | None = None) -> dict:
    """count, mean (ms) and the le of the p50 bucket (ms) of one
    histogram in a parsed exposition."""
    want = labels or {}

    def mine(got: dict) -> bool:
        return all(got.get(k) == v for k, v in want.items())

    count = sum(v for f, lab, v in series if f == name + "_count"
                and mine(lab))
    total = sum(v for f, lab, v in series if f == name + "_sum"
                and mine(lab))
    buckets = sorted((float(lab["le"]), v) for f, lab, v in series
                     if f == name + "_bucket" and mine(lab))
    p50 = next(le for le, cum in buckets if cum >= 0.5 * count)
    return {"count": count, "mean_ms": total / count * 1e3,
            "p50_bucket_le_ms": p50 * 1e3}


def tick_phases_ms(series) -> dict:
    """The daemon's own flight-recorder digest: p50/p99/max ms per tick
    phase (``env_round`` is the sampling round, ``sample`` one card's
    reads on the pool, ``fold``/``plan_write``/``publish`` the build)."""
    out: dict = {}
    for family, labels, value in series:
        if family == schema.TICK_PHASE_SECONDS.name:
            out.setdefault(labels["phase"], {})[labels["quantile"]] = \
                value * 1e3
    return out


def nvml_call_us(uuid: str) -> dict:
    """Median microseconds of each bound NVML call over NVML_CALLS calls,
    through the port's binding, on the card named by ``uuid``."""
    nvml = nvml_binding.Nvml()
    nvml.init()
    try:
        handles = [nvml.handle(i) for i in range(nvml.device_count())]
        handle = next(h for h in handles if nvml.uuid(h) == uuid)
        index = handles.index(handle)
        count_field = [(nvml_binding.NVML_FI_DEV_NVLINK_LINK_COUNT, 0)]
        [(_, links)] = nvml.field_values(handle, count_field)
        link_fields = [(f, link) for link in range(int(links or 0))
                       for f in (nvml_binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_TX,
                                 nvml_binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_RX)]
        calls = {
            "nvmlDeviceGetCount_v2": nvml.device_count,
            "nvmlDeviceGetHandleByIndex_v2": lambda: nvml.handle(index),
            "nvmlDeviceGetUUID": lambda: nvml.uuid(handle),
            "nvmlDeviceGetName": lambda: nvml.name(handle),
            "nvmlDeviceGetMinorNumber": lambda: nvml.minor_number(handle),
            "nvmlDeviceGetUtilizationRates": lambda: nvml.utilization(handle),
            "nvmlDeviceGetMemoryInfo": lambda: nvml.memory(handle),
            "nvmlDeviceGetPowerUsage": lambda: nvml.power_mw(handle),
            "nvmlDeviceGetTemperature": lambda: nvml.temperature(handle),
            "nvmlDeviceGetTotalEnergyConsumption":
                lambda: nvml.energy_mj(handle),
            "nvmlDeviceGetFieldValues(NVLink link count)":
                lambda: nvml.field_values(handle, count_field),
        }
        if link_fields:
            calls[f"nvmlDeviceGetFieldValues({len(link_fields)} NVLink "
                  f"fields)"] = lambda: nvml.field_values(handle, link_fields)
        out = {}
        for name, call in calls.items():
            times = []
            for _ in range(NVML_CALLS):
                t0 = time.perf_counter()
                call()
                times.append((time.perf_counter() - t0) * 1e6)
            out[name] = statistics.median(times)
        return {"links": int(links or 0), "median_us": out}
    finally:
        nvml.shutdown()


def render_ms() -> dict:
    """Render of the daemon's own snapshot: the same daemon in this
    process, on the card, two ticks in; median of 20."""
    cfg = config.from_args(["--backend", "nvml", "--listen-host",
                            "127.0.0.1", "--listen-port", "0", "--interval",
                            str(DAEMON_INTERVAL_S), "--attribution", "off"])
    instance = daemon.Daemon(cfg)
    instance.start()
    try:
        require(instance.registry.wait_for_publish(1, 10),
                "the in-process daemon did not tick twice")
        snapshot = instance.registry.snapshot()
    finally:
        instance.stop()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        snapshot.render()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times), "series": len(snapshot.series)}


def burn_scrape_row(series, uuid: str, smi_now: dict,
                    reserved: int) -> dict:
    """The burn's card in one scrape, beside what was read with it."""
    mine = card_series(series, uuid)
    value = {family: mine[family][1] if family in mine else None
             for family in (schema.DEVICE_UP.name, schema.DUTY_CYCLE.name,
                            schema.MEMORY_USED.name, schema.MEMORY_TOTAL.name,
                            schema.POWER.name, schema.TEMPERATURE.name,
                            schema.ENERGY.name, schema.TENSORCORE_UTIL.name,
                            schema.MEMORY_BANDWIDTH_UTIL.name)}
    labels = mine.get(schema.DEVICE_UP.name, ({}, None))[0]
    return {"up": value[schema.DEVICE_UP.name],
            "accel_type": labels.get("accel_type"),
            "duty": value[schema.DUTY_CYCLE.name],
            "used": value[schema.MEMORY_USED.name],
            "total": value[schema.MEMORY_TOTAL.name], "reserved": reserved,
            "power_w": value[schema.POWER.name],
            "temperature": value[schema.TEMPERATURE.name],
            "energy_j": value[schema.ENERGY.name],
            "tensorcore_util": value[schema.TENSORCORE_UTIL.name],
            "memory_bandwidth_util": value[schema.MEMORY_BANDWIDTH_UTIL.name],
            "smi_power_w": smi_now["power_w"], "smi_util": smi_now["util"],
            "smi_memory_used_mib": smi_now["memory_used_mib"]}


def check_burn_row(row: dict, card: dict, gpm_on: bool,
                   idle_tensor: float | None) -> None:
    """What the daemon must serve for the burn's card during the burn."""
    require(row["up"] == 1.0, f"burn card not up: {row}")
    require(row["accel_type"] == "gpu-h100", f"accel_type {row}")
    require(row["duty"] >= DUTY_MIN,
            f"duty cycle {row['duty']} < {DUTY_MIN} in the burn")
    require(row["reserved"] <= row["used"] <= row["total"],
            f"memory used {row['used']} not in [reserved "
            f"{row['reserved']}, {row['total']}]")
    require(abs(row["used"] - row["smi_memory_used_mib"] * MIB)
            <= MEM_TOL_MIB * MIB,
            f"memory used {row['used']} not within {MEM_TOL_MIB} MiB of "
            f"nvidia-smi's {row['smi_memory_used_mib']} MiB")
    require(abs(row["total"] - card["memory_total_mib"] * MIB) <= MIB,
            f"memory total {row['total']} != nvidia-smi's "
            f"{card['memory_total_mib']} MiB")
    require(0 < row["power_w"] <= card["power_limit_w"],
            f"power {row['power_w']} W not in (0, {card['power_limit_w']}]")
    require(abs(row["power_w"] - row["smi_power_w"])
            <= POWER_TOL * row["smi_power_w"],
            f"power {row['power_w']} W vs nvidia-smi {row['smi_power_w']} W")
    require(20 <= row["temperature"] <= 100,
            f"temperature {row['temperature']}")
    bandwidth = row["memory_bandwidth_util"]
    if gpm_on:
        tensor = row["tensorcore_util"]
        require(tensor is not None and 0 < tensor <= 100
                and bandwidth is not None and 0 < bandwidth <= 100,
                f"GPM families not in (0, 100] in the burn: {row}")
        require(tensor > idle_tensor,
                f"tensor-core utilization {tensor} not above idle "
                f"{idle_tensor}")
    else:
        # No GPM: no tensor-core reading, NVML's memory time share.
        require(row["tensorcore_util"] is None,
                f"tensor-core utilization served without GPM: {row}")
        require(bandwidth is not None and 0 <= bandwidth <= 100,
                f"memory bandwidth utilization {bandwidth}")


def card_down_evidence(port: int, ticks: list[int],
                       around: int = 10) -> None:
    """Diagnostics only, printed before the burn row check fails: the
    daemon's fence events from ``/debug/events`` and the recorder's
    ticks within ``around`` of each read that served the card down."""
    _, body, _ = fetch(f"http://127.0.0.1:{port}/debug/events")
    events = json.loads(body).get("events", [])
    _, body, _ = fetch(f"http://127.0.0.1:{port}/debug/trace?last=128")
    recorded = trace_ticks(json.loads(body))
    emit("daemon_card_down", {
        "read_ticks": ticks,
        "fence_events": [e for e in events if "fence" in e["kind"]
                         or "resume" in e["kind"]],
        "ticks": {seq: {k: row[k] for k in ("tick", "env_round",
                                            "pipelined", "reads")
                        if k in row}
                  for seq, row in sorted(recorded.items())
                  if any(abs(seq - t) <= around for t in ticks)}})


def gpm_probe(nvml, handle: int) -> dict:
    """Whether this card gives GPM in this container: the support query,
    then one sample, as the daemon's collector tries them."""
    out: dict = {}
    try:
        out["supported"] = nvml.gpm_supported(handle)
    except nvml_binding.NvmlError as exc:
        return {"supported": None, "rc": exc.code, "error": str(exc)}
    if not out["supported"]:
        return out
    sample = nvml.gpm_sample_alloc()
    try:
        nvml.gpm_sample_get(handle, sample)
        out["rc"] = nvml_binding.NVML_SUCCESS
    except nvml_binding.NvmlError as exc:
        out.update(rc=exc.code, error=str(exc))
    finally:
        nvml.gpm_sample_free(sample)
    if out["rc"] != nvml_binding.NVML_SUCCESS:
        # Refused: does nvidia-smi read GPM here ("-" where it cannot),
        # and are the card's counters restricted to admins?
        dmon = subprocess.run(
            ["nvidia-smi", "dmon", "--gpm-metrics", "2,5,10", "-c", "1"],
            capture_output=True, text=True, timeout=60)
        out["nvidia_smi_dmon_gpm"] = (dmon.stdout.strip().splitlines()[-1]
                                      if dmon.returncode == 0 and
                                      dmon.stdout.strip()
                                      else f"exit {dmon.returncode}")
        params = pathlib.Path("/proc/driver/nvidia/params")
        lines = params.read_text().splitlines() if params.exists() else []
        out["RmProfilingAdminOnly"] = next(
            (line.split(":", 1)[1].strip() for line in lines
             if line.startswith("RmProfilingAdminOnly")), None)
    return out


def phase_daemon(card_line: str, embedded_paths: dict) -> int:
    """The DaemonSet exporter on the card under the ``cuda`` burn; returns
    the kernel launches of the burn. ``embedded_paths``: the embedded
    exporter's ``device_path`` per CUDA ordinal."""
    cards = {row[1]: {"index": int(row[0]), "uuid": row[1], "name": row[2],
                      "memory_total_mib": float(row[3]),
                      "power_limit_w": float(row[4])}
             for row in smi("index,uuid,name,memory.total,power.limit")}
    burn_uuid = "GPU-" + str(torch.cuda.get_device_properties(0).uuid)
    require(burn_uuid in cards, f"card 0 {burn_uuid} not in {sorted(cards)}")
    card = cards[burn_uuid]
    nvml = nvml_binding.Nvml()
    nvml.init()
    textfile_dir = tempfile.mkdtemp(prefix="kts-textfile-")
    proc = None
    try:
        handle = next(h for h in (nvml.handle(i)
                                  for i in range(nvml.device_count()))
                      if nvml.uuid(h) == burn_uuid)
        # Before the daemon opens its own GPM samples.
        gpm = gpm_probe(nvml, handle)
        gpm_on = gpm.get("rc") == nvml_binding.NVML_SUCCESS
        memory_v2 = dict(zip(("total", "reserved", "free", "used"),
                             nvml.memory(handle)))
        proc, port, log = start_daemon(textfile_dir)
        # Idle, three ticks in (GPM serves from the second read round,
        # and the pipelined tick serves the round before its own): every
        # card up, with nvidia-smi's UUIDs.
        idle_text, idle = fresh_scrape(port, 2.0)
        conforms(idle_text, None, "daemon scrape")
        ups = {labels["uuid"]: value for family, labels, value in idle
               if family == schema.DEVICE_UP.name}
        require(ups == {uuid: 1.0 for uuid in cards},
                f"accelerator_up {ups} != nvidia-smi's cards {sorted(cards)}")
        daemon_paths = {labels["uuid"]: labels["device_path"]
                        for family, labels, _ in idle
                        if family == schema.DEVICE_UP.name}
        device_path = daemon_paths[burn_uuid]
        require(stat.S_ISCHR(os.stat(device_path).st_mode),
                f"{device_path} is not a character device")
        # One card, one device file: the embedded exporter's is the
        # daemon's for the same UUID.
        for chip, path in embedded_paths.items():
            uuid = embedded.cuda_uuid(torch.device("cuda", chip))
            require(path == daemon_paths[uuid],
                    f"chip {chip} ({uuid}): embedded device_path {path} "
                    f"!= the daemon's {daemon_paths[uuid]}")
        idle_row = card_series(idle, burn_uuid)
        idle_tensor = idle_row.get(schema.TENSORCORE_UTIL.name,
                                   (None, None))[1]
        idle_bandwidth = idle_row.get(schema.MEMORY_BANDWIDTH_UTIL.name,
                                      (None, None))[1]
        if gpm_on:
            require(idle_tensor is not None,
                    "GPM works here but the daemon serves no tensor-core "
                    "utilization")

        # The burn on card 0, scraped from another thread.
        seen: list = []
        texts: list = []
        failure: list = []

        def scraper(start: float) -> None:
            try:
                for k in range(DAEMON_SCRAPES):
                    time.sleep(max(0.0, start + DAEMON_SCRAPE_START_S
                                   + DAEMON_SCRAPE_GAP_S * k
                                   - time.monotonic()))
                    # Wait for the next tick from here, so each scrape
                    # (the first too) is read right at a publish and the
                    # energy counter read beside it lines up with it.
                    after = poll_count(validate.parse_exposition(
                        scrape(port)))
                    text, series = fresh_scrape(port, after)
                    texts.append(text)
                    energy_mj = nvml.energy_mj(handle)
                    reserved = torch.cuda.memory_reserved(0)
                    at = time.monotonic()
                    row = {r[0]: r for r in
                           smi("uuid,utilization.gpu,memory.used,"
                               "power.draw")}[burn_uuid]
                    smi_now = {"util": float(row[1]),
                               "memory_used_mib": float(row[2]),
                               "power_w": float(row[3])}
                    seen.append((at, series, energy_mj, smi_now, reserved))
            except Exception as exc:  # noqa: BLE001 - re-raised below
                failure.append(exc)

        tiled_burn.launches = 0
        saved_switch = sys.getswitchinterval()
        gc.collect()
        gc.freeze()
        sys.setswitchinterval(DAEMON_SWITCH_S)
        try:
            thread = threading.Thread(target=scraper,
                                      args=(time.monotonic(),), daemon=True)
            thread.start()
            result: dict = {}
            steps = run_burn(seconds=DAEMON_BURN_S, size=MAIN_SIZE,
                             report_every=1e9, kernel="cuda", result=result,
                             device="cuda:0", batch=DAEMON_BATCH)
            launches = tiled_burn.launches
            thread.join(timeout=30)
        finally:
            sys.setswitchinterval(saved_switch)
            gc.unfreeze()
        require(not failure, f"scraping failed: {failure}")
        require(len(seen) == DAEMON_SCRAPES,
                f"{len(seen)} scrapes in the burn")
        require(launches == steps + 1,
                f"{launches} launches for {steps} steps on one card")
        burn_rows = [burn_scrape_row(series, burn_uuid, smi_now, reserved)
                     for _, series, _, smi_now, reserved in seen]
        emit("daemon_burn_scrapes", {
            "at_s": [at - seen[0][0] for at, *_ in seen],
            "nvml_energy_mj": [e for _, _, e, _, _ in seen],
            "rows": burn_rows})
        down = [int(poll_count(series)) for (_, series, *_), row
                in zip(seen, burn_rows) if row["up"] != 1.0]
        if down:
            card_down_evidence(port, down)
        for row in burn_rows:
            check_burn_row(row, card, gpm_on, idle_tensor)
        for before, after in zip([idle_text] + texts, texts):
            conforms(after, before, "daemon scrape")
        energies = [row["energy_j"] for row in burn_rows]
        require(all(b > a for a, b in zip(energies, energies[1:])),
                f"energy not rising: {energies}")
        served_j = energies[-1] - energies[0]
        nvml_j = (seen[-1][2] - seen[0][2]) / 1000.0
        require(abs(served_j - nvml_j) <= ENERGY_TOL * nvml_j,
                f"energy +{served_j} J vs NVML's +{nvml_j} J")
        pid = str(os.getpid())
        for _, series, _, _, _ in seen:
            require(pid in holders(series, device_path),
                    f"pid {pid} not among {device_path}'s holders")

        # The textfile mirrors a scrape of the same publish.
        textfile = pathlib.Path(textfile_dir) / "accelerator.prom"
        for _ in range(50):
            before = textfile.read_text()
            body = scrape(port)
            if before == body == textfile.read_text():
                break
        else:
            raise RuntimeError("the textfile never matched a scrape")
        require(not list(pathlib.Path(textfile_dir).glob("*.tmp")),
                "a *.tmp was left behind")
        conforms(body, texts[-1], "daemon scrape")
        # The port's validate CLI against the live daemon.
        checked = subprocess.run(
            [sys.executable, "-m", "kube_gpu_stats_tpu_torch", "validate",
             "--two-scrapes", f"http://127.0.0.1:{port}/metrics"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        require(checked.returncode == 0,
                f"validate --two-scrapes exited {checked.returncode}: "
                f"{checked.stdout[-2000:]} {checked.stderr[-2000:]}")
        healthz = scrape(port, "/healthz")
        require(healthz.startswith("ok\n"), f"/healthz said {healthz!r}")
        last = seen[-1][1]
        tick = histogram_summary(last, schema.SELF_POLL_DURATION.name)
        phases = tick_phases_ms(last)
        cached_scrape = histogram_summary(
            last, schema.SELF_SCRAPE_DURATION.name, {"output": "http"})
    finally:
        rc = None
        if proc is not None:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        nvml.shutdown()
    require(rc == 0, f"the daemon exited {rc} on SIGTERM: {log[-20:]}")
    n_series = sum(1 for line in body.splitlines()
                   if line and not line.startswith("#"))
    emit("daemon", {
        "card": card_line, "cards": len(cards),
        "tick_ms": {**tick, "budget_ms": TICK_BUDGET_MS},
        "tick_phases_ms": phases,
        "nvml": nvml_call_us(burn_uuid),
        "render_ms": render_ms(),
        "cached_scrape_ms": cached_scrape["mean_ms"],
        "scrapes": cached_scrape["count"],
        "series": n_series,
        "series_per_s_per_card": n_series / DAEMON_INTERVAL_S / len(cards),
        "burn": {"steps": steps, "steps_per_s": result["steps_per_s"],
                 "launches": launches, "scrapes": burn_rows,
                 "energy_served_j": served_j, "energy_nvml_j": nvml_j},
        "device_path": device_path, "embedded_device_paths": embedded_paths,
        "memory_used_tolerance_mib": MEM_TOL_MIB,
        "nvml_memory_v2_before_the_daemon": memory_v2,
        "gpm": {**gpm, "served": gpm_on,
                "tensorcore_util": {
                    "idle": idle_tensor,
                    "burn": [r["tensorcore_util"] for r in burn_rows]},
                "memory_bandwidth_util": {
                    "idle": idle_bandwidth,
                    "burn": [r["memory_bandwidth_util"]
                             for r in burn_rows]}},
        "validate_cli": checked.stdout.strip().splitlines()[-1]})
    require(tick["p50_bucket_le_ms"] <= TICK_BUDGET_MS,
            f"tick p50 bucket {tick['p50_bucket_le_ms']} ms over the "
            f"{TICK_BUDGET_MS} ms budget")
    return launches


def stop_daemon(proc: subprocess.Popen) -> int | None:
    """SIGTERM, then the exit code (None when it had to be killed)."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=5)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        return None


def fetch(url: str, headers: dict | None = None, context=None
          ) -> tuple[int, bytes, float]:
    """(status, body, ms) of one GET on a fresh connection."""
    request = urllib.request.Request(url, headers=headers or {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(request, timeout=30,
                                    context=context) as resp:
            status, body = resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        status, body = exc.code, exc.read()
    return status, body, (time.perf_counter() - t0) * 1e3


def trace_ticks(trace: dict) -> dict[int, dict]:
    """seq -> {"tick": whole-tick ms, "env_round": its sampling round's
    ms, "pipelined": whether it served the last completed round,
    "reads": device -> ``env_read`` spans that completed in it} of every
    tick in a /debug/trace payload (a tick's spans follow its own
    event; a read that runs on past its tick lands in the tick after)."""
    ticks: dict[int, dict] = {}
    row: dict = {}
    for event in trace["traceEvents"]:
        if event["cat"] == "tick":
            row = ticks[event["args"]["seq"]] = {
                "tick": event["dur"] / 1e3, "pipelined": False, "reads": {}}
        elif event["name"] == "env_round":
            row["env_round"] = event["dur"] / 1e3
            row["pipelined"] = bool(event["args"].get("pipelined"))
        elif event["name"] == "env_read":
            device = event["args"]["device"]
            row["reads"][device] = row["reads"].get(device, 0) + 1
    return ticks


def window_p50(ticks: dict[int, dict], first: int, last: int) -> dict:
    """Median and max ms of the whole tick and of its sampling round over
    the ticks with first <= seq <= last."""
    rows = [row for seq, row in ticks.items() if first <= seq <= last]
    require(rows, f"no ticks recorded in seq {first}..{last}")
    out: dict = {"ticks": len(rows)}
    for key in ("tick", "env_round"):
        durations = [row[key] for row in rows if key in row]
        out[key] = {"p50_ms": statistics.median(durations),
                    "max_ms": max(durations)}
    return out


def fence_windows(events: list) -> list[tuple[int, float]]:
    """[first, end) tick seqs of each journaled pipeline_fence window: from
    the fence event's tick to its pipeline_resume's (open-ended while the
    blocking fan-out is still engaged)."""
    windows: list[tuple[int, float]] = []
    opened = None
    for event in events:
        if event["kind"] == "pipeline_fence" and opened is None:
            opened = event["tick_seq"]
        elif event["kind"] == "pipeline_resume" and opened is not None:
            windows.append((opened, event["tick_seq"]))
            opened = None
    if opened is not None:
        windows.append((opened, math.inf))
    return windows


def check_samples_per_tick(ticks: dict[int, dict], ups: dict[int, dict],
                           events: list, devices: set[str]) -> dict:
    """The pipelined tick's contract, tick by tick. Each tick serves every
    card up; the only exception is a tick at or after a journaled
    ``pipeline_fence`` and before its ``pipeline_resume``. Each card's
    reads complete at least once per fence window: a run of recorded
    ticks with no ``env_read`` of a card lasts at most FENCE_TICKS + 1
    ticks (a read that started with the run and took all of the fence
    lands in the tick after it) unless a fence fired within it.
    ``ticks`` from ``trace_ticks``, ``ups`` seq -> card -> up."""
    windows = fence_windows(events)
    fences = [event["tick_seq"] for event in events
              if event["kind"] == "pipeline_fence"]

    def fenced(seq: int) -> bool:
        return any(first <= seq < end for first, end in windows)

    down = sorted(seq for seq, row in ups.items()
                  if any(value != 1.0 for value in row.values()))
    require(not [seq for seq in down if not fenced(seq)],
            f"ticks {down} served a card down; fence windows {windows}")
    seqs = sorted(ticks)
    for device in devices:
        run: list[int] = []
        for seq in seqs + [None]:
            if seq is not None and not ticks[seq]["reads"].get(device):
                run.append(seq)
                continue
            if len(run) > FENCE_TICKS + 1:
                require(any(run[0] <= f <= run[-1] + 1 for f in fences),
                        f"card {device}: no read completed in ticks "
                        f"{run[0]}..{run[-1]} and no fence fired")
            run = []
    return {"ticks": len(seqs), "observed_ups": len(ups),
            "down": down, "fence_windows": windows,
            "pipelined": sum(ticks[seq]["pipelined"] for seq in seqs)}


class DaemonWatcher:
    """Reads a daemon's /metrics in a loop on a thread while the with-block
    runs: per published tick (its poll count), each card's
    ``accelerator_up`` by UUID, card 0's ``kts_power_burst_*`` (samples,
    min/mean/max of the tick's fold, armed) and when it was first seen;
    every TRACE_EVERY_S and at the end, the recorder's last 128 ticks
    (``trace_ticks``, merged by seq). With ``conform`` every scrape goes
    through ``validate.check`` against the one before it; with
    ``keep_texts`` the first scrape of each tick is kept in ``texts``. A
    daemon that exits meanwhile fails the block, its whole log printed
    first."""

    TRACE_EVERY_S = 6.0
    GAP_S = 0.03

    def __init__(self, proc: subprocess.Popen, port: int, log: list,
                 conform: bool = False, keep_texts: bool = False) -> None:
        self.proc, self.port, self.log = proc, port, log
        self.conform = conform
        self.keep_texts = keep_texts
        self.texts: dict[int, str] = {}
        self.scrapes = 0
        self._previous: str | None = None
        self.ups: dict[int, dict[str, float]] = {}
        self.burst: dict[int, dict] = {}
        self.seen_at: dict[int, float] = {}
        # The spill queue's spooled total served with each tick.
        self.spooled: dict[int, float] = {}
        self.traced: dict[int, dict] = {}
        self.failure: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def __enter__(self) -> "DaemonWatcher":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=30)
        rc = self.proc.poll()
        if rc is not None:
            print("\n".join(self.log), file=sys.stderr, flush=True)
        require(rc is None, f"the daemon exited {rc} while watched (its "
                            f"log above)")
        self.trace()
        require(not self.failure, f"watching the daemon failed: "
                                  f"{self.failure}")

    def trace(self) -> None:
        status, body, _ = fetch(f"http://127.0.0.1:{self.port}"
                                f"/debug/trace?last=128")
        require(status == 200, f"/debug/trace answered {status}")
        self.traced.update(trace_ticks(json.loads(body)))

    def _observe(self, text: str) -> None:
        at = time.monotonic()
        if self.conform:
            conforms(text, self._previous, f"scrape {self.scrapes + 1}")
            self._previous = text
        self.scrapes += 1
        series = validate.parse_exposition(text)
        tick = int(poll_count(series))
        if tick in self.ups:
            return
        self.seen_at[tick] = at
        if self.keep_texts:
            self.texts[tick] = text
        self.ups[tick] = {labels["uuid"]: value
                          for family, labels, value in series
                          if family == schema.DEVICE_UP.name}
        burst: dict = {}
        for family, labels, value in series:
            if (family == schema.SPILL_FRAMES.name
                    and labels.get("state") == "spooled"):
                self.spooled[tick] = value
            if labels.get("chip", "0") != "0":
                continue
            if family == schema.BURST_WATTS.name:
                burst[labels["stat"]] = value
            elif family == schema.BURST_SAMPLES.name:
                burst["samples"] = value
            elif family == schema.BURST_ARMED.name:
                burst["armed"] = value
        self.burst[tick] = burst

    def _run(self) -> None:
        next_trace = time.monotonic() + self.TRACE_EVERY_S
        try:
            while not self._stop.is_set():
                self._observe(scrape(self.port))
                if time.monotonic() >= next_trace:
                    self.trace()
                    next_trace += self.TRACE_EVERY_S
                self._stop.wait(self.GAP_S)
        except Exception as exc:  # noqa: BLE001 - re-raised on exit
            self.failure.append(exc)


def self_signed_cert(directory: str) -> tuple[str, str]:
    """(cert.pem, key.pem) for 127.0.0.1, made by openssl."""
    cert = os.path.join(directory, "cert.pem")
    key = os.path.join(directory, "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "1", "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True, timeout=60)
    return cert, key


def doctor_and_debug(port: int, n_cards: int, out: dict) -> None:
    """The doctor's run against the daemon and the /debug/* fetches, made
    from a thread while the burn runs; fills ``out``."""
    base = f"http://127.0.0.1:{port}"
    time.sleep(DOCTOR_BURN_LEAD_S)  # past the burn's ramp

    def current_seq() -> int:
        return json.loads(fetch(base + "/debug/ticks")[1])["current_seq"]

    out["series_before"] = served_series(scrape(port))
    seq0 = current_seq()
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "kube_gpu_stats_tpu_torch", "doctor",
         "--backend", "nvml", "--attribution", "off", "--json",
         "--url", base + "/metrics", "--trace", "--host"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    out["doctor_wall_s"] = time.perf_counter() - t0
    after = scrape(port)
    out["series_after"] = served_series(after)
    out["slowest_tick_s"] = one(validate.parse_exposition(after),
                                schema.SLOWEST_TICK_SECONDS.name)
    out["doctor_seqs"] = (seq0, current_seq())
    out["doctor_rc"] = run.returncode
    out["doctor_stderr"] = run.stderr[-2000:]
    out["doctor"] = json.loads(run.stdout) if run.stdout.strip() else None
    fetched = {}
    for path in ("/debug/ticks", "/debug/trace?last=20", "/debug/events",
                 "/debug/threads", "/debug/host"):
        status, body, ms = fetch(base + path)
        require(status == 200, f"{path} answered {status}")
        fetched[path] = (body, ms)
    seq_a = current_seq()
    status, body, ms = fetch(base + "/debug/profile?seconds=1")
    seq_b = current_seq()
    require(status == 200, f"/debug/profile answered {status}")
    fetched["/debug/profile?seconds=1"] = (body, ms)
    out["profile_seqs"] = (seq_a, seq_b)
    # Every tick since the doctor started, for the windows' medians.
    status, body, _ = fetch(f"{base}/debug/trace?last="
                            f"{min(128, seq_b - seq0 + 2 * DOCTOR_WINDOW)}")
    require(status == 200, f"/debug/trace answered {status}")
    out["ticks"] = trace_ticks(json.loads(body))
    out["fetched"] = fetched
    out["n_cards"] = n_cards


def served_series(text: str) -> int:
    return sum(1 for line in text.splitlines()
               if line and not line.startswith("#"))


def check_doctor_run(out: dict, smi_cards: int, driver: str) -> dict:
    """What the doctor must say about the node under the burn."""
    payload = out["doctor"]
    require(out["doctor_rc"] == 0 and payload and payload["ready"],
            f"doctor exited {out['doctor_rc']}: {payload} "
            f"{out['doctor_stderr']}")
    rows = {row["name"]: row for row in payload["checks"]}
    nvml = rows["nvml"]
    require(nvml["status"] == "ok", f"nvml row {nvml}")
    require(nvml["data"]["device_count"] == smi_cards,
            f"nvml row counts {nvml['data']['device_count']} cards, "
            f"nvidia-smi -L {smi_cards}")
    require(nvml["data"]["driver_version"] == driver,
            f"nvml driver {nvml['data']['driver_version']} != "
            f"nvidia-smi's {driver}")
    poll = rows["poll"]
    require(poll["status"] == "ok" and poll["data"]["up"] == smi_cards,
            f"poll row {poll}")
    scrape_row = rows["scrape"]
    count = int(re.match(r"(\d+) series conform", scrape_row["detail"])
                .group(1)) if scrape_row["status"] == "ok" else None
    require(count in (out["series_before"], out["series_after"]),
            f"scrape row {scrape_row} against the daemon's "
            f"{out['series_before']}/{out['series_after']} series")
    require(rows["live-resilience"]["status"] != "fail",
            f"live-resilience {rows['live-resilience']}")
    trace = rows["trace"]
    slowest = trace["data"].get("slowest", {})
    require(trace["status"] == "ok" and slowest.get("worst_phase"),
            f"trace row {trace}")
    # dur_ms is rounded to the microsecond.
    require(slowest["dur_ms"] <= out["slowest_tick_s"] * 1e3 + 1e-3,
            f"the doctor's slowest tick {slowest['dur_ms']} ms > the "
            f"daemon's kts_slowest_tick_seconds {out['slowest_tick_s']}")
    # --host: the daemon's host snapshot, summarized; never a crash.
    host = rows["host"]
    require(host["status"] in ("ok", "warn")
            and host["data"]["host"]["enabled"] is True,
            f"host row {host}")
    return {"elapsed_seconds": payload["elapsed_seconds"],
            "wall_s": out["doctor_wall_s"],
            "host_detail": host["detail"],
            "poll_p50_ms": poll["data"]["p50_ms"],
            "poll_detail": poll["detail"],
            "poll_ticks": {"ms": poll["data"]["ticks_ms"],
                           "up": poll["data"]["ticks_up"]},
            "nvml_detail": nvml["detail"],
            "scrape_series": count, "trace_detail": trace["detail"],
            "rows": {name: row["status"] for name, row in rows.items()}}


def check_debug_surface(out: dict, ups: dict[int, dict]) -> dict:
    """What each /debug/* fetch must hold; their ms. ``ups``: the
    daemon's served accelerator_up per tick (DaemonWatcher)."""
    fetched = out["fetched"]
    ticks = json.loads(fetched["/debug/ticks"][0])
    # The NVML backend samples on the split path: each card's reads are
    # env_read spans on the pool, the round env_round on the loop.
    require({"env_round", "env_read"} <= set(ticks["phases"]),
            f"/debug/ticks phases {sorted(ticks['phases'])}")
    per_tick = trace_ticks(json.loads(fetched["/debug/trace?last=20"][0]))
    require(len(per_tick) == 20, f"/debug/trace?last=20: {len(per_tick)} "
                                 f"ticks")
    events = json.loads(fetched["/debug/events"][0])
    require(events["enabled"] and isinstance(events["events"], list),
            f"/debug/events {events}")
    samples = check_samples_per_tick(
        per_tick, {seq: ups[seq] for seq in per_tick if seq in ups},
        events["events"], {str(i) for i in range(out["n_cards"])})
    require("--- thread poll-loop\n" in fetched["/debug/threads"][0].decode(),
            "/debug/threads names no poll-loop thread")
    host = json.loads(fetched["/debug/host"][0])
    require(host["enabled"] is True and host["read_at"] > 0,
            f"/debug/host {host}")
    # PSI present on this kernel, or its absence named.
    psi = (f"{len(host['pressure'])} PSI shares" if host["pressure"]
           else "no /proc/pressure on this kernel")
    profile = fetched["/debug/profile?seconds=1"][0].decode().splitlines()
    require(any(line.startswith("poll-loop;") for line in profile),
            "/debug/profile has no poll-loop stack")
    return {"fetch_ms": {path: ms for path, (_, ms) in fetched.items()},
            "trace_last_20": samples, "events": len(events["events"]),
            "event_kinds": sorted({e["kind"] for e in events["events"]}),
            "profile_stacks": len(profile),
            "debug_host": {"psi": psi, "ebpf": host["ebpf"],
                           "pods": len(host["pods"]),
                           "thermal_zones": len(host["thermal_celsius"]),
                           "errors": host["errors"]}}


def phase_doctor(card_line: str) -> int:
    """The node doctor and the /debug/* surface against the NVML daemon
    while the ``cuda`` burn runs on card 0, then a daemon with TLS and
    basic auth; returns the kernel launches of the burn."""
    smi_cards = len(subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                                   text=True, check=True,
                                   timeout=60).stdout.strip().splitlines())
    driver = smi("driver_version")[0][0]
    workdir = tempfile.mkdtemp(prefix="kts-doctor-")
    procs: list = []
    try:
        proc, port, log = start_daemon(
            workdir, ("--interval", str(DOCTOR_INTERVAL_S)))
        procs.append((proc, log))
        fresh_scrape(port, 1.0)
        out: dict = {}
        failure: list = []

        def worker() -> None:
            try:
                doctor_and_debug(port, smi_cards, out)
            except Exception as exc:  # noqa: BLE001 - re-raised below
                failure.append(exc)

        thread = threading.Thread(target=worker, daemon=True)
        # The burn runs in chunks until the worker is done, so the card is
        # busy through every fetch; each chunk launches once more than its
        # steps (its warm-up). The watcher reads each tick's served up.
        with DaemonWatcher(proc, port, log) as watch:
            tiled_burn.launches = 0
            thread.start()
            steps = chunks = 0
            while True:
                chunks += 1
                steps += run_burn(seconds=DOCTOR_BURN_CHUNK_S,
                                  size=MAIN_SIZE, report_every=1e9,
                                  kernel="cuda", device="cuda:0")
                if not thread.is_alive():
                    break
                require(chunks * DOCTOR_BURN_CHUNK_S < 120,
                        "the doctor's worker did not finish in 120 s")
            launches = tiled_burn.launches
            thread.join(timeout=30)
        require(not failure, f"the doctor phase failed: {failure}")
        require(launches == steps + chunks,
                f"{launches} launches for {steps} steps in {chunks} chunks")
        doctor_row = check_doctor_run(out, smi_cards, driver)
        debug = check_debug_surface(out, watch.ups)
        ticks = out["ticks"]
        seq_a, seq_b = out["profile_seqs"]
        tick = {
            "while_doctor": window_p50(ticks, *out["doctor_seqs"]),
            "during_profile": window_p50(ticks, seq_a + 1, seq_b),
            "before_profile": window_p50(ticks, seq_a - DOCTOR_WINDOW + 1,
                                         seq_a)}

        # TLS and basic auth: a second daemon, its cert made by openssl.
        cert, key = self_signed_cert(workdir)
        secure, secure_port, secure_log = start_daemon(
            workdir, ("--interval", str(DOCTOR_INTERVAL_S),
                      "--textfile-dir", "", "--tls-cert-file", cert,
                      "--tls-key-file", key, "--auth-username", "kts",
                      "--auth-password-sha256",
                      hashlib.sha256(DOCTOR_PASSWORD.encode()).hexdigest()))
        procs.append((secure, secure_log))
        https = f"https://127.0.0.1:{secure_port}"
        trusted = ssl.create_default_context(cafile=cert)
        token = base64.b64encode(f"kts:{DOCTOR_PASSWORD}".encode()).decode()
        auth = {"Authorization": "Basic " + token}
        deadline = time.monotonic() + 10
        while fetch(https + "/readyz", context=trusted)[0] != 200:
            require(time.monotonic() < deadline, "TLS daemon never ready")
            time.sleep(0.05)
        text = validate.fetch_exposition(https + "/metrics", headers=auth,
                                         ca_file=cert)
        conforms(text, None, "TLS daemon scrape")
        status, _, _ = fetch(https + "/metrics", context=trusted)
        require(status == 401, f"/metrics without credentials: {status}")
        status, body, _ = fetch(https + "/healthz", context=trusted)
        require(status == 200 and body.startswith(b"ok\n"),
                f"/healthz without credentials: {status} {body[:80]}")
        scrape_row, live_row = doctor.check_url(https + "/metrics")
        require(scrape_row.status == "warn",
                f"the doctor's scrape row against TLS: {scrape_row}")
        # A fresh connection each: TLS + auth against plain HTTP, in turns.
        plain_ms: list = []
        tls_ms: list = []
        for k in range(DOCTOR_TLS_SCRAPES):
            for which in ((0, 1) if k % 2 == 0 else (1, 0)):
                if which == 0:
                    status, _, ms = fetch(
                        f"http://127.0.0.1:{port}/metrics")
                    plain_ms.append(ms)
                else:
                    status, _, ms = fetch(https + "/metrics", auth, trusted)
                    tls_ms.append(ms)
                require(status == 200, f"timed scrape answered {status}")
    finally:
        rcs = [stop_daemon(p) for p, _ in procs]
    for (_, log), rc in zip(procs, rcs):
        require(rc == 0, f"a doctor-phase daemon exited {rc}: {log[-20:]}")
    emit("doctor", {
        "card": card_line, "cards": smi_cards, "driver": driver,
        "interval_s": DOCTOR_INTERVAL_S, **doctor_row,
        "daemon_tick_ms": tick, **debug,
        "burn": {"steps": steps, "chunks": chunks, "launches": launches},
        "tls": {"scrape_row": scrape_row.detail,
                "live_resilience_row": live_row.status,
                "scrape_ms_median": {"plain_http": statistics.median(plain_ms),
                                     "tls_auth": statistics.median(tls_ms)},
                "scrapes": DOCTOR_TLS_SCRAPES, "series": served_series(text)}})
    return launches


def c5_run(pipelined: bool, uuid: str) -> tuple[tuple, dict]:
    """One C5 run: the NVML daemon at C5_INTERVAL_S under the ``cuda`` burn
    on card 0 for C5_SECONDS (in chunks), each published tick's served
    ``accelerator_up`` read off /metrics from the daemon's first tick on,
    its recorded ticks off /debug/trace and its journal at the end.
    Returns ``check_samples_per_tick``'s inputs from the first tick that
    served every card up, and the run's row."""
    workdir = tempfile.mkdtemp(prefix="kts-c5-")
    extra = ("--interval", str(C5_INTERVAL_S), "--textfile-dir", "")
    if not pipelined:
        extra += ("--no-pipeline-fetch",)
    proc, port, log = start_daemon(workdir, extra)
    try:
        with DaemonWatcher(proc, port, log) as watch:
            tiled_burn.launches = 0
            steps = chunks = 0
            end = time.monotonic() + C5_SECONDS
            while time.monotonic() < end:
                chunks += 1
                steps += run_burn(seconds=min(C5_BURN_CHUNK_S,
                                              end - time.monotonic()),
                                  size=MAIN_SIZE, report_every=1e9,
                                  kernel="cuda", device="cuda:0")
            launches = tiled_burn.launches
        events = json.loads(fetch(f"http://127.0.0.1:{port}/debug/events")
                            [1])["events"]
        last = validate.parse_exposition(scrape(port))
    finally:
        rc = stop_daemon(proc)
    require(rc == 0, f"the c5 daemon exited {rc}: {log[-20:]}")
    require(launches == steps + chunks,
            f"{launches} launches for {steps} steps in {chunks} chunks")
    ups = {seq: row for seq, row in watch.ups.items() if row}
    # From the first tick that served every card: the cold first read
    # (no completed round to serve yet) is counted apart.
    warm = min(seq for seq, row in ups.items()
               if all(value == 1.0 for value in row.values()))
    served = {seq: row for seq, row in ups.items() if seq >= warm}
    down = sorted(seq for seq, row in served.items() if row[uuid] != 1.0)
    windows = fence_windows(events)
    unfenced = [seq for seq in down
                if not any(first <= seq < end for first, end in windows)]
    errors = {labels["reason"]: value for family, labels, value in last
              if family == schema.SELF_POLL_ERRORS.name}
    traced = {seq: row for seq, row in watch.traced.items() if seq >= warm}
    inputs = (traced, served, events,
              {str(i) for i in range(len(served[warm]))})
    return inputs, {
        "pipelined": pipelined, "interval_s": C5_INTERVAL_S,
        "seconds": C5_SECONDS, "ticks": int(poll_count(last)),
        "observed_ticks": len(served), "first_up_tick": warm,
        "served_down": len(down), "served_down_unfenced": len(unfenced),
        "down_ticks": down[:50],
        "deadline": errors.get("deadline", 0.0),
        "stuck": errors.get("stuck", 0.0),
        "fetch_deadline": errors.get("fetch_deadline", 0.0),
        "pipeline_events": [(e["kind"], e["tick_seq"]) for e in events
                            if e["kind"].startswith("pipeline_")],
        "fence_windows": windows,
        "recorded_ticks": len(traced),
        "late_rounds": sum(row.get("env_round", 0) >= TICK_DEADLINE_MS
                           for row in traced.values()),
        "tick_ms": window_p50(traced, warm, max(traced))["tick"],
        "env_round_ms": window_p50(traced, warm, max(traced))["env_round"],
        "burn": {"steps": steps, "chunks": chunks, "launches": launches},
        "unfenced": unfenced}


def phase_c5(card_line: str) -> tuple[int, dict]:
    """C5, the repair: a stalled NVML read must not serve a healthy card
    as down when the daemon pipelines; the same run with
    ``--no-pipeline-fetch`` beside it. Returns the kernel launches and
    the pipelined run's tick p50/max."""
    uuid = "GPU-" + str(torch.cuda.get_device_properties(0).uuid)
    (inputs, pipelined), (_, blocking) = (c5_run(True, uuid),
                                          c5_run(False, uuid))
    runs = [pipelined, blocking]
    emit("c5", {"card": card_line, "runs": runs})
    require(pipelined["served_down_unfenced"] == 0,
            f"the pipelined daemon served card 0 down outside a fence "
            f"window on ticks {pipelined['unfenced']}")
    # The pipelined tick's whole contract over the run: reads completing
    # once per fence window, besides the served ups.
    emit("c5_contract", check_samples_per_tick(*inputs))
    for run in runs:
        require(run["observed_ticks"] >= 0.9 * run["ticks"]
                and run["ticks"] >= 0.9 * C5_SECONDS / C5_INTERVAL_S,
                f"{run['observed_ticks']} of {run['ticks']} ticks observed")
    return (sum(run["burn"]["launches"] for run in runs),
            pipelined["tick_ms"])


class PowerSampler:
    """``nvidia-smi``'s instantaneous and one-second-average board power
    for card 0, every BURST_SMI_MS while the with-block runs; ``rows``
    holds (instant W, average W) afterwards, or ``error`` what
    ``nvidia-smi`` said when it has no such fields."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0",
             "--query-gpu=power.draw.instant,power.draw.average",
             "--format=csv,noheader,nounits", "-lms", str(BURST_SMI_MS)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc) -> None:
        self.proc.terminate()
        out, err = self.proc.communicate(timeout=30)
        self.rows = []
        for line in out.splitlines():
            try:
                instant, average = map(float, line.split(","))
            except ValueError:  # "[N/A]" or a cut line
                continue
            self.rows.append((instant, average))
        self.error = None if self.rows else (out + err).strip()[-500:]


def burst_window(watch: DaemonWatcher, first: int, last: int) -> dict:
    """Card 0's burst folds over published ticks first..last: the achieved
    sample rate, and min/mean/max over every sample folded."""
    ticks = sorted(seq for seq in watch.burst
                   if first <= seq <= last and "samples" in watch.burst[seq])
    require(len(ticks) >= 2, f"no burst folds in ticks {first}..{last}")
    samples = [watch.burst[seq]["samples"] for seq in ticks]
    folds = [(watch.burst[seq], now - before) for seq, now, before
             in zip(ticks[1:], samples[1:], samples)
             if now > before]
    require(folds, f"no burst sample in ticks {first}..{last}")
    n = sum(taken for _, taken in folds)
    return {
        "ticks": len(ticks), "samples": n,
        "rate_hz": n / (watch.seen_at[ticks[-1]] - watch.seen_at[ticks[0]]),
        "min_w": min(fold["min"] for fold, _ in folds),
        "max_w": max(fold["max"] for fold, _ in folds),
        "mean_w": sum(fold["mean"] * taken for fold, taken in folds) / n}


def read_burst_us(seconds: float) -> dict:
    """``NvmlCollector.read_burst`` on card 0 in this process, one call
    every 1/BURST_HZ s for ``seconds``, each timed."""
    from kube_gpu_stats_tpu_torch.collectors.nvml import NvmlCollector

    uuid = "GPU-" + str(torch.cuda.get_device_properties(0).uuid)
    collector = NvmlCollector()
    try:
        (dev,) = [d for d in collector.discover() if d.uuid == uuid]
        times = []
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            t0 = time.perf_counter()
            collector.read_burst(dev)
            times.append((time.perf_counter() - t0) * 1e6)
            time.sleep(1.0 / BURST_HZ)
    finally:
        collector.close()
    times.sort()
    return {"calls": len(times), "median_us": statistics.median(times),
            "p99_us": times[int(0.99 * (len(times) - 1))],
            "max_us": times[-1],
            "at_least_20ms": sum(t >= 20e3 for t in times)}


def phase_burst(card_line: str) -> int:
    """The sub-tick power burst sampler on card 0: the daemon at
    ``--burst-mode auto``, armed by /debug/burst?arm for an idle window,
    then for BURST_ARM_S while the ``cuda`` burn pulses 100 ms on,
    100 ms off; held against ``nvidia-smi``'s instantaneous draw.
    Returns the kernel launches."""
    uuid = "GPU-" + str(torch.cuda.get_device_properties(0).uuid)
    nvml = nvml_binding.Nvml()
    nvml.init()
    try:
        handle = next(h for h in (nvml.handle(i)
                                  for i in range(nvml.device_count()))
                      if nvml.uuid(h) == uuid)
        [(code, value)] = nvml.field_values(
            handle, [(nvml_binding.NVML_FI_DEV_POWER_INSTANT, 0)])
        answer = {"field": "NVML_FI_DEV_POWER_INSTANT",
                  "id": nvml_binding.NVML_FI_DEV_POWER_INSTANT,
                  "rc": code, "text": nvml.error_string(code),
                  "value": value}
    finally:
        nvml.shutdown()
    emit("burst_field", answer)
    supported = code == nvml_binding.NVML_SUCCESS
    workdir = tempfile.mkdtemp(prefix="kts-burst-")
    proc, port, log = start_daemon(workdir, (
        "--interval", str(C5_INTERVAL_S), "--textfile-dir", "",
        "--burst-mode", "auto", "--burst-hz", str(BURST_HZ)))
    base = f"http://127.0.0.1:{port}"

    def burst_status(query: str = "") -> dict:
        status, body, _ = fetch(base + "/debug/burst" + query)
        require(status == 200, f"/debug/burst{query} answered {status}")
        return json.loads(body)

    def current_seq() -> int:
        return json.loads(fetch(base + "/debug/ticks")[1])["current_seq"]

    out: dict = {}
    failure: list = []
    try:
        fresh_scrape(port, 2.0)
        before = burst_status()
        require(before["mode"] == "auto" and not before["armed"],
                f"/debug/burst before arming: {before}")
        with DaemonWatcher(proc, port, log) as watch:
            first = current_seq()
            burst_status(f"?arm={BURST_IDLE_ARM_S}")
            time.sleep(BURST_IDLE_ARM_S - 0.3)
            idle_seqs = (first + 1, current_seq())
            time.sleep(0.8)  # past the hold

            def armer() -> None:
                try:
                    time.sleep(BURST_LEAD_S)
                    out["disarmed_seqs"] = (current_seq() - int(
                        BURST_LEAD_S / C5_INTERVAL_S) + 5, current_seq())
                    with PowerSampler() as smi_power:
                        out["armed"] = burst_status(f"?arm={BURST_ARM_S}")
                        armed_at = time.monotonic()
                        seq0 = current_seq()
                        out["read_burst"] = read_burst_us(BURST_ARM_S - 1.0)
                        time.sleep(max(0.0, armed_at + BURST_ARM_S - 0.3
                                       - time.monotonic()))
                        out["armed_seqs"] = (seq0 + 1, current_seq())
                    out["smi"] = smi_power
                    # Past the hold: the sampler disarms itself.
                    time.sleep(max(0.0, armed_at + BURST_ARM_S + 1.0
                                   - time.monotonic()))
                    out["after"] = burst_status()
                except Exception as exc:  # noqa: BLE001 - re-raised below
                    failure.append(exc)

            thread = threading.Thread(target=armer, daemon=True)
            tiled_burn.launches = 0
            thread.start()
            steps = chunks = 0
            while thread.is_alive():
                chunks += 1
                steps += run_burn(seconds=BURST_CHUNK_S, size=MAIN_SIZE,
                                  report_every=1e9, kernel="cuda",
                                  pulse_ms=BURST_PULSE_MS, device="cuda:0")
                require(chunks * BURST_CHUNK_S < 120,
                        "the burst phase's armer did not finish in 120 s")
            launches = tiled_burn.launches
            thread.join(timeout=30)
        events = json.loads(fetch(base + "/debug/events")[1])["events"]
    finally:
        rc = stop_daemon(proc)
    require(not failure, f"the burst phase failed: {failure}")
    require(rc == 0, f"the burst daemon exited {rc}: {log[-20:]}")
    require(launches == steps + chunks,
            f"{launches} launches for {steps} steps in {chunks} chunks")
    after = out["after"]
    require(not after["armed"],
            f"/debug/burst still armed after the hold: {after}")
    kinds = [(e["kind"], e["attrs"].get("reason")) for e in events
             if e["kind"].startswith("burst_")]
    require(("burst_disarm", "expired") in kinds, f"burst events {kinds}")
    ticks = watch.traced
    armed_ticks = [ticks[s]["tick"] for s in range(*out["armed_seqs"])
                   if s in ticks]
    quiet_ticks = [ticks[s]["tick"] for s in range(*out["disarmed_seqs"])
                   if s in ticks]
    row = {"card": card_line, "supported": supported, "nvml": answer,
           "hz": BURST_HZ, "hold_s": BURST_ARM_S,
           "pulse_ms": BURST_PULSE_MS, "read_burst": out["read_burst"],
           "tick_p50_ms": {
               "armed": statistics.median(armed_ticks),
               "disarmed": statistics.median(quiet_ticks),
               "armed_ticks": len(armed_ticks),
               "disarmed_ticks": len(quiet_ticks)},
           "after_hold": {"armed": after["armed"], "read": after["read"]},
           "events": kinds,
           "burn": {"steps": steps, "chunks": chunks,
                    "launches": launches}}
    smi_power = out["smi"]
    if smi_power.rows:
        row["nvidia_smi"] = {
            "samples": len(smi_power.rows),
            "instant_mean_w": statistics.fmean(r[0] for r in smi_power.rows),
            "instant_min_w": min(r[0] for r in smi_power.rows),
            "instant_max_w": max(r[0] for r in smi_power.rows),
            "average_mean_w": statistics.fmean(r[1] for r in smi_power.rows)}
    else:
        row["nvidia_smi"] = {"error": smi_power.error}
    if not supported:
        # The card's limit: no samples, the reason named, and never the
        # averaged reading in their place.
        served = [b for b in watch.burst.values() if "samples" in b]
        row["families_with_samples"] = len(served)
        emit("burst", row)
        require(not served, f"burst samples served without the field: "
                            f"{served[:3]}")
        require(after["read"], f"/debug/burst names no reason: {after}")
        return launches
    idle = burst_window(watch, *idle_seqs)
    armed = burst_window(watch, *out["armed_seqs"])
    row.update(idle=idle, pulsed=armed)
    emit("burst", row)
    require(armed["rate_hz"] >= BURST_RATE_MIN * BURST_HZ,
            f"burst samples at {armed['rate_hz']:.1f} Hz, under "
            f"{BURST_RATE_MIN:.0%} of {BURST_HZ} Hz")
    idle_spread = idle["max_w"] - idle["min_w"]
    spread = armed["max_w"] - armed["min_w"]
    require(spread >= max(BURST_SPREAD_X_IDLE * idle_spread,
                          BURST_SPREAD_MIN_W),
            f"the pulses do not show: max - min {spread:.1f} W against "
            f"{idle_spread:.1f} W idle")
    smi_mean = row["nvidia_smi"].get("instant_mean_w")
    require(smi_mean is not None,
            f"nvidia-smi read no instantaneous draw: {row['nvidia_smi']}")
    require(abs(armed["mean_w"] - smi_mean) <= BURST_MEAN_TOL * smi_mean,
            f"burst mean {armed['mean_w']:.1f} W vs nvidia-smi's "
            f"instantaneous {smi_mean:.1f} W")
    return launches


def kubelet_checkpoint(path: str, uuid: str, pod_uid: str) -> None:
    """The kubelet's device-plugin checkpoint that gives the card
    ``uuid`` to the pod ``pod_uid`` (``attribution/checkpoint.py``'s
    format, NUMA-keyed as kubelets since 1.20 write it)."""
    with open(path, "w", encoding="utf-8") as handle:
        json.dump({"Data": {"PodDeviceEntries": [
            {"PodUID": pod_uid, "ContainerName": "trainer",
             "ResourceName": "nvidia.com/gpu",
             "DeviceIDs": {"0": [uuid]}}],
            "RegisteredDevices": {"nvidia.com/gpu": [uuid]}},
            "Checksum": 0}, handle)


def energy_reading(port: int, nvml, handle: int, uuid: str) -> dict:
    """The first scrape of the next published tick and NVML's energy
    counter read right after it: the pod's joules, the card's
    ``accelerator_energy_joules_total``, coverage, checkpoint writes."""
    text, series = fresh_scrape(
        port, poll_count(validate.parse_exposition(scrape(port))))
    mj = nvml.energy_mj(handle)
    pod = [value for family, labels, value in series
           if family == schema.ENERGY_POD.name
           and labels.get("pod") == ENERGY_POD_UID]
    card = card_series(series, uuid)
    require(len(pod) == 1, f"{len(pod)} pod energy series for "
                           f"{ENERGY_POD_UID}")
    require(schema.ENERGY.name in card, "no accelerator_energy_joules_total")
    return {"text": text, "tick": poll_count(series), "nvml_j": mj / 1e3,
            "pod_j": pod[0], "card_j": card[schema.ENERGY.name][1],
            "coverage": one(series, schema.ENERGY_COVERAGE.name),
            "writes": one(series, schema.ENERGY_CHECKPOINT_WRITES.name)}


def checkpoint_write_ms(state_path: str) -> dict:
    """The checkpoint's write (``.wal`` + fsync + rename) in this
    process, ENERGY_FSYNC_WRITES times, beside the daemon's file."""
    with open(state_path, encoding="utf-8") as handle:
        state = json.load(handle)
    path = os.path.join(os.path.dirname(state_path), "fsync-probe.json")
    health = wal.StoreHealth("fsync-probe")
    times = []
    for _ in range(ENERGY_FSYNC_WRITES):
        t0 = time.perf_counter()
        require(wal.write_state(path, state, label="fsync-probe",
                                health=health), "checkpoint write failed")
        times.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(times), "max_ms": max(times),
            "writes": len(times), "bytes": os.path.getsize(path)}


def run_doctor(port: int, *flags: str) -> tuple[int, dict]:
    """``doctor`` against the daemon on ``port``: exit code, rows."""
    proc = subprocess.run(
        [sys.executable, "-m", "kube_gpu_stats_tpu_torch", "doctor",
         "--backend", "nvml", "--attribution", "off", "--json", "--url",
         f"http://127.0.0.1:{port}/metrics", *flags],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    payload = json.loads(proc.stdout)
    return proc.returncode, {row["name"]: row for row in payload["checks"]}


def phase_energy(card_line: str, c5_tick_ms: dict) -> int:
    """The energy accountant on card 0, owned by one pod through the
    kubelet's checkpoint file: per-pod joules and the card's energy
    counter held against NVML's over a pulsed burn, the checkpoint
    across a SIGTERM restart, the signed digest through the doctor.
    Returns the kernel launches."""
    uuid = "GPU-" + str(torch.cuda.get_device_properties(0).uuid)
    workdir = tempfile.mkdtemp(prefix="kts-energy-")
    attribution = os.path.join(workdir, "kubelet_internal_checkpoint")
    kubelet_checkpoint(attribution, uuid, ENERGY_POD_UID)
    state_path = os.path.join(workdir, "energy.json")
    key = base64.b16encode(os.urandom(16)).decode()
    flags = ("--interval", str(ENERGY_INTERVAL_S), "--textfile-dir", "",
             "--attribution", "checkpoint", "--checkpoint-path", attribution,
             "--burst-mode", "continuous", "--burst-hz", str(BURST_HZ),
             "--energy-checkpoint", state_path,
             "--energy-checkpoint-interval", str(ENERGY_CKPT_INTERVAL_S),
             "--energy-audit-key", key)
    nvml = nvml_binding.Nvml()
    nvml.init()
    try:
        handle = next(h for h in (nvml.handle(i)
                                  for i in range(nvml.device_count()))
                      if nvml.uuid(h) == uuid)
        proc, port, log = start_daemon(workdir, flags)
        out: dict = {}
        failure: list = []
        try:
            # The pod owns the card once the attribution's first refresh
            # has landed.
            deadline = time.monotonic() + 30
            while True:
                text = scrape(port)
                if f'pod="{ENERGY_POD_UID}"' in text:
                    break
                require(time.monotonic() < deadline,
                        "the pod's energy series never appeared")
                time.sleep(0.1)
            with DaemonWatcher(proc, port, log, conform=True) as watch:

                def reader() -> None:
                    try:
                        time.sleep(ENERGY_LEAD_S)
                        out["start"] = energy_reading(port, nvml, handle,
                                                      uuid)
                        time.sleep(ENERGY_SECONDS)
                        out["end"] = energy_reading(port, nvml, handle,
                                                    uuid)
                    except Exception as exc:  # noqa: BLE001 - re-raised
                        failure.append(exc)

                thread = threading.Thread(target=reader, daemon=True)
                tiled_burn.launches = 0
                thread.start()
                steps = chunks = 0
                while thread.is_alive():
                    chunks += 1
                    steps += run_burn(seconds=BURST_CHUNK_S, size=MAIN_SIZE,
                                      report_every=1e9, kernel="cuda",
                                      pulse_ms=BURST_PULSE_MS,
                                      device="cuda:0")
                    require(chunks * BURST_CHUNK_S < 120,
                            "the energy window did not close in 120 s")
                launches = tiled_burn.launches
                thread.join(timeout=30)
            require(not failure, f"the energy phase failed: {failure}")
            window = (int(out["start"]["tick"]) + 1, int(out["end"]["tick"]))
            tick_ms = window_p50(watch.traced, *window)["tick"]
            conforms(out["end"]["text"], out["start"]["text"],
                     "the energy window's last scrape")
            last = energy_reading(port, nvml, handle, uuid)
        finally:
            rc = stop_daemon(proc)
        require(rc == 0, f"the energy daemon exited {rc}: {log[-20:]}")
        require(launches == steps + chunks,
                f"{launches} launches for {steps} steps in {chunks} chunks")
        saved = json.loads(pathlib.Path(state_path).read_text())
        saved_j = {(pod, ns): joules for pod, ns, joules
                   in saved["per_pod"]}.get((ENERGY_POD_UID, ""), 0.0)
        # The restart: a second daemon on the same checkpoint.
        proc, port, log = start_daemon(workdir, flags)
        try:
            # Its first published tick serves the replayed totals.
            _, series = fresh_scrape(port, 0.0)
            first = {"pod_j": sum(
                value for family, labels, value in series
                if family == schema.ENERGY_POD.name
                and labels.get("pod") == ENERGY_POD_UID)}
            rc_ok, rows_ok = run_doctor(port, "--energy",
                                        "--energy-audit-key", key)
            rc_bad, rows_bad = run_doctor(port, "--energy",
                                          "--energy-audit-key", key + "0")
            rc_stores, rows_stores = run_doctor(port, "--stores")
            require(proc.poll() is None,
                    f"the restarted daemon exited: {log[-40:]}")
        finally:
            rc2 = stop_daemon(proc)
        require(rc2 == 0, f"the restarted daemon exited {rc2}: {log[-20:]}")
    finally:
        nvml.shutdown()
    start, end = out["start"], out["end"]
    nvml_j = end["nvml_j"] - start["nvml_j"]
    pod_j = end["pod_j"] - start["pod_j"]
    card_j = end["card_j"] - start["card_j"]
    stores = rows_stores["stores"]["data"]["stores"]["stores"]
    row = {
        "card": card_line, "seconds": ENERGY_SECONDS,
        "interval_s": ENERGY_INTERVAL_S, "burst_hz": BURST_HZ,
        "pulse_ms": BURST_PULSE_MS,
        "joules": {"nvml": nvml_j, "pod": pod_j, "card": card_j,
                   "pod_err": pod_j / nvml_j - 1.0,
                   "card_err": card_j / nvml_j - 1.0},
        "mean_w": nvml_j / ENERGY_SECONDS,
        "coverage": end["coverage"],
        "checkpoint": {"writes": last["writes"],
                       "write_ms": checkpoint_write_ms(state_path)},
        "tick_ms": tick_ms, "window_ticks": window,
        "c5_pipelined_tick_ms": c5_tick_ms,
        "scrapes_validated": watch.scrapes,
        "restart": {"last_pod_j": last["pod_j"], "saved_pod_j": saved_j,
                    "first_pod_j": first["pod_j"],
                    "monotone": first["pod_j"] >= last["pod_j"]},
        "doctor": {
            "energy": [rc_ok, rows_ok["energy"]["status"],
                       rows_ok["energy"]["detail"]],
            "energy_wrong_key": [rc_bad, rows_bad["energy"]["status"]],
            "stores": [rc_stores, rows_stores["stores"]["status"],
                       stores.get("energy", {}).get("state")]},
        "burn": {"steps": steps, "chunks": chunks, "launches": launches}}
    emit("energy", row)
    for name in ("pod_err", "card_err"):
        require(abs(row["joules"][name]) <= ENERGY_PHASE_TOL,
                f"energy {name} {row['joules'][name]:+.2%} against NVML's "
                f"counter ({row['joules']})")
    require(end["coverage"] >= ENERGY_COVERAGE_MIN,
            f"coverage {end['coverage']:.3f}")
    require(last["writes"] > 0, "no energy checkpoint written")
    # The checkpoint keeps joules to 6 decimals (the reference's format).
    require(saved_j >= round(last["pod_j"], 6),
            f"the final checkpoint holds {saved_j} J, below the last "
            f"scrape's {last['pod_j']} J")
    require(row["restart"]["monotone"],
            f"the pod total fell across the restart: {row['restart']}")
    require(rc_ok == 0 and rows_ok["energy"]["status"] == "ok",
            f"doctor --energy with the key: {rc_ok} {rows_ok['energy']}")
    require(rc_bad != 0 and rows_bad["energy"]["status"] == "fail",
            f"doctor --energy with a wrong key: {rc_bad} "
            f"{rows_bad['energy']}")
    require(rc_stores == 0 and stores.get("energy", {}).get("state")
            == "healthy", f"doctor --stores: {rc_stores} {stores}")
    return launches


def egress_state(port: int) -> tuple[dict, dict]:
    """The daemon's /debug/egress and /debug/skew payloads."""
    out = []
    for path in ("/debug/egress", "/debug/skew"):
        status, body, _ = fetch(f"http://127.0.0.1:{port}{path}")
        require(status == 200, f"{path} answered {status}")
        out.append(json.loads(body))
    return out[0], out[1]


def wait_egress(port: int, what: str, predicate, timeout: float
                ) -> tuple[dict, dict, float]:
    """Poll /debug/egress and /debug/skew until ``predicate(egress,
    skew)``; returns both and the seconds it took."""
    t0 = time.monotonic()
    while True:
        egress, skew = egress_state(port)
        if predicate(egress, skew):
            return egress, skew, time.monotonic() - t0
        require(time.monotonic() - t0 < timeout,
                f"egress: {what} not reached in {timeout:g} s "
                f"(egress {json.dumps(egress)[:2000]}, skew "
                f"{json.dumps(skew.get('publisher'))})")
        time.sleep(0.05)


def drained(egress: dict, _skew=None) -> bool:
    """The spill queue and every remote-write shard have no backlog."""
    return (egress["spill"]["depth_frames"] == 0
            and all(shard["wal_records"] == 0
                    for shard in egress["remote_write"]["shards"]))


def watched_spool(watch: DaemonWatcher) -> tuple[int, float]:
    """The newest tick the watcher has seen and the spooled total served
    in the same scrape: a frame spooled after that scrape counts in
    neither, where a separate read of ``/debug/egress`` could count it
    before the watcher saw its tick."""
    tick = max(watch.seen_at, default=0)
    return tick, watch.spooled.get(tick, 0.0)


def tick_at(watch: DaemonWatcher, at: float) -> int:
    """The newest tick the watcher had seen by monotonic time ``at``."""
    seen = [tick for tick, t in watch.seen_at.items() if t <= at]
    return max(seen) if seen else 0


def series_key(series) -> list:
    """(name, labels, value repr) rows of a parse, comparable exactly."""
    return [(name, tuple(labels), repr(float(value)))
            for name, labels, value in series]


def check_delta_records(applied: list, watch: DaemonWatcher, first: int,
                        last: int, live_last: int, skipped: int,
                        reconnects: list[float]) -> dict:
    """The sink's applied frames against the daemon's own scrapes: the
    reconstructed state at every tick that was also scraped equals the
    scrape; the ticks between ``first`` and ``last`` the sink lacks, each
    of which must be among the ``skipped`` snapshots the publisher
    counted over the window; FULLs after each reconnect."""
    states: dict[int, list] = {}
    ticks_applied: list[int] = []
    late = 0
    for frame in applied:
        tick = int(poll_count(frame.series))
        ticks_applied.append(tick)
        states.setdefault(tick, series_key(frame.series))
        if tick_at(watch, frame.at) - tick >= 2:
            late += 1
    compared = 0
    for tick, state in states.items():
        text = watch.texts.get(tick)
        if text is None:
            continue
        want = series_key(validate.parse_exposition_interned(text))
        require(state == want,
                f"egress: the sink's delta state at tick {tick} differs from "
                f"the scrape: {sorted(set(state) ^ set(want))[:10]}")
        compared += 1
    require(compared >= 0.5 * len(states),
            f"egress: only {compared} of {len(states)} delta states had a "
            f"scrape of their tick")
    # Every tick of the phase reached the sink, or is one of the
    # snapshots the publisher counted as skipped: the follower renders
    # the newest generation at each push, so a tick published while a
    # push lasts past the next publish is never taken in (the reference's
    # design; see PERF.md).
    have = set(ticks_applied)
    missing = [t for t in range(first, last + 1) if t not in have]
    # FULLs after each reconnect that re-anchor an unchanged series set
    # (a resync); a FULL for a changed set is a shape change.
    resync_fulls = []
    previous = None
    for frame in applied:
        keys = [(name, labels) for name, labels, _ in frame.series]
        if (frame.kind == 0 and previous is not None and keys == previous
                and not frame.duplicate):
            resync_fulls.append(frame.at)
        previous = keys
    per_reconnect = []
    edges = sorted(reconnects) + [math.inf]
    for start, end in zip(edges, edges[1:]):
        per_reconnect.append(sum(start <= t < end for t in resync_fulls))
    before = sum(t < edges[0] for t in resync_fulls)
    return {"applied": len(applied), "states_compared": compared,
            "first_tick": first, "last_tick": last,
            "missing": len(missing), "missing_ticks": missing[:40],
            "missing_live": sum(t <= live_last for t in missing),
            "skipped_by_publisher": skipped,
            "late_frames": late, "resync_fulls_before": before,
            "resync_fulls_per_reconnect": per_reconnect,
            "duplicates": sum(frame.duplicate for frame in applied)}


def check_remote_write_records(writes: list, watch: DaemonWatcher,
                               instance: str) -> dict:
    """The sink's remote-write requests: each snapshot's two shard
    requests arrived exactly once, oldest-first per shard, and the
    samples of every snapshot whose tick was also scraped equal the
    scrape's values (with the writer's job/instance labels, and without
    the empty-valued labels the wire drops)."""
    requests = [w for w in writes if w.series]
    require(requests, "egress: no remote-write request reached the sink")
    by_ts: dict[int, list] = {}
    for index, write in enumerate(requests):
        stamps = {ts for _, samples, _ in write.series for _, ts in samples}
        require(len(stamps) == 1, f"egress: a request with {len(stamps)} "
                                  f"timestamps")
        by_ts.setdefault(stamps.pop(), []).append(index)
    # Shard identity: routing is stable, so a series always rides the
    # same shard. A request belongs to the shard whose series it shares,
    # seeded by the first request (shard 0) and the other request of its
    # snapshot (shard 1), and grown by every request classified since:
    # one marker series would misfile a snapshot that lacks it.
    ids = [frozenset(tuple(sorted(labels.items()))
                     for labels, _, _ in write.series)
           for write in requests]
    first = by_ts[min(by_ts, key=lambda ts: min(by_ts[ts]))]
    known = [set(ids[first[0]]), set().union(*(ids[i] for i in first[1:]))]
    shard_of = []
    for request_ids in ids:
        hits = [bool(request_ids & known[k]) for k in (0, 1)]
        shard = hits.index(True) if hits.count(True) == 1 else -1
        if shard >= 0:
            known[shard] |= request_ids
        shard_of.append(shard)
    bad = {ts: [(shard_of[i], len(requests[i].series)) for i in idx]
           for ts, idx in by_ts.items()
           if sorted(shard_of[i] for i in idx) != [0, 1]}
    require(not bad, f"egress: remote-write snapshots not delivered exactly "
                     f"once per shard (shard, series) per request: "
                     f"{dict(list(bad.items())[:10])}")
    for shard in (0, 1):
        stamps = [ts for ts, idx in sorted(by_ts.items(),
                                           key=lambda kv: min(kv[1]))
                  for i in idx if shard_of[i] == shard]
        require(all(b > a for a, b in zip(stamps, stamps[1:])),
                f"egress: shard {shard} delivered out of order")
    compared = 0
    for ts, idx in by_ts.items():
        got = {}
        for i in idx:
            for labels, samples, _ in requests[i].series:
                labels = dict(labels)
                name = labels.pop("__name__")
                got[(name, tuple(sorted(labels.items())))] = \
                    repr(float(samples[0][0]))
        tick = int(float(got.get((schema.SELF_POLL_DURATION.name + "_count",
                                  (("instance", instance),
                                   ("job", "kube-tpu-stats"))), "0")))
        text = watch.texts.get(tick)
        if text is None:
            continue
        want = {}
        for name, labels, value in validate.parse_exposition(text):
            labels = {k: v for k, v in labels.items() if v}
            labels.update(job="kube-tpu-stats", instance=instance)
            want[(name, tuple(sorted(labels.items())))] = repr(float(value))
        require(got == want,
                f"egress: remote-write samples at tick {tick} differ from "
                f"the scrape: {sorted(set(got.items()) ^ set(want.items()))[:10]}")
        compared += 1
    require(compared >= 1, "egress: no remote-write snapshot had a scrape of "
                           "its tick")
    return {"requests": len(requests), "snapshots": len(by_ts),
            "snapshots_compared": compared,
            "protocols": sorted({w.protocol for w in requests}),
            "bytes_median": statistics.median(w.nbytes for w in requests)}


def check_pushgateway_records(pushes: list, watch: DaemonWatcher) -> dict:
    """Each Pushgateway PUT body of a tick the watcher also scraped is
    the scrape's text, byte for byte (both are the generation's one
    render)."""
    require(pushes, "egress: no Pushgateway push reached the sink")
    compared = 0
    for path, body in pushes:
        require(path.startswith("/metrics/job/kube-tpu-stats/instance/"),
                f"egress: Pushgateway path {path}")
        text = body.decode()
        tick = int(poll_count(validate.parse_exposition(text)))
        if tick in watch.texts:
            require(text == watch.texts[tick],
                    f"egress: the Pushgateway body of tick {tick} differs "
                    f"from the scrape")
            compared += 1
    require(compared >= 1, "egress: no Pushgateway body had a scrape of its "
                           "tick")
    return {"pushes": len(pushes), "compared": compared}


def wal_append_ms(directory: str, nbytes: int) -> dict:
    """A remote-write shard's WAL append (CRC frame + write + fsync) in
    this process, EGRESS_WAL_WRITES times, with a payload the size of the
    median request, in a ring beside the daemon's."""
    ring = wal.SegmentRing(os.path.join(directory, "append-probe"),
                           max_bytes=64 * MIB, segment_bytes=MIB,
                           prefix="rw", fsync=True, label="append-probe",
                           format_version=1)
    payload = os.urandom(int(nbytes))
    times = []
    try:
        for i in range(EGRESS_WAL_WRITES):
            t0 = time.perf_counter()
            ring.append(float(i), payload)
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        ring.close()
    return {"median_ms": statistics.median(times), "max_ms": max(times),
            "writes": len(times), "bytes": int(nbytes)}


def encode_ms(texts: list[str]) -> dict:
    """The delta publisher's diff + encode, timed in this process over
    the daemon's scraped texts in tick order (what the daemon's own
    ``output="delta"`` histogram leaves out: it times the render-cache
    read only)."""
    encoder = delta.DeltaEncoder("chip-smoke", 1, build="chip-smoke")
    encoder.set_wire(delta.PROTO_MAX, delta.CAPS_CURRENT)
    full, deltas = [], []
    for text in texts:
        t0 = time.perf_counter()
        _, kind = encoder.encode_next(text)
        ms = (time.perf_counter() - t0) * 1e3
        encoder.ack()
        (full if kind == delta.KIND_FULL else deltas).append(ms)
    return {"full_ms": statistics.median(full), "fulls": len(full),
            "delta_ms": statistics.median(deltas), "deltas": len(deltas)}


def phase_egress(card_line: str, c5_tick_ms: dict) -> int:
    """Push egress on card 0: the NVML daemon at 10 Hz under the ``cuda``
    burn with all three senders on — the delta publisher with a disk
    spill queue, durable remote write 2.0 over two shards, the
    Pushgateway pusher — shipping into one ``testing.egress_sink`` in
    this process. A live window, a blackout of the sink, the recovery,
    then the sink restarted at wire v1..v1 and at a disjoint v3..v3, and
    back. Returns the kernel launches."""
    from kube_gpu_stats_tpu_torch.testing.egress_sink import EgressSink

    workdir = tempfile.mkdtemp(prefix="kts-egress-")
    sink = EgressSink().start()
    source = "http://chip-smoke:9400/metrics"
    flags = ("--interval", str(EGRESS_INTERVAL_S), "--textfile-dir", "",
             "--hub-url", sink.url, "--hub-push-source", source,
             "--hub-push-interval", str(EGRESS_PUSH_INTERVAL_S),
             "--hub-spill-dir", os.path.join(workdir, "spill"),
             "--remote-write-url", sink.url + "/api/v1/write",
             "--remote-write-protocol", "2.0",
             "--remote-write-wal-dir", os.path.join(workdir, "rw"),
             "--remote-write-shards", "2",
             "--remote-write-interval", str(EGRESS_RW_INTERVAL_S),
             "--pushgateway-url", sink.url)
    instance = socket.gethostname()
    out: dict = {}
    failure: list = []
    marks: dict = {}
    proc, port, log = start_daemon(workdir, flags)
    try:
        with DaemonWatcher(proc, port, log, conform=True,
                           keep_texts=True) as watch:

            def controller() -> None:
                try:
                    # Every sender has delivered and the publisher has
                    # negotiated v2 off the sink's first hello.
                    wait_egress(port, "the senders' first delivery",
                                lambda e, k: sink.applied()
                                and sink.writes() and sink.pushes()
                                and k["publisher"]["negotiated_proto"] == 2,
                                30.0)
                    time.sleep(1.0)
                    egress, _ = egress_state(port)
                    marks["live"] = (
                        time.monotonic(), max(watch.seen_at, default=0),
                        egress["senders"]["delta"]["skipped_total"])
                    time.sleep(EGRESS_LIVE_S)
                    out["doctor_live"] = run_doctor(
                        port, "--egress", "--skew", "--remote-write-url",
                        sink.url + "/api/v1/write",
                        "--remote-write-protocol", "2.0")
                    egress, _ = egress_state(port)
                    marks["cut"] = (time.monotonic(), *watched_spool(watch),
                                    egress["senders"]["delta"][
                                        "skipped_total"])
                    sink.blackout()
                    time.sleep(EGRESS_BLACKOUT_S / 2)
                    out["doctor_blackout"] = run_doctor(port, "--egress")
                    remaining = EGRESS_BLACKOUT_S - (time.monotonic()
                                                    - marks["cut"][0])
                    time.sleep(max(0.0, remaining))
                    egress, _ = egress_state(port)
                    marks["restore"] = (time.monotonic(),
                                        *watched_spool(watch),
                                        egress["senders"]["delta"][
                                            "skipped_total"])
                    out["blackout_egress"] = egress
                    sink.restore()
                    out["recovered"] = wait_egress(
                        port, "the recovery drain", drained,
                        EGRESS_RECOVERY_MAX_S)
                    marks["recovered"] = (time.monotonic(),
                                          max(watch.seen_at, default=0))
                    # Skew: the sink back at v1..v1, then disjoint.
                    _, skew = egress_state(port)
                    before = skew["publisher"]
                    marks["v1"] = time.monotonic()
                    sink.restart(1, 1)
                    out["v1"] = wait_egress(
                        port, "the downgrade to v1",
                        lambda e, k: k["publisher"]["negotiated_proto"] == 1
                        and k["publisher"]["proto_downgrades_total"]
                        > before["proto_downgrades_total"], 15.0)
                    marks["v3"] = time.monotonic()
                    sink.restart(3, 3)
                    out["v3"] = wait_egress(
                        port, "the disjoint refusal",
                        lambda e, k: k["publisher"]["skew_refused_total"]
                        > out["v1"][1]["publisher"]["skew_refused_total"]
                        and e["spill"]["depth_frames"] > 0, 15.0)
                    out["doctor_skew_refused"] = run_doctor(port, "--skew")
                    marks["v2"] = time.monotonic()
                    sink.restart(1, 2)
                    out["back"] = wait_egress(
                        port, "the drain after the skew",
                        lambda e, k: drained(e)
                        and k["publisher"]["negotiated_proto"] == 2,
                        EGRESS_RECOVERY_MAX_S)
                    time.sleep(1.0)
                    marks["end"] = (time.monotonic(),
                                    max(watch.seen_at, default=0))
                    # A read can land between a snapshot's journaling
                    # and its shard's send: wait for a quiescent one.
                    out["final_egress"], out["final_skew"], _ = \
                        wait_egress(port, "the final drain", drained, 10.0)
                except Exception as exc:  # noqa: BLE001 - re-raised
                    failure.append(exc)

            thread = threading.Thread(target=controller, daemon=True)
            tiled_burn.launches = 0
            thread.start()
            steps = chunks = 0
            while thread.is_alive():
                chunks += 1
                steps += run_burn(seconds=EGRESS_BURN_CHUNK_S,
                                  size=MAIN_SIZE, report_every=1e9,
                                  kernel="cuda", device="cuda:0")
                require(chunks * EGRESS_BURN_CHUNK_S < 240,
                        "the egress phase did not end in 240 s")
            launches = tiled_burn.launches
            thread.join(timeout=30)
            require(not failure, f"the egress phase failed: {failure}")
            last = validate.parse_exposition(scrape(port))
    finally:
        rc = stop_daemon(proc)
        sink.stop()
    require(rc == 0, f"the egress daemon exited {rc}: {log[-20:]}")
    require(launches == steps + chunks,
            f"{launches} launches for {steps} steps in {chunks} chunks")
    applied = sink.applied(source)
    reconnects = [marks["restore"][0], marks["v1"], marks["v3"],
                  marks["v2"]]
    in_phase = [a for a in applied if a.at >= marks["live"][0]]
    require(in_phase, "egress: no delta frame reached the sink in the phase")
    first_tick = int(poll_count(in_phase[0].series))
    last_tick = marks["end"][1]
    skipped = (out["final_egress"]["senders"]["delta"]["skipped_total"]
               - marks["live"][2])
    delta_row = check_delta_records(in_phase, watch, first_tick, last_tick,
                                    marks["cut"][1], skipped, reconnects)
    rw_row = check_remote_write_records(sink.writes(), watch, instance)
    pg_row = check_pushgateway_records(sink.pushes(), watch)
    final = out["final_egress"]
    spill = final["spill"]
    cut_tick, restore_tick = marks["cut"][1], marks["restore"][1]
    spooled_in_blackout = int(marks["restore"][2] - marks["cut"][2])
    blackout_ticks = restore_tick - cut_tick
    windows = {
        "live": window_p50(watch.traced, first_tick, cut_tick),
        "blackout": window_p50(watch.traced, cut_tick + 1, restore_tick),
        "recovery": window_p50(watch.traced, restore_tick + 1,
                               marks["recovered"][1]),
    }
    fulls = [a.nbytes for a in applied if a.kind == 0]
    deltas = [a.nbytes for a in applied if a.kind == 1]
    rc_live, rows_live = out["doctor_live"]
    rc_black, rows_black = out["doctor_blackout"]
    rc_refused, rows_refused = out["doctor_skew_refused"]
    publisher = out["final_skew"]["publisher"]
    delta_render = histogram_summary(last, schema.SELF_SCRAPE_DURATION.name,
                                     {"output": "delta"})
    rw_render = histogram_summary(last, schema.SELF_SCRAPE_DURATION.name,
                                  {"output": "remote_write"})
    row = {
        "card": card_line, "interval_s": EGRESS_INTERVAL_S,
        "hub_push_interval_s": EGRESS_PUSH_INTERVAL_S,
        "remote_write_interval_s": EGRESS_RW_INTERVAL_S,
        "windows_s": {"live": EGRESS_LIVE_S, "blackout": EGRESS_BLACKOUT_S,
                      "recovery": out["recovered"][2],
                      "skew_drain": out["back"][2]},
        "tick_ms": {k: v["tick"] for k, v in windows.items()},
        "c5_pipelined_tick_ms": c5_tick_ms,
        "delta": delta_row,
        "blackout": {"ticks": blackout_ticks,
                     "spooled": spooled_in_blackout,
                     "skipped": marks["restore"][3] - marks["cut"][3],
                     "spooled_per_tick": spooled_in_blackout
                     / max(1, blackout_ticks)},
        "spill": {k: spill[k] for k in ("spooled_total", "drained_total",
                                        "dropped_total", "depth_frames",
                                        "undecodable_total")},
        "remote_write": rw_row | {
            "shards": [{k: shard[k] for k in (
                "shard", "sent_total", "wal_records", "dropped_total",
                "parked_total", "lag_seconds")}
                for shard in final["remote_write"]["shards"]]},
        "pushgateway": pg_row,
        "frame_bytes": {"first_full": fulls[0] if fulls else None,
                        "delta_median": statistics.median(deltas)
                        if deltas else None,
                        "fulls": len(fulls), "deltas": len(deltas)},
        "publisher_render_ms": delta_render,
        "publisher_encode_ms": encode_ms(
            [watch.texts[t] for t in sorted(watch.texts)][-200:]),
        "remote_write_serialize_ms": rw_render,
        "remote_write_wal_append": wal_append_ms(workdir,
                                                 rw_row["bytes_median"]),
        "skew": {"final": publisher,
                 "v1": out["v1"][1]["publisher"],
                 "v3": out["v3"][1]["publisher"],
                 "sink_statuses": dict(sorted(sink.delta_status.items()))},
        "doctor": {
            "live": {name: [rows_live[name]["status"],
                            rows_live[name]["detail"]]
                     for name in ("egress", "skew", "remote-write")},
            "live_rc": rc_live,
            "blackout": [rc_black, rows_black["egress"]["status"],
                         rows_black["egress"]["detail"]],
            "skew_refused": [rc_refused, rows_refused["skew"]["status"],
                             rows_refused["skew"]["detail"]]},
        "scrapes_validated": watch.scrapes,
        "burn": {"steps": steps, "chunks": chunks, "launches": launches}}
    emit("egress", row)
    # Same numbers as the scrape: checked inside the check_* calls above.
    # A partition is late, not lost.
    require(0.8 <= row["blackout"]["spooled_per_tick"] <= 1.0,
            f"egress: {spooled_in_blackout} frames spooled over "
            f"{blackout_ticks} blackout ticks")
    require(spill["drained_total"] == spill["spooled_total"]
            and spill["dropped_total"] == 0 and spill["depth_frames"] == 0
            and spill["undecodable_total"] == 0,
            f"egress: spill accounting {row['spill']}")
    require(delta_row["missing"] <= skipped,
            f"egress: {delta_row['missing']} ticks missing at the sink, "
            f"{skipped} skipped by the publisher: "
            f"{delta_row['missing_ticks']}")
    require(delta_row["resync_fulls_per_reconnect"][0] <= 1
            and all(n <= 1 for n in delta_row["resync_fulls_per_reconnect"])
            and delta_row["resync_fulls_before"] == 0,
            f"egress: FULL resyncs {delta_row}")
    require(409 not in sink.delta_status,
            f"egress: the sink answered 409 {sink.delta_status}")
    for shard in final["remote_write"]["shards"]:
        require(shard["wal_records"] == 0 and shard["dropped_total"] == 0
                and shard["parked_total"] == 0,
                f"egress: remote-write shard {shard}")
        require(shard["lag_seconds"] < 2 * EGRESS_RW_INTERVAL_S,
                f"egress: shard {shard['shard']} lag {shard['lag_seconds']} s")
    # Skew.
    require(out["v1"][1]["publisher"]["negotiated_proto"] == 1,
            "egress: no downgrade to v1")
    require(publisher["negotiated_proto"] == 2
            and publisher["skew_refused_total"]
            > out["v1"][1]["publisher"]["skew_refused_total"],
            f"egress: skew counters {publisher}")
    # Doctor.
    require(rc_live == 0 and all(
        rows_live[name]["status"] == "ok"
        for name in ("egress", "skew", "remote-write")),
        f"egress: doctor live {row['doctor']['live']}")
    require("negotiated v2" in rows_live["skew"]["detail"],
            f"egress: doctor --skew live {rows_live['skew']['detail']}")
    require(rows_black["egress"]["status"] == "warn"
            and "link down" in rows_black["egress"]["detail"]
            and "delta" in rows_black["egress"]["detail"],
            f"egress: doctor --egress in the blackout {row['doctor']}")
    require(rows_refused["skew"]["status"] == "warn"
            and "REFUSED" in rows_refused["skew"]["detail"],
            f"egress: doctor --skew refused {rows_refused['skew']}")
    # Cost: the daemon's own limit.
    for name, window in windows.items():
        require(window["tick"]["p50_ms"] < TICK_BUDGET_MS,
                f"egress: {name} tick p50 {window['tick']}")
    senders = final["senders"]
    require(set(senders) == {"delta", "remote_write", "pushgateway"},
            f"egress: senders {senders}")
    return launches


# -- the hub (a 64-node H100 cluster as one hub sees it) ----------------------

def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_hub(args: list[str], port: int = 0
              ) -> tuple[subprocess.Popen, int, list]:
    """``python -m kube_gpu_stats_tpu_torch hub`` on ``port`` (0 = any);
    returns it, the port its log names, and its log lines."""
    cmd = [sys.executable, "-X", "faulthandler", "-m",
           "kube_gpu_stats_tpu_torch", "hub", "--listen-host", "127.0.0.1",
           "--listen-port", str(port), *args]
    return start_logged(cmd, r"hub serving .* on \S+:(\d+)", "the hub")


def stop_with_stacks(proc: subprocess.Popen, log: list
                     ) -> tuple[int | None, float]:
    """SIGTERM, then (exit code, seconds to exit). A process still
    running after STOP_GRACE_HUB_S gets SIGABRT, so faulthandler prints
    every thread's stack into its log (printed here), then it is killed:
    (None, ...)."""
    t0 = time.monotonic()
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=STOP_GRACE_HUB_S), time.monotonic() - t0
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGABRT)
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        time.sleep(0.5)
        print("\n".join(log[-200:]), file=sys.stderr, flush=True)
        return None, time.monotonic() - t0


def value_strings(text: str) -> list[tuple[str, dict, str]]:
    """(name, labels, value as rendered) of every sample line."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        name, _, raw = head.partition("{")
        labels = dict(validate._tokenize_labels(raw[:-1])) if raw else {}
        out.append((name, labels, value))
    return out


def chip_keys(series) -> dict[tuple, float]:
    """(family, sorted labels) -> value of the per-card series the hub
    re-exports; the key is the hub's own dedup identity."""
    from kube_gpu_stats_tpu_torch.hub import PER_CHIP_SPECS

    return {(name, tuple(sorted(labels.items()))): value
            for name, labels, value in series if name in PER_CHIP_SPECS}


class PublishRecorder:
    """Keeps the newest ``keep`` snapshots an in-process registry
    publishes (every one: the registry's own publish is wrapped)."""

    def __init__(self, registry, keep: int = 400) -> None:
        self.snapshots: collections.deque = collections.deque(maxlen=keep)
        publish = registry.publish

        def recorded(snapshot) -> None:
            publish(snapshot)
            self.snapshots.append(snapshot)

        registry.publish = recorded

    def texts(self) -> list[str]:
        return [snapshot.render() for snapshot in list(self.snapshots)]


class SyntheticFleet:
    """HUB_NODES - 1 synthetic nodes of HUB_CARDS cards each, as the
    port's DeltaPublishers on threads of this process: each republishes
    the real daemon's newest scrape after every hub refresh (every
    second), its card 0's series relabelled per card (uuid, minor, chip,
    device_path, worker)."""

    def __init__(self, hub_url: str, watch: "DaemonWatcher",
                 uuid: str) -> None:
        from kube_gpu_stats_tpu_torch.registry import Registry

        self.hub_url, self.watch, self.uuid = hub_url, watch, uuid
        self._etag = ""
        self.nodes = list(range(1, HUB_NODES))
        self.registries = {n: Registry() for n in self.nodes}
        self.publishers = {n: delta.DeltaPublisher(
            self.registries[n], hub_url, source=self.source(n),
            min_interval=0.2, timeout=10.0) for n in self.nodes}
        self.specs = {m.name: m for m in schema.PER_DEVICE_METRICS
                      if m.type is not schema.MetricType.HISTOGRAM}
        self.paused = threading.Event()
        self.failure: list = []
        self.rounds = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def source(n: int) -> str:
        return f"http://node-{n:02d}.synthetic:9400/metrics"

    def templates(self, mine: list) -> dict[int, list]:
        """node -> [(spec, relabelled labels)] per series, in the
        daemon's order: built once per series shape, so a republish
        only pairs new values with prebuilt Series identities."""
        out = {}
        for n in self.nodes:
            rows = []
            for card in range(HUB_CARDS):
                swap = {"uuid": f"GPU-synthetic-{n:02d}-{card}",
                        "minor": str(card), "chip": str(card),
                        "device_path": f"/dev/nvidia{card}",
                        "worker": f"node-{n:02d}"}
                for name, labels, _ in mine:
                    rows.append((self.specs[name], tuple(
                        (k, swap.get(k, v)) for k, v in labels.items())))
            out[n] = rows
        return out

    def publish_newest(self) -> None:
        from kube_gpu_stats_tpu_torch.registry import Series, SnapshotBuilder

        newest = max(self.watch.texts)
        mine = [(name, labels, value) for name, labels, value
                in validate.parse_exposition(self.watch.texts[newest])
                if labels.get("uuid") == self.uuid and name in self.specs]
        shape = [(name, tuple(labels.items())) for name, labels, _ in mine]
        if shape != getattr(self, "_shape", None):
            self._shape, self._templates = shape, self.templates(mine)
        values = [value for _, _, value in mine] * HUB_CARDS
        for n, rows in self._templates.items():
            builder = SnapshotBuilder()
            builder.extend_series(Series(spec, labels, value) for
                                  (spec, labels), value in zip(rows, values))
            self.registries[n].publish(builder.build())
        self.rounds += 1

    def hub_refreshed(self) -> bool:
        """True once per hub publish: /metrics answers 200 for a new
        generation and 304 (If-None-Match) for the one already seen."""
        request = urllib.request.Request(
            self.hub_url + "/metrics", headers={"If-None-Match": self._etag}
            if self._etag else {})
        try:
            with urllib.request.urlopen(request, timeout=10) as resp:
                resp.read()
                self._etag = resp.headers.get("ETag", "")
                return True
        except urllib.error.HTTPError as exc:
            if exc.code == 304:
                return False
            raise
        except OSError:
            return False             # the hub restarting

    def _run(self) -> None:
        """Republish right after each hub refresh publishes (about once a
        second): the frames land mid-interval, never inside a refresh,
        so one refresh folds and merges the same frame of each node."""
        try:
            while not self._stop.is_set():
                if self.hub_refreshed() and not self.paused.is_set():
                    self.publish_newest()
                self._stop.wait(0.05)
        except Exception as exc:  # noqa: BLE001 - re-raised by stop()
            self.failure.append(exc)

    def start(self) -> float:
        """Start every node and wait until each one's first frame (its
        FULL) has landed; returns the seconds that took."""
        t0 = time.monotonic()
        self.hub_refreshed()        # the generation already published
        for publisher in self.publishers.values():
            publisher.start()       # each pushes the publishes after this
        self.publish_newest()
        while not all(p.pushes_total for p in self.publishers.values()):
            require(time.monotonic() - t0 < 60,
                    "hub: the synthetic nodes' first frames did not land "
                    "in 60 s")
            time.sleep(0.05)
        # The generation published while the first frames landed: the
        # first republish follows the next refresh, as every later one.
        self.hub_refreshed()
        self._thread.start()
        return time.monotonic() - t0

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=30)
        for publisher in self.publishers.values():
            publisher.stop()
        require(not self.failure, f"the synthetic fleet: {self.failure}")

    def states(self, sources: list[str]) -> dict:
        """Diagnostics only: the push state of each synthetic node among
        ``sources`` (the hub's other targets are skipped)."""
        now = time.monotonic()
        out = {}
        for n, p in self.publishers.items():
            if self.source(n) in sources:
                out[f"node-{n:02d}"] = {
                    "pushes": p.pushes_total, "failures": p.failures_total,
                    "consecutive_failures": p.consecutive_failures,
                    "resyncs": p.resyncs_total,
                    "sheds_honored": p.shed_honored_total,
                    "shed_left_s": round(max(0.0, p._shed_until - now), 3),
                    "thread_alive": p.thread_alive()}
        return out

    def frames(self) -> dict:
        full = sum(p._encoder.full_frames for p in self.publishers.values())
        deltas = sum(p._encoder.delta_frames
                     for p in self.publishers.values())
        return {"full": full, "delta": deltas,
                "failures": sum(p.failures_total
                                for p in self.publishers.values()),
                "resyncs": sum(p.resyncs_total
                               for p in self.publishers.values())}


def fold_rows(inputs: list[tuple[str, list]]) -> dict[str, dict]:
    """The slice rollups of one refresh, computed here from its inputs —
    (target, parsed series) in the hub's target order — by the rollup
    definitions: one row per (target, slice, worker, chip) that carries
    a row family, summed, averaged and counted per slice in that
    order."""
    gauges = {schema.DUTY_CYCLE.name: "duty", schema.MEMORY_USED.name: "used",
              schema.MEMORY_TOTAL.name: "total", schema.POWER.name: "power",
              schema.DEVICE_UP.name: "up", schema.ENERGY.name: "energy"}
    row_families = set(gauges) | {
        schema.MEMORY_PEAK.name, schema.TEMPERATURE.name,
        schema.WORKLOAD_MFU.name, schema.WORKLOAD_STEPS.name,
        schema.WORKLOAD_BUSY_SECONDS.name, schema.RUNTIME_RESTARTS.name,
        schema.ICI_BANDWIDTH.name, schema.PROCESS_OPEN.name}
    rows: dict[tuple, dict] = {}
    for target, series in inputs:
        for name, labels, value in series:
            if name not in row_families or (
                    name == schema.PROCESS_OPEN.name
                    and labels.get("comm") == "_overflow"):
                continue
            key = (target, labels.get("slice", ""), labels.get("worker", ""),
                   labels.get("chip", ""))
            row = rows.setdefault(key, {})
            if name in gauges:
                row[gauges[name]] = value
    out: dict[str, dict] = {}
    for key, row in rows.items():
        out.setdefault(key[1], {"rows": [], "workers": set()})
        out[key[1]]["rows"].append(row)
        out[key[1]]["workers"].add(key[2] or key[0])
    fmt = registry_format_value
    rollups = {}
    for slice_name, got in out.items():
        rws = got["rows"]
        duties = [r["duty"] for r in rws if "duty" in r]
        values = {
            "slice_chips": fmt(float(len(rws))),
            "slice_chips_up": fmt(float(sum(1 for r in rws
                                            if r.get("up") == 1.0))),
            "slice_workers": fmt(float(len(got["workers"]))),
            "slice_duty_cycle_mean": fmt(sum(duties) / len(duties)),
            "slice_duty_cycle_min": fmt(min(duties)),
            "slice_duty_cycle_max": fmt(max(duties)),
        }
        for family, column in (("slice_memory_used_bytes", "used"),
                               ("slice_memory_total_bytes", "total"),
                               ("slice_power_watts", "power"),
                               ("slice_energy_joules", "energy")):
            present = [r[column] for r in rws if column in r]
            if present:
                values[family] = fmt(sum(present))
        rollups[slice_name] = values
    return rollups


def registry_format_value(value: float) -> str:
    from kube_gpu_stats_tpu_torch.registry import format_value

    return format_value(value)


def next_hub_text(port: int, etag: str = "", timeout: float = 60.0
                  ) -> tuple[str, str]:
    """The hub's /metrics once its generation's ETag differs from
    ``etag``, and the new ETag. Waits with If-None-Match (a 304 costs
    neither side a render or a parse: parsing the whole exposition in
    a loop here would take the GIL from the burn and the publishers)."""
    deadline = time.monotonic() + timeout
    while True:
        request = urllib.request.Request(
            f"http://127.0.0.1:{port}/metrics",
            headers={"If-None-Match": etag} if etag else {})
        try:
            with urllib.request.urlopen(request, timeout=10) as resp:
                return resp.read().decode(), resp.headers.get("ETag", "")
        except urllib.error.HTTPError as exc:
            if exc.code != 304:
                raise
        require(time.monotonic() < deadline,
                f"hub: no refresh published in {timeout:g} s")
        time.sleep(0.05)


def hub_view(port: int, text: str | None = None) -> dict:
    """One read of the hub: /metrics parsed, with the rendered values."""
    if text is None:
        text = scrape(port)
    series = validate.parse_exposition(text)
    rendered = value_strings(text)

    def one_value(name: str, **labels) -> float | None:
        hits = [v for n, lab, v in series if n == name
                and all(lab.get(k) == w for k, w in labels.items())]
        return hits[0] if hits else None

    return {
        "text": text, "series": series, "rendered": rendered,
        "targets": [lab["target"] for n, lab, _ in series
                    if n == schema.HUB_TARGET_UP.name],
        "up": {lab["target"]: v for n, lab, v in series
               if n == schema.HUB_TARGET_UP.name},
        "refreshes": one_value(schema.HUB_REFRESH_DURATION.name + "_count")
        or 0.0,
        "one": one_value,
        "chips": chip_keys(series)}


def match_inputs(view: dict, embedded_texts, daemon_texts: dict,
                 embedded_url: str, daemon_source: str,
                 oldest_tick: int | None = None) -> dict:
    """Which embedded scrape and which daemon ticks this refresh merged.
    Every per-card series of one embedded scrape (pulled: one body) is
    in the hub's exposition with the same labels and value. The daemon
    pushes every tick, and a frame that lands while the hub folds or
    merges can hand that refresh two adjacent ticks of its values (the
    reference's contract, each series from one of them): every daemon
    series no earlier target claimed carries tick t's value or tick
    t+1's, and the rollups fold tick t-1, t or t+1. The daemon ticks
    looked at are the newest 60, or with ``oldest_tick`` every tick from
    it on. Returns the matches and the daemon series the first-wins
    dedup dropped."""
    hub_chips = view["chips"]
    order = view["targets"]
    require(embedded_url in order and daemon_source in order,
            f"hub: {len(order)} targets, the embedded exporter or the "
            f"daemon not among them")
    embedded = None
    for text in reversed(embedded_texts):
        keys = chip_keys(validate.parse_exposition(text))
        if keys and all(hub_chips.get(k) == v for k, v in keys.items()):
            embedded = (text, keys)
            break
    if embedded is None and embedded_texts:
        keys = chip_keys(validate.parse_exposition(embedded_texts[-1]))
        off = {k: (v, hub_chips.get(k)) for k, v in keys.items()
               if hub_chips.get(k) != v}
        require(False, f"hub: no embedded scrape matches the hub's merged "
                       f"series; the newest differs in {len(off)} of "
                       f"{len(keys)}: {dict(list(off.items())[:3])}")
    embedded_first = order.index(embedded_url) < order.index(daemon_source)
    ticks = sorted(daemon_texts, reverse=True)
    ticks = (ticks[:60] if oldest_tick is None
             else [t for t in ticks if t >= oldest_tick])
    parsed: dict[int, dict] = {}

    def keys_of(t: int) -> dict:
        if t not in parsed:
            parsed[t] = (chip_keys(validate.parse_exposition(daemon_texts[t]))
                         if t in daemon_texts else {})
        return parsed[t]

    daemon = None
    for tick in ticks:
        keys, after = keys_of(tick), keys_of(tick + 1)
        claimed = ({k for k in keys if k in embedded[1]}
                   if embedded_first else set())
        if all(hub_chips.get(k) in (v, after.get(k, v))
               for k, v in keys.items() if k not in claimed):
            # The rows may lag the merged series by one frame: a frame
            # landing while the hub folds a fresh entry's rows.
            texts = [daemon_texts[t] for t in (tick, tick - 1, tick + 1)
                     if t in daemon_texts]
            daemon = (tick, texts, keys, claimed)
            break
    require(daemon is not None,
            "hub: no daemon tick matches the hub's merged series")
    return {"embedded": embedded, "daemon": daemon}


def check_hub_view(view: dict, matched: dict, fleet: SyntheticFleet,
                   embedded_url: str, daemon_source: str) -> dict:
    """Convergence, same numbers as the node, and the rollups of one
    hub refresh; returns what it read."""
    one = view["one"]
    targets = view["targets"]
    want_targets = {embedded_url, daemon_source} | {
        fleet.source(n) for n in fleet.nodes}
    require(set(targets) == want_targets and len(targets) == HUB_NODES + 1,
            f"hub: {len(targets)} targets, missing "
            f"{sorted(want_targets - set(targets))[:5]}")
    down = [t for t, v in view["up"].items() if v != 1]
    require(not down, f"hub: targets down {down}; their publishers "
                      f"{fleet.states(down)}")
    require(one(schema.HUB_TARGETS.name) == HUB_NODES + 1,
            f"hub: slice_targets {one(schema.HUB_TARGETS.name)}")
    require(one(schema.DELTA_PUSH_TARGETS.name) == HUB_NODES,
            f"hub: push-served {one(schema.DELTA_PUSH_TARGETS.name)}")
    tick, daemon_texts, _, claimed = matched["daemon"]
    embedded_text = matched["embedded"][0]
    # The synthetic nodes' inputs: the version each session carries.
    by_worker: dict[str, list] = {}
    for name, labels, value in view["series"]:
        if labels.get("worker", "").startswith("node-") \
                and labels["worker"] != "node-00":
            by_worker.setdefault(labels["worker"], []).append(
                (name, labels, value))
    # One expectation per daemon tick the refresh may have folded; each
    # rollup family must equal one of them exactly.
    expectations = []
    for daemon_text in daemon_texts:
        inputs = []
        for target in targets:
            if target == embedded_url:
                inputs.append((target,
                               validate.parse_exposition(embedded_text)))
            elif target == daemon_source:
                inputs.append((target,
                               validate.parse_exposition(daemon_text)))
            else:
                worker = target.split("//", 1)[1].split(".", 1)[0]
                inputs.append((target, by_worker.get(worker, [])))
        expectations.append(fold_rows(inputs))
    expected = expectations[0]
    rendered = {(name, labels.get("slice")): value
                for name, labels, value in view["rendered"]
                if name.startswith("slice_") and set(labels) == {"slice"}}
    require(set(expected) == {HUB_SLICE}, f"hub: slices {sorted(expected)}")
    require(expected[HUB_SLICE]["slice_workers"]
            == registry_format_value(float(HUB_NODES)),
            f"hub: {expected[HUB_SLICE]['slice_workers']} workers present")
    mismatched = {family: ([e[HUB_SLICE].get(family) for e in expectations],
                           rendered.get((family, HUB_SLICE)))
                  for family in expected[HUB_SLICE]
                  if rendered.get((family, HUB_SLICE)) not in
                  [e[HUB_SLICE].get(family) for e in expectations]}
    require(not mismatched, f"hub: rollups differ from their inputs: "
                            f"{mismatched}")
    require(one(schema.HUB_DUPLICATE_SERIES.name) == len(claimed),
            f"hub: slice_duplicate_series "
            f"{one(schema.HUB_DUPLICATE_SERIES.name)} != {len(claimed)} "
            f"series both the embedded exporter and the daemon serve")
    ratio = one(schema.HUB_STRAGGLER_RATIO.name, slice=HUB_SLICE)
    require(ratio is not None and 0 < ratio <= 1,
            f"hub: slice_straggler_ratio {ratio}")
    return {"daemon_tick": tick, "duplicates": len(claimed),
            "duplicate_families": sorted({k[0] for k in claimed}),
            "rollups": expected[HUB_SLICE],
            "steps_per_s": one(schema.HUB_WORKER_STEPS.name,
                               slice=HUB_SLICE, worker="node-00"),
            "straggler_ratio": ratio,
            "refreshes": view["refreshes"]}


def wait_converged(port: int, from_refresh: float, what: str, match,
                   misses: list | None = None) -> tuple[dict, dict]:
    """The first hub refresh after ``from_refresh`` whose view passes
    every check; fails when none of the next HUB_CONVERGE_REFRESHES
    refreshes does. Each refresh that failed a check before it appends
    (refresh, reason) to ``misses``."""
    last_error = None
    etag = ""
    while True:
        text, etag = next_hub_text(port, etag)
        view = hub_view(port, text)
        require(view["refreshes"] - from_refresh <= HUB_CONVERGE_REFRESHES,
                f"hub: {what} not converged within "
                f"{HUB_CONVERGE_REFRESHES} refreshes: {last_error}"
                + (f"; every miss: {misses}" if misses else ""))
        try:
            return view, match(view)
        except RuntimeError as exc:
            last_error = exc
            if misses is not None:
                misses.append((view["refreshes"], str(exc)[:300]))


def hub_cycles_ms(port: int, slowest: list | None = None) -> list[float]:
    """Every recorded refresh's whole-cycle ms (the hub's /debug/trace);
    appends the slowest one's ms and its spans' ms to ``slowest``."""
    status, body, _ = fetch(f"http://127.0.0.1:{port}/debug/trace?last=128")
    require(status == 200, f"hub /debug/trace answered {status}")
    events = json.loads(body)["traceEvents"]
    cycles = [event for event in events if event["cat"] == "cycle"]
    if slowest is not None and cycles:
        worst = max(cycles, key=lambda event: event["dur"])
        end = worst["ts"] + worst["dur"]
        slowest.append({"ms": worst["dur"] / 1e3, "spans": {
            event["name"]: event["dur"] / 1e3 for event in events
            if event["cat"] == "span"
            and worst["ts"] <= event["ts"] <= end}})
    return [event["dur"] / 1e3 for event in cycles]


def lane_apply(view: dict) -> tuple[float, float, float]:
    """(apply seconds, FULL frames, DELTA frames) from the ingest's own
    counters."""
    seconds = sum(v for n, _, v in view["series"]
                  if n == schema.INGEST_LANE_APPLY_SECONDS.name)
    one = view["one"]
    return (seconds, one(schema.DELTA_FRAMES.name, kind="full") or 0.0,
            one(schema.DELTA_FRAMES.name, kind="delta") or 0.0)


def run_hub_doctor(port: int) -> tuple[int, dict]:
    proc = subprocess.run(
        [sys.executable, "-m", "kube_gpu_stats_tpu_torch", "doctor",
         "--backend", "nvml", "--attribution", "off", "--json", "--url",
         f"http://127.0.0.1:{port}/metrics", "--cardinality", "--skew",
         "--stores"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    payload = json.loads(proc.stdout)
    return proc.returncode, {row["name"]: row for row in payload["checks"]}


def check_top(port: int) -> dict:
    """``top --once --json`` against the hub: exit 0 and its rows equal
    the hub's merged rows (the hub read just before or just after it);
    the table form: a row for every worker and the rollup footer."""
    from kube_gpu_stats_tpu_torch import top

    url = f"http://127.0.0.1:{port}/metrics"
    for _ in range(5):
        before = scrape(port)
        proc = subprocess.run(
            [sys.executable, "-m", "kube_gpu_stats_tpu_torch", "top",
             "--once", "--json", url], cwd=ROOT, capture_output=True,
            text=True, timeout=60)
        after = scrape(port)
        require(proc.returncode == 0, f"top --json exited "
                                      f"{proc.returncode}: {proc.stderr}")
        got = json.loads(proc.stdout)["chips"]
        candidates = []
        for text in (before, after):
            frame = top.build_frame([text], [], [0.0], targets=[url])
            candidates.append(json.loads(top.render_json(frame))["chips"])
        if got in candidates:
            break
    else:
        require(False, "top --json rows never equal the hub's merged rows")
    table = subprocess.run(
        [sys.executable, "-m", "kube_gpu_stats_tpu_torch", "top", "--once",
         url], cwd=ROOT, capture_output=True, text=True, timeout=60)
    require(table.returncode == 0, f"top exited {table.returncode}")
    lines = table.stdout.splitlines()
    workers = {f"node-{n:02d}" for n in range(HUB_NODES)}
    shown = {w for w in workers
             if any(f"/w{w} " in line or line.rstrip().endswith(f"/w{w}")
                    or f"/w{w}" in line for line in lines)}
    footer = [line for line in lines if HUB_SLICE in line
              and "workers" in line]
    require(shown == workers, f"top table: workers missing "
                              f"{sorted(workers - shown)[:5]}")
    require(footer, f"top table: no rollup footer: {lines[-3:]}")
    return {"rows": len(got), "workers": len(shown), "footer": footer[0],
            "lines": len(lines)}

# -- the hub's history ring and its ingest processes ---------------------------

# The families the hub's rollup seam records in its ring: every slice
# rollup series and each target's slice_target_up.
RING_FAMILIES = frozenset(spec.name for spec in (
    schema.HUB_TARGET_UP, schema.HUB_CHIPS, schema.HUB_CHIPS_UP,
    schema.HUB_WORKERS, schema.HUB_DUTY_MEAN, schema.HUB_DUTY_MIN,
    schema.HUB_DUTY_MAX, schema.HUB_MFU_MEAN, schema.HUB_MFU_MIN,
    schema.HUB_MEMORY_USED, schema.HUB_MEMORY_TOTAL, schema.HUB_POWER,
    schema.HUB_ICI_BANDWIDTH, schema.HUB_ENERGY, schema.HUB_WORKER_STEPS,
    schema.HUB_STRAGGLER_RATIO))
# One ring series' slab with the default tiers: (360 + 288 + 168) slots,
# each an f64 mean, a u32 count and an i64 bucket id.
SERIES_BYTES = sum(slots * 20 for _, _, slots in history.DEFAULT_TIERS)
DUTY_RE = re.compile(r'^slice_duty_cycle_mean\{slice="' + HUB_SLICE
                     + r'"\} (\S+)$', re.M)
SLICE_LINE_RE = re.compile(r"^(slice_\w+)(\{[^}]*\})? \S+$", re.M)
METRICS_ETAG_RE = re.compile(r'^"(\w+)-(\d+)-m\d\d"$')
QUERY_NONCE_RE = re.compile(r'^"h[0-9a-f]+-')


def http_get(port: int, path: str, headers: dict | None = None
             ) -> tuple[int, bytes, dict]:
    """(status, body, headers) of one GET on a fresh connection."""
    request = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     headers=headers or {})
    try:
        with urllib.request.urlopen(request, timeout=30) as resp:
            return resp.status, resp.read(), dict(resp.headers.items())
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read(), dict(exc.headers.items())


class HubRecorder:
    """Every generation one hub publishes, read on a thread from before
    the hub binds its port until ``stop``: per generation the wall time
    this script first saw it, the start of the last read before that
    which still answered an older generation (the generation was
    published after it), ``slice_duty_cycle_mean``'s value, and
    the generation at which each ring identity (a rollup series or a
    ``slice_target_up``) was first served; unless ``quiet`` is set, also
    ``/query``'s answer for ``slice_chips`` at that generation: its
    ETag, its ``as_of`` (the wall time the ring committed that
    generation) and the first answer whole. Every ``/query`` of the
    phase to this hub goes through ``query``, which counts the 429s this
    client drew."""

    def __init__(self, port: int) -> None:
        self.port = port
        self.seen: dict[int, tuple[float, float | None, float]] = {}
        self.first_seen: dict[tuple, int] = {}
        self.query_etags: dict[int, str] = {}
        self.commit_at: dict[int, float] = {}
        self._raw_seen: set = set()
        self.first_query: tuple[int, dict] | None = None
        self.boot = ""
        self.shed = 0
        self.quiet = threading.Event()
        self.failure: list = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "HubRecorder":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)
        require(not self.failure, f"reading the hub's generations: "
                                  f"{self.failure}")

    def query(self, params: str, headers: dict | None = None
              ) -> tuple[int, bytes, dict]:
        status, body, got = http_get(self.port, "/query?" + params, headers)
        if status == 429:
            with self._lock:
                self.shed += 1
        return status, body, got

    def newest(self) -> int:
        return max(self.seen, default=-1)

    def wait_generation(self, generation: int, timeout: float = 30.0
                        ) -> None:
        deadline = time.monotonic() + timeout
        while self.newest() < generation:
            require(time.monotonic() < deadline,
                    f"hub: generation {generation} not seen in {timeout} s")
            time.sleep(0.02)

    def identities(self, before: int) -> set:
        """The ring identities first served before ``before``."""
        return {key for key, g in list(self.first_seen.items())
                if g < before}

    def _observe(self, text: str, etag: str, after: float) -> None:
        match = METRICS_ETAG_RE.match(etag)
        if match is None:
            return
        self.boot, generation = match.group(1), int(match.group(2))
        if generation in self.seen:
            return
        seen_at = time.time()
        duty = DUTY_RE.search(text)
        self.seen[generation] = (seen_at,
                                 float(duty.group(1)) if duty else None,
                                 after)
        # Regex scans only: this thread shares the interpreter lock
        # with the burn and the synthetic fleet.
        for name, raw in SLICE_LINE_RE.findall(text):
            if name in RING_FAMILIES and (name, raw) not in self._raw_seen:
                self._raw_seen.add((name, raw))
                labels = frozenset(validate._tokenize_labels(raw[1:-1])
                                   if raw else ())
                self.first_seen.setdefault((name, labels), generation)
        if self.quiet.is_set():
            return
        status, body, got = self.query(
            f"family={schema.HUB_CHIPS.name}&window=1h")
        if status == 200:
            payload = json.loads(body)
            self.query_etags[payload["generation"]] = got["ETag"]
            self.commit_at[payload["generation"]] = payload["as_of"]
            if self.first_query is None:
                self.first_query = (payload["generation"], payload)

    def _run(self) -> None:
        etag = ""
        older = 0.0     # start of the newest read that answered an older
        while not self._stop.is_set():
            asked = time.time()
            try:
                request = urllib.request.Request(
                    f"http://127.0.0.1:{self.port}/metrics",
                    headers={"If-None-Match": etag} if etag else {})
                with urllib.request.urlopen(request, timeout=10) as resp:
                    text = resp.read().decode()
                    new = resp.headers.get("ETag", "")
                if new:
                    if new != etag:
                        self._observe(text, new, older)
                    etag = new
                older = asked
            except urllib.error.HTTPError:
                older = asked        # 304: no new generation yet
            except OSError:
                pass                 # the hub not up yet, or restarting
            except Exception as exc:  # noqa: BLE001 - re-raised by stop()
                self.failure.append(exc)
                return
            self._stop.wait(HUB_POLL_S)


def ring_families(rec: HubRecorder) -> list[str]:
    """The families the hub's ring tracks, as its 400 answer lists them."""
    status, body, _ = rec.query("family=")
    require(status == 400, f"hub /query without a family answered {status}")
    listed = body.decode().strip().split("tracked families: ", 1)[1]
    return [family for family in listed.split(",") if family]


def check_ring_identities(rec: HubRecorder, port: int) -> dict:
    """The identities the phase offered the ring are the ones it holds:
    ``kts_history_series`` + ``kts_history_series_shed_total`` equal the
    ring identities the hub served before that generation, the slab
    bytes are series x SERIES_BYTES, and /query lists exactly the
    identities the hub served."""
    text, etag = next_hub_text(port)
    generation = int(METRICS_ETAG_RE.match(etag).group(2))
    rec.wait_generation(generation)
    # Every ring identity, once served, is served by every later
    # generation (no target leaves this phase), so a generation this
    # script missed hides none; the two just before this one it needs.
    missing = sorted(set(range(min(rec.seen), generation + 1))
                     - set(rec.seen))
    require(min(rec.seen) <= 1 and generation - 1 in rec.seen,
            f"hub: generations not read: first {min(rec.seen)}, missing "
            f"{missing[:10]}")
    view = hub_view(port, text)
    series = view["one"](schema.HISTORY_SERIES.name)
    shed = view["one"](schema.HISTORY_SERIES_SHED.name)
    held = view["one"](schema.HISTORY_BYTES.name)
    offered = rec.identities(generation)
    ring: set = set()
    generations = []
    for family in ring_families(rec):
        status, body, _ = rec.query(f"family={family}&window=1h")
        require(status == 200, f"hub /query {family} answered {status}")
        payload = json.loads(body)
        generations.append(payload["generation"])
        ring |= {(family, frozenset(s["labels"].items()))
                 for s in payload["series"]}
    low, high = min(generations), max(generations)
    require(rec.identities(low + 1) <= ring <= rec.identities(high + 1),
            f"hub: the ring holds {len(ring)} identities, the hub served "
            f"{len(rec.identities(high + 1))}: missing "
            f"{sorted(map(str, rec.identities(low + 1) - ring))[:3]}, "
            f"extra {sorted(map(str, ring - rec.identities(high + 1)))[:3]}")
    require(series + shed == len(offered),
            f"hub: kts_history_series {series} + shed {shed} != "
            f"{len(offered)} identities offered")
    require(held == series * SERIES_BYTES,
            f"hub: kts_history_bytes {held} != {series} x {SERIES_BYTES}")
    by_family = collections.Counter(family for family, _ in ring)
    return {"generation": generation, "series": series, "shed": shed,
            "bytes": held, "identities": len(offered),
            "generations_missed": len(missing),
            "target_up": by_family[schema.HUB_TARGET_UP.name],
            "families": len(by_family),
            "per_family": dict(sorted(by_family.items()))}


def check_ring_duty(rec: HubRecorder, window: str, step: float) -> dict:
    """/query for ``slice_duty_cycle_mean`` in ``window``: each bucket's
    mean is the mean of the values the hub published in that bucket
    where the bucket of every generation is known (from the commit time
    /query reported for it, else from when this script saw it, away
    from an edge), and lies within their min and max where a generation
    near an edge may lie in either bucket. A bucket that may hold a
    generation this script did not read is bounded, in a coarser tier,
    by the ``1h`` bucket means of the same generation that fall in it,
    and left unchecked in ``1h`` itself."""
    family = schema.HUB_DUTY_MEAN.name
    for _ in range(5):
        status, body, _ = rec.query(f"family={family}&window={window}")
        require(status == 200, f"hub /query duty {window} answered "
                               f"{status}")
        payload = json.loads(body)
        finer = None
        if window == "1h":
            break
        _, fine_body, _ = rec.query(f"family={family}&window=1h")
        fine = json.loads(fine_body)
        if fine["generation"] == payload["generation"]:
            (finer,) = [s["samples"] for s in fine["series"]
                        if s["labels"] == {"slice": HUB_SLICE}]
            break
    else:
        require(False, f"hub: {window} and 1h never read one generation")
    require(payload["step_s"] == step, f"hub: {window} step "
                                       f"{payload['step_s']}")
    generation = payload["generation"]
    rec.wait_generation(generation)
    (series,) = [s for s in payload["series"]
                 if s["labels"] == {"slice": HUB_SLICE}]
    known: dict[int, tuple[int, int, float | None]] = {}
    for g, (seen_at, v, after) in list(rec.seen.items()):
        if g > generation:
            continue
        committed = rec.commit_at.get(g)
        if committed is not None:
            low = high = int(committed // step)
        else:
            # Published after ``after``; committed just after the
            # publish, so before this script saw it or shortly after.
            low = math.floor(after / step)
            high = math.floor((seen_at + HUB_COMMIT_EARLY_S) / step)
        known[g] = (low, high, v)
    values = [bounds for bounds in known.values() if bounds[2] is not None]
    # A generation this script did not read holds an unknown value in a
    # bucket between its neighbours': those buckets are not checked.
    tainted: set = set()
    for g in range(1, generation + 1):
        if g in known:
            continue
        before = [known[h][0] for h in known if h < g]
        after = [known[h][1] for h in known if h > g]
        low = max(before) if before else -10**12
        high = min(after) if after else 10**12
        tainted |= {b for b in (round(st / step)
                                for st, _ in series["samples"])
                    if low <= b <= high}
    exact = bounded = 0
    ring_buckets = set()
    for start, mean in series["samples"]:
        bucket = round(start / step)
        ring_buckets.add(bucket)
        tol = HISTORY_REL_TOL * max(1.0, abs(mean))
        if bucket in tainted:
            if finer is not None:
                inner = [v for st, v in finer if start <= st < start + step]
                require(inner and min(inner) - tol <= mean
                        <= max(inner) + tol,
                        f"hub: {window} bucket {start}: ring {mean} "
                        f"outside its 1h buckets' means {inner}")
                bounded += 1
            continue
        sure, maybe = [], []
        for low, high, v in values:
            if low <= bucket <= high:
                maybe.append(v)
                if low == high:
                    sure.append(v)
        require(maybe, f"hub: {window} bucket {start} holds {mean}, but "
                       f"no published value falls in it")
        if len(sure) == len(maybe):
            want = math.fsum(sure) / len(sure)
            require(abs(mean - want) <= tol,
                    f"hub: {window} bucket {start}: ring {mean} != mean "
                    f"{want} of {len(sure)} published values")
            exact += 1
        else:
            require(min(maybe) - tol <= mean <= max(maybe) + tol,
                    f"hub: {window} bucket {start}: ring {mean} outside "
                    f"[{min(maybe)}, {max(maybe)}]")
            bounded += 1
    slots = {n: c for n, _, c in history.DEFAULT_TIERS}[window]
    newest = int(payload["as_of"] // step)
    for low, high, _v in values:
        if low == high and newest - low < slots:
            require(low in ring_buckets,
                    f"hub: {window}: a value published in bucket "
                    f"{low * step} is in no bucket of the ring")
    if finer is None:
        require(exact >= 1, f"hub: {window}: no bucket whose every "
                            f"generation is known ({bounded} bounded)")
    else:
        require(exact + bounded == len(ring_buckets),
                f"hub: {window}: {len(ring_buckets)} buckets, {exact} "
                f"exact, {bounded} bounded")
    unchecked = len(ring_buckets) - exact - bounded
    return {"generation": generation, "buckets": len(ring_buckets),
            "exact": exact, "bounded": bounded, "unchecked": unchecked,
            "values": len(values),
            "commit_times_known": sum(1 for low, high, _ in values
                                      if low == high)}


def check_ring_at(rec: HubRecorder) -> dict:
    """``at=`` 5 s back answers the ring's populated bucket nearest it
    (the earlier one on a tie), from the 1h range read at the same
    generation."""
    family = schema.HUB_DUTY_MEAN.name
    for _ in range(5):
        ts = time.time() - 5.0
        _, at_body, _ = rec.query(f"family={family}&at={ts!r}")
        _, range_body, _ = rec.query(f"family={family}&window=1h")
        at_payload, ranged = json.loads(at_body), json.loads(range_body)
        if at_payload["as_of"] == ranged["as_of"]:
            break
    else:
        require(False, "hub: at= and the range never read one generation")
    (series,) = [s for s in ranged["series"]
                 if s["labels"] == {"slice": HUB_SLICE}]
    want = int(ts // 10.0)
    start, mean = min(series["samples"], key=lambda sample: (
        abs(round(sample[0] / 10.0) - want), round(sample[0] / 10.0) > want))
    (hit,) = [s for s in at_payload["series"]
              if s["labels"] == {"slice": HUB_SLICE}]
    require((hit["t"], hit["v"], hit["window"]) == (start, mean, "1h"),
            f"hub: at={ts} answered {hit}, the nearest bucket is "
            f"[{start}, {mean}]")
    return {"at": ts, "bucket": start, "back_s": ts - start}


def check_query_caching(rec: HubRecorder) -> dict:
    """A repeat with the ETag draws 304; the gzip body decompresses to
    the identity body of the same ETag."""
    path = f"family={schema.HUB_TARGET_UP.name}&window=1h"
    not_modified = same_document = False
    for _ in range(5):
        status, plain, got = rec.query(path)
        require(status == 200, f"hub /query answered {status}")
        status, body, again = rec.query(path, {"If-None-Match": got["ETag"]})
        if status == 304:
            require(body == b"" and again["ETag"] == got["ETag"],
                    f"hub: 304 with {len(body)} bytes, ETag {again}")
            not_modified = True
        status, gz, zipped = rec.query(path, {"Accept-Encoding": "gzip"})
        if status == 200 and zipped["ETag"] == got["ETag"]:
            require(zipped.get("Content-Encoding") == "gzip",
                    f"hub: /query gzip answer {zipped}")
            require(gzip.decompress(gz) == plain,
                    "hub: the gzip /query body is another document")
            same_document = True
        if not_modified and same_document:
            return {"etag": got["ETag"], "bytes": len(plain),
                    "gzip_bytes": len(gz)}
    require(False, f"hub: no 304 ({not_modified}) or no same-document "
                   f"gzip body ({same_document}) in 5 tries")


# The stampede runs in an interpreter of its own, so the burn and the
# synthetic fleet in this one do not pace it, over plain sockets (one
# request per connection, as a browser tab's poll); it prints each
# answer's status and Retry-After, and the seconds the reads took.
_STAMPEDE = """
import concurrent.futures, json, socket, sys, time
port, path = int(sys.argv[1]), sys.argv[2]
count, threads = int(sys.argv[3]), int(sys.argv[4])
request = (f"GET {path} HTTP/1.1\\r\\nHost: 127.0.0.1\\r\\n"
           "Connection: close\\r\\n\\r\\n").encode()

def read(_):
    start = time.monotonic()
    with socket.create_connection(("127.0.0.1", port), timeout=30) as sock:
        sock.sendall(request)
        chunks = []
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                break
            chunks.append(chunk)
    head = b"".join(chunks).split(b"\\r\\n\\r\\n", 1)[0].decode()
    lines = head.split("\\r\\n")
    headers = dict(line.split(": ", 1) for line in lines[1:] if ": " in line)
    return (int(lines[0].split()[1]), headers.get("Retry-After"),
            time.monotonic() - start)

t0 = time.monotonic()
with concurrent.futures.ThreadPoolExecutor(threads) as pool:
    answers = list(pool.map(read, range(count)))
print(json.dumps({"answers": answers, "elapsed": time.monotonic() - t0}))
"""


def query_stampede(rec: HubRecorder, port: int) -> dict:
    """HUB_STAMPEDE /query reads from this client at once: the gate
    sheds with 429 and a Retry-After, and ``kts_query_shed_total``
    counts exactly the 429s this client drew."""
    rec.quiet.set()
    path = f"/query?family={schema.HUB_CHIPS.name}&window=1h"
    proc = subprocess.run([sys.executable, "-c", _STAMPEDE, str(port), path,
                           str(HUB_STAMPEDE), str(HUB_STAMPEDE_THREADS)],
                          capture_output=True, text=True, timeout=120)
    require(proc.returncode == 0, f"hub: the stampede: {proc.stderr}")
    result = json.loads(proc.stdout)
    elapsed = result["elapsed"]
    shed = [{"Retry-After": retry or "0"}
            for status, retry, _ in result["answers"] if status == 429]
    rec.shed += len(shed)
    reads_ms = sorted(took * 1e3 for _, _, took in result["answers"])
    if elapsed >= 1.0:
        slowest: list = []
        hub_cycles_ms(port, slowest)
        require(False, f"hub: the stampede took {elapsed:.3f} s (reads "
                       f"p50 {reads_ms[len(reads_ms) // 2]:.1f} ms, max "
                       f"{reads_ms[-1]:.1f} ms; the hub's slowest recent "
                       f"refresh {slowest})")
    require(all(int(got.get("Retry-After", "0")) >= 1 for got in shed),
            "hub: a 429 without Retry-After")
    least = HUB_STAMPEDE - HUB_QUERY_BURST - math.ceil(
        HUB_QUERY_QPS * elapsed) - 1
    require(len(shed) >= least, f"hub: {len(shed)} of {HUB_STAMPEDE} shed "
                                f"in {elapsed:.3f} s, at least {least}")
    # Shed counts ride the next publish: two generations on, the served
    # count is every 429 this client has drawn from this hub.
    generation = rec.newest()
    rec.wait_generation(generation + 2)
    text, _ = next_hub_text(port)
    served = hub_view(port, text)["one"](schema.QUERY_SHED.name)
    require(served == rec.shed, f"hub: kts_query_shed_total {served}, "
                                f"this client drew {rec.shed} 429s")
    time.sleep(HUB_QUERY_BURST / HUB_QUERY_QPS)     # the bucket refills
    rec.quiet.clear()
    return {"requests": HUB_STAMPEDE, "shed": len(shed),
            "elapsed_s": elapsed, "shed_served": served,
            "reads_ms": {"p50": reads_ms[len(reads_ms) // 2],
                         "max": reads_ms[-1]}}


def check_restart_etags(old: HubRecorder, new: HubRecorder,
                        t_down: float) -> dict:
    """The restarted hub's ring holds nothing from before the restart,
    and its /query ETags differ from the old hub's at the same
    generation (the per-boot nonce), the rest of the tag alike."""
    require(new.first_query is not None, "hub: the restarted hub's ring "
                                         "never answered /query")
    generation, payload = new.first_query
    first_bucket = math.floor(t_down / 10.0) * 10.0
    starts = [sample[0] for s in payload["series"] for sample in s["samples"]]
    require(starts and min(starts) >= first_bucket
            and all(len(s["samples"]) <= generation
                    for s in payload["series"]),
            f"hub: the restarted ring's first answer (generation "
            f"{generation}) holds buckets from {min(starts, default=None)} "
            f"(restart at {t_down})")
    common = sorted(set(old.query_etags) & set(new.query_etags))
    require(common, "hub: no generation read from both hubs")
    for g in common:
        a, b = old.query_etags[g], new.query_etags[g]
        require(a != b and QUERY_NONCE_RE.sub("", a)
                == QUERY_NONCE_RE.sub("", b),
                f"hub: generation {g}: ETags {a} and {b}")
    return {"first_generation": generation, "series": len(payload["series"]),
            "common_generations": len(common),
            "etags": [old.query_etags[common[0]],
                      new.query_etags[common[0]]]}


def time_wait_on(port: int) -> int:
    """Connections in TIME_WAIT on local port ``port`` (IPv4)."""
    count = 0
    for line in pathlib.Path("/proc/net/tcp").read_text().splitlines()[1:]:
        fields = line.split()
        local, state = fields[1], fields[3]
        if int(local.split(":")[1], 16) == port and state == "06":
            count += 1
    return count


def ring_cost(identities: int, refreshes: int = 2000,
              reads: int = 2000) -> dict:
    """The ring's cost on this host, with the port's HistoryStore in
    this process before the phase starts anything: record of
    ``identities`` samples and one commit per refresh, and a hot /query
    (the cached response of the served generation)."""
    store = history.HistoryStore(query_qps=0.0)
    keys = [(schema.HUB_TARGET_UP.name, (("target", f"t{i}"),))
            for i in range(identities)]
    now = time.time()
    t0 = time.perf_counter()
    for refresh in range(refreshes):
        for family, labels in keys:
            store.record(family, labels, float(refresh))
        store.commit(now + 10.0 * refresh, refresh + 1)
    per_refresh = (time.perf_counter() - t0) / refreshes
    params = {"family": schema.HUB_TARGET_UP.name, "window": "1h"}
    store.handle_query(dict(params), "c", False, "")
    t0 = time.perf_counter()
    for _ in range(reads):
        store.handle_query(dict(params), "c", False, "")
    hot = (time.perf_counter() - t0) / reads
    return {"identities": identities, "record_commit_us": per_refresh * 1e6,
            "hot_query_us": hot * 1e6,
            "cache_hits": store.cache_hits_total}


def children_of(pid: int) -> list[int]:
    """The live (not zombie) processes whose parent is ``pid``."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            fields = pathlib.Path(f"/proc/{entry}/stat").read_text(
                ).rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            out.append(int(entry))
    return sorted(out)


def rss_mib(pid: int) -> float:
    for line in pathlib.Path(f"/proc/{pid}/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 1024
    return 0.0


def relay_probe_ms(port: int, count: int = HUB_PROBES) -> dict:
    """Round trips of a DELTA for a source the hub has no session for
    (409, no state touched), each on a fresh connection: the cost of one
    frame's trip through the hub's POST path."""
    wire = delta.encode_delta("http://relay-probe.synthetic:9400/metrics",
                              1, 2, [(0, 1.0)])
    times = []
    for _ in range(count):
        t0 = time.perf_counter()
        request = urllib.request.Request(
            f"http://127.0.0.1:{port}{delta.INGEST_PATH}", data=wire,
            method="POST", headers={"Content-Type": delta.CONTENT_TYPE})
        try:
            urllib.request.urlopen(request, timeout=10).read()
            status = 200
        except urllib.error.HTTPError as exc:
            status = exc.code
        times.append((time.perf_counter() - t0) * 1e3)
        require(status == 409, f"hub: relay probe answered {status}")
    return {"p50_ms": statistics.median(times), "max_ms": max(times),
            "count": count}


def proc_counts(view: dict, family: str) -> dict[str, float]:
    return {labels["proc"]: value for name, labels, value in view["series"]
            if name == family}


def child_start() -> dict:
    """One acceptor child started as the hub starts one: seconds from
    spawn to its HELLO (its port bound), and its RSS."""
    t0 = time.monotonic()
    pool = ingestproc.IngestProcPool(lambda wire, peer="": (200, b"", {}),
                                     host="127.0.0.1", port=0, procs=1)
    try:
        pool.start()
        started = time.monotonic() - t0
        rss = rss_mib(pool._children[0].pid)
    finally:
        pool.stop()
    return {"start_s": started, "rss_mib": rss}


def daemon_push_failures(watch: "DaemonWatcher") -> float:
    """The daemon's failed delta pushes, from its newest scrape."""
    texts = dict(watch.texts)
    series = validate.parse_exposition(texts[max(texts)])
    return sum(value for name, labels, value in series
               if name == "collector_push_failures_total"
               and labels.get("mode") == "delta")


def quiet_conservation(port: int, fleet_failures: float) -> dict:
    """With every publisher stopped, two publishes on: the children's
    accepted frames against the hub's applied FULL and DELTA frames.
    The hub's duplicate count (a FULL re-sent after its answer was lost)
    is not served, so the difference must be 0 or, at most, the pushes
    the publishers saw fail."""
    text, etag = next_hub_text(port)
    text, etag = next_hub_text(port, etag)
    text, _ = next_hub_text(port, etag)
    view = hub_view(port, text)
    accepted = proc_counts(view, schema.INGEST_PROC_ACCEPTED.name)
    _, full, deltas = lane_apply(view)
    difference = sum(accepted.values()) - (full + deltas)
    require(0 <= difference <= fleet_failures,
            f"hub: the children accepted {sum(accepted.values())} frames, "
            f"the hub applied {full} FULL + {deltas} DELTA")
    return {"accepted": accepted, "full": full, "delta": deltas,
            "difference": difference,
            "resyncs": view["one"](schema.HUB_RESYNC.name),
            "frames": proc_counts(view, schema.INGEST_PROC_FRAMES.name)}



def phase_hub(card_line: str, c5_tick_ms: dict,
              main_cuda_steps_per_s: float) -> int:
    """The hub core over a 64-node H100 cluster on card 0: the hub as a
    subprocess over a targets file naming the embedded exporter of a
    ``cuda`` burn in this process (pulled); the NVML daemon at 10 Hz
    pushing to it; 63 synthetic nodes of 8 cards each as delta
    publishers on threads of this process (pushed). A live window, with
    the history ring read back against every generation the hub
    published; a warm restart from the ingest checkpoint, a second live
    window; a third hub on the same port and checkpoint with the ingest
    spread over HUB_PROCS acceptor processes, one of them killed; the
    conservation law once nothing pushes. Returns the kernel launches."""
    workdir = tempfile.mkdtemp(prefix="kts-hub-")
    targets_file = os.path.join(workdir, "targets.txt")
    checkpoint = os.path.join(workdir, "ingest.json")
    # The ring's own cost, at the identity count this phase offers it
    # (65 targets and the slice's rollup series).
    cost = ring_cost(HUB_NODES + 1 + 14)
    hub_args = ["--interval", str(HUB_INTERVAL_S), "--ingest-checkpoint",
                checkpoint, "--expect-workers", str(HUB_NODES),
                "--targets-file", targets_file]
    saved_env = {k: os.environ.get(k) for k in ("KTS_SLICE", "KTS_WORKER")}
    os.environ["KTS_SLICE"], os.environ["KTS_WORKER"] = HUB_SLICE, "node-00"
    exporter = embedded.start(0, interval=HUB_EMBEDDED_INTERVAL_S)
    recorder = PublishRecorder(exporter.registry)
    embedded_url = f"http://127.0.0.1:{exporter.port}/metrics"
    with open(targets_file, "w") as handle:
        handle.write(f"# the embedded exporter of the cuda burn\n"
                     f"{embedded_url}\n")
    daemon_port = free_port()
    daemon_source = f"http://127.0.0.1:{daemon_port}/metrics"
    hub_proc = daemon_proc = fleet = None
    out: dict = {}
    failure: list = []
    steps_log: list = []
    recorders: dict[str, HubRecorder] = {}
    fleet_stopped = False
    saved_switch = sys.getswitchinterval()
    gc.collect()
    gc.freeze()
    sys.setswitchinterval(HUB_SWITCH_S)
    try:
        # The recorder reads the hub from before it binds, so it sees its
        # first generation.
        hub_port = free_port()
        rec1 = recorders["first"] = HubRecorder(hub_port).start()
        t_start = time.monotonic()
        hub_proc, hub_port, hub_log = start_hub(hub_args, hub_port)
        out["hub_start_s"] = time.monotonic() - t_start
        hub_url = f"http://127.0.0.1:{hub_port}"
        daemon_proc, port, log = start_daemon(workdir, (
            "--interval", str(HUB_DAEMON_INTERVAL_S), "--textfile-dir", "",
            "--listen-port", str(daemon_port), "--hub-url", hub_url,
            "--hub-push-source", daemon_source, "--hub-push-interval",
            "0.01", "--hub-spill-dir", os.path.join(workdir, "spill")))
        with DaemonWatcher(daemon_proc, port, log, conform=True,
                           keep_texts=True) as watch:

            # A restarted hub serves the daemon's checkpointed state
            # until the daemon's next frame lands: through the restart,
            # the daemon ticks looked at reach back to the window of
            # the old hub's last view.
            daemon_floor: list[int] = []

            def match(view: dict) -> dict:
                matched = match_inputs(view, recorder.texts(),
                                       dict(watch.texts), embedded_url,
                                       daemon_source,
                                       daemon_floor[0] if daemon_floor
                                       else None)
                return check_hub_view(view, matched, fleet, embedded_url,
                                      daemon_source)

            def controller() -> None:
                nonlocal fleet
                try:
                    uuid = ""
                    deadline = time.monotonic() + 30
                    while not uuid:
                        require(time.monotonic() < deadline,
                                "hub: the daemon served no card")
                        texts = dict(watch.texts)
                        if texts:
                            uuid = next((
                                labels["uuid"] for name, labels, _ in
                                validate.parse_exposition(texts[max(texts)])
                                if name == schema.DEVICE_UP.name
                                and labels.get("chip") == "0"), "")
                        time.sleep(0.1)
                    fleet = SyntheticFleet(hub_url, watch, uuid)
                    # The start: every node has announced itself (its
                    # first FULL landed); the hub converges from there.
                    out["fleet_start_s"] = fleet.start()
                    start_view = hub_view(hub_port)
                    out["start_misses"] = []
                    out["start"] = wait_converged(
                        hub_port, start_view["refreshes"], "the start",
                        match, out["start_misses"])
                    out["start_refreshes"] = (out["start"][1]["refreshes"]
                                              - start_view["refreshes"])
                    t0 = time.monotonic()
                    out["start_apply"] = lane_apply(out["start"][0])
                    time.sleep(HUB_LIVE_S)
                    out["live"] = wait_converged(
                        hub_port, hub_view(hub_port)["refreshes"],
                        "the live window", match)
                    out["live_apply"] = lane_apply(out["live"][0])
                    out["native_active"] = out["live"][0]["one"](
                        schema.INGEST_NATIVE.name)
                    out["live_window"] = (t0, time.monotonic())
                    out["live_rates"] = rates_in(hub_port, HUB_RATE_REFRESHES)
                    out["cycles_live"] = hub_cycles_ms(
                        hub_port, out.setdefault("slowest_cycles", []))
                    out["rss"] = out["live"][0]["one"](
                        "process_resident_memory_bytes")
                    out["series"] = len(out["live"][0]["series"])
                    out["top"] = check_top(hub_port)
                    out["doctor"] = run_hub_doctor(hub_port)
                    # The history ring against what the hub published.
                    out["probe1"] = relay_probe_ms(hub_port)
                    out["ring"] = check_ring_identities(rec1, hub_port)
                    out["duty_1h"] = check_ring_duty(rec1, "1h", 10.0)
                    out["duty_24h"] = check_ring_duty(rec1, "24h", 300.0)
                    out["at"] = check_ring_at(rec1)
                    out["caching"] = check_query_caching(rec1)
                    out["stampede"] = query_stampede(rec1, hub_port)
                    # The warm restart: quiesce the synthetic pushes, so
                    # no frame lands after the final checkpoint.
                    fleet.paused.set()
                    time.sleep(1.0)
                    before = hub_view(hub_port)
                    out["before_restart"] = lane_apply(before)
                    out["fleet_before"] = fleet.frames()
                    # The live checks' window (the newest 60 ticks),
                    # held where it stood when the old hub stopped.
                    daemon_floor.append(max(dict(watch.texts)) - 59)
                    # The recorder stops while the hub still answers: a
                    # read sent as the hub closes its port can wait out
                    # its whole timeout.
                    rec1.stop()
                    out["hub_rc"], out["hub_stop_s"] = stop_with_stacks(
                        hub_proc, hub_log)
                    t_down = time.monotonic()
                    wall_down = time.time()
                    rec2 = recorders["restart"] = HubRecorder(
                        hub_port).start()
                    new_proc, new_port, new_log = start_hub(hub_args,
                                                            hub_port)
                    out["new_hub"] = (new_proc, new_log)
                    require(new_port == hub_port, "hub: restarted on "
                                                  f"{new_port}")
                    readyz = []
                    while True:
                        status, body, _ = fetch(f"{hub_url}/readyz")
                        readyz.append((status, body.decode().strip()))
                        if status == 200:
                            break
                        require(time.monotonic() - t_down < 60,
                                f"hub: /readyz never 200: {readyz[-3:]}")
                        time.sleep(0.02)
                    # Diagnostics: how long the hub was down, and the
                    # daemon's spooled backlog its drain still owes.
                    out["down_s"] = time.monotonic() - t_down
                    out["daemon_backlog"] = [egress_state(port)[0][
                        "spill"]["depth_frames"]]
                    # The snapshot that shows the state /readyz judged:
                    # the first refresh after it turned 200.
                    text, etag = next_hub_text(hub_port)
                    first = hub_view(hub_port, text)["refreshes"]
                    ready_view = hub_view(hub_port,
                                          next_hub_text(hub_port, etag)[0])
                    out["readyz"] = readyz
                    out["ready_view"] = {
                        "pending": ready_view["one"](
                            schema.HUB_WARM_RESTART_PENDING.name),
                        "sessions": ready_view["one"](
                            schema.HUB_WARM_RESTART_SESSIONS.name),
                        "refreshes": ready_view["refreshes"]}
                    # The synthetic nodes were paused through the
                    # restart: their sessions serve the checkpoint until
                    # their next frames, which continue the chains.
                    fleet.paused.clear()
                    out["restart_misses"] = []
                    out["restart"] = wait_converged(
                        hub_port, 0.0, "the warm restart", match,
                        out["restart_misses"])
                    out["recovered_refreshes"] = (
                        out["restart"][1]["refreshes"] - first)
                    out["daemon_backlog"].append(egress_state(port)[0][
                        "spill"]["depth_frames"])
                    out["daemon_tick_at_restart"] = (
                        daemon_floor[0], out["restart"][1]["daemon_tick"])
                    daemon_floor.clear()
                    time.sleep(HUB_LIVE2_S)
                    out["live2"] = wait_converged(
                        hub_port, hub_view(hub_port)["refreshes"],
                        "the second live window", match)
                    out["after_restart"] = lane_apply(out["live2"][0])
                    out["fleet_after"] = fleet.frames()
                    out["cycles_live2"] = hub_cycles_ms(
                        hub_port, out.setdefault("slowest_cycles", []))
                    out["restart_ring"] = check_restart_etags(rec1, rec2,
                                                              wall_down)
                    try:
                        procs_leg(rec2, new_proc, new_log)
                    except Exception:
                        procs_evidence()
                        raise
                except Exception as exc:  # noqa: BLE001 - re-raised
                    failure.append(exc)

            def procs_evidence() -> None:
                """What a failing third leg leaves to read: the hub's
                log, the daemon's egress status and log, and the hub's
                view of the daemon and of its children."""
                hub3 = out.get("procs_hub")
                if hub3 is not None:
                    print("\n".join(hub3[1][-40:]), file=sys.stderr)
                status, body, _ = fetch(f"http://127.0.0.1:{port}"
                                        f"/debug/egress")
                print(f"daemon /debug/egress {status}: {body[:3000]!r}",
                      file=sys.stderr)
                print("\n".join(log[-30:]), file=sys.stderr)
                try:
                    view = hub_view(hub_port)
                    picked = [(n, lab, v) for n, lab, v in view["series"]
                              if n.startswith(("kts_ingest_proc",
                                               "kts_delta_",
                                               "kts_hub_resync",
                                               "kts_ingest_shed"))
                              or (n == schema.HUB_TARGET_UP.name
                                  and lab["target"] == daemon_source)]
                    print(f"hub view: {picked}", file=sys.stderr)
                except Exception as exc:  # noqa: BLE001 - evidence only
                    print(f"hub view unreadable: {exc}", file=sys.stderr)
                sys.stderr.flush()

            def procs_leg(rec2: HubRecorder, old_proc, old_log) -> None:
                """The third hub: the same port and checkpoint with
                --ingest-procs HUB_PROCS; the fleet and the daemon push
                through the children; one child killed and restarted."""
                out["child"] = child_start()
                fleet.paused.set()
                time.sleep(1.0)
                out["fleet_before3"] = fleet.frames()
                out["daemon_failures0"] = daemon_push_failures(watch)
                rec2.stop()     # while the hub answers, as in the restart
                out["new_hub_rc"], out["new_hub_stop_s"] = \
                    stop_with_stacks(old_proc, old_log)
                # The reservation socket binds the port the second hub
                # has just left: how many of its connections wait there.
                out["time_wait"] = time_wait_on(hub_port)
                rec3 = recorders["procs"] = HubRecorder(hub_port).start()
                t0 = time.monotonic()
                proc3, port3, log3 = start_hub(
                    hub_args + ["--ingest-procs", str(HUB_PROCS)], hub_port)
                out["procs_hub"] = (proc3, log3)
                out["procs_hub_start_s"] = time.monotonic() - t0
                require(port3 == hub_port, f"hub: procs hub on {port3}")
                internal = re.search(r"exposition proxied to 127\.0\.0\.1:"
                                     r"(\d+)", "\n".join(log3))
                require(internal is not None, f"hub: {log3[-5:]}")
                internal = int(internal.group(1))
                kids = children_of(proc3.pid)
                require(len(kids) == HUB_PROCS,
                        f"hub: {len(kids)} acceptor children: {kids}")
                out["procs_kids"] = list(kids)
                deadline = time.monotonic() + 60
                while fetch(f"{hub_url}/readyz")[0] != 200:
                    require(time.monotonic() < deadline,
                            "hub: /readyz through the children never 200")
                    time.sleep(0.05)
                fleet.paused.clear()
                # The daemon's publisher probes a hub it lost on a
                # back-off and then drains its spill: the leg counts
                # refreshes from when it pushes live again (the second
                # leg holds the restart itself to its limit).
                while True:
                    status, body, _ = fetch(f"http://127.0.0.1:{port}"
                                            f"/debug/egress")
                    egress = json.loads(body) if status == 200 else {}
                    if (egress.get("senders", {}).get("delta", {}).get(
                            "consecutive_failures", 1) == 0
                            and not egress.get("spill", {}).get(
                                "depth_frames", 1)):
                        break
                    require(time.monotonic() - t0 < 60,
                            f"hub: the daemon never pushed live to the "
                            f"third hub: {egress}")
                    time.sleep(0.05)
                out["daemon_live_s"] = time.monotonic() - t0
                live_from = hub_view(hub_port)["refreshes"]
                converged = wait_converged(hub_port, live_from,
                                           "the ingest processes", match)
                out["procs_start_refreshes"] = (converged[1]["refreshes"]
                                                - live_from)
                start_apply = lane_apply(converged[0])
                time.sleep(HUB_LIVE3_S)
                live3 = wait_converged(
                    hub_port, hub_view(hub_port)["refreshes"],
                    "the ingest processes' live window", match)[0]
                out["procs_apply"] = (start_apply, lane_apply(live3))
                out["procs_frames"] = proc_counts(
                    live3, schema.INGEST_PROC_FRAMES.name)
                require(len(out["procs_frames"]) == HUB_PROCS
                        and all(v > 0 for v in out["procs_frames"].values()),
                        f"hub: frames per child {out['procs_frames']}")
                out["procs_rss"] = (
                    (live3["one"]("process_resident_memory_bytes") or 0)
                    / MIB, {pid: rss_mib(pid) for pid in kids})
                out["procs_series"] = len(live3["series"])
                out["probe3"] = relay_probe_ms(hub_port)
                out["probe3_direct"] = relay_probe_ms(internal)
                status, body, _ = rec3.query(
                    f"family={schema.HUB_CHIPS.name}&window=1h")
                require(status == 200 and json.loads(body)["series"],
                        f"hub: /query through the children: {status}")
                out["procs_query"] = status
                require(fetch(f"{hub_url}/readyz")[0] == 200,
                        "hub: /readyz through the children")
                # One child killed: the pool starts another, and every
                # publisher pushes again.
                pushed = {n: p.pushes_total
                          for n, p in fleet.publishers.items()}
                before_kill = fleet.frames()
                kill_refresh = hub_view(hub_port)["refreshes"]
                victim = kids[0]
                t_kill = time.monotonic()
                os.kill(victim, signal.SIGKILL)
                etag = ""
                while True:
                    require(time.monotonic() - t_kill < HUB_RESPAWN_S,
                            f"hub: child {victim} not replaced in "
                            f"{HUB_RESPAWN_S} s: {children_of(proc3.pid)}")
                    now_kids = children_of(proc3.pid)
                    text, etag = next_hub_text(hub_port, etag)
                    ups = proc_counts(hub_view(hub_port, text),
                                      schema.INGEST_PROC_UP.name)
                    if (len(now_kids) == HUB_PROCS and victim not in now_kids
                            and len(ups) == HUB_PROCS
                            and all(v == 1 for v in ups.values())):
                        break
                out["respawn_s"] = time.monotonic() - t_kill
                out["procs_kids_after"] = now_kids
                while not all(p.pushes_total > pushed[n]
                              for n, p in fleet.publishers.items()):
                    require(time.monotonic() - t_kill < HUB_RESPAWN_S,
                            "hub: publishers not pushing again after the "
                            "kill: " + str(sorted(
                                n for n, p in fleet.publishers.items()
                                if p.pushes_total <= pushed[n])[:5]))
                    time.sleep(0.05)
                out["reconnect_s"] = time.monotonic() - t_kill
                out["after_kill"] = wait_converged(
                    hub_port, hub_view(hub_port)["refreshes"],
                    "after a child was killed",
                    match)[1]["refreshes"] - kill_refresh
                out["kill_frames"] = (before_kill, fleet.frames())
                out["cycles_procs"] = hub_cycles_ms(
                    hub_port, out.setdefault("slowest_procs_cycles", []))

            def rates_in(hub_port_: int, refreshes: int) -> list:
                """slice_worker_steps_per_second for node-00 at each of
                the next ``refreshes`` refreshes, beside the burn's own
                steps/s between the moments this script saw the refresh
                before it and that refresh published. Polls the raw text
                with two regexes: parsing the whole exposition here
                would take the GIL from the burn's launches."""
                count_re = re.compile(
                    r"^hub_refresh_duration_seconds_count (\S+)$", re.M)
                rate_re = re.compile(
                    r'^slice_worker_steps_per_second\{slice="'
                    + HUB_SLICE + r'",worker="node-00"\} (\S+)$', re.M)
                # The generation published now is not timed: only a
                # publish seen as it happens starts a window.
                text, etag = next_hub_text(hub_port_)
                last = float(count_re.search(text).group(1))
                samples, t_last = [], None
                while len(samples) < refreshes:
                    text, etag = next_hub_text(hub_port_, etag)
                    t = time.monotonic()
                    count = float(count_re.search(text).group(1))
                    if count != last:
                        rate = rate_re.search(text)
                        if (t_last is not None and last == count - 1
                                and rate is not None):
                            samples.append((t_last, t,
                                            float(rate.group(1))))
                        last, t_last = count, t
                span = samples[-1][1] - samples[0][0]
                return {
                    "per_refresh": [(hub, steps_between(t0, t1)
                                     / (t1 - t0))
                                    for t0, t1, hub in samples],
                    # Over the whole span, each refresh's rate weighted
                    # by its window: the exporter's publish lag and this
                    # poll's jitter cancel but at the two ends.
                    "hub": sum(hub * (t1 - t0) for t0, t1, hub in samples)
                    / span,
                    "burn": steps_between(samples[0][0], samples[-1][1])
                    / span}

            def steps_between(t0: float, t1: float) -> float:
                log_ = list(steps_log)
                times = [t for t, _ in log_]

                def at(t: float) -> float:
                    i = bisect.bisect_right(times, t)
                    return log_[max(0, i - 1)][1]

                return at(t1) - at(t0)

            hook = StepCounter()

            def tee(n: int, *, seconds: float, flops: float) -> None:
                hook(n, seconds=seconds, flops=flops)
                exporter.record_step(n, seconds=seconds, flops=flops)
                steps_log.append((time.monotonic(), hook.steps))

            thread = threading.Thread(target=controller, daemon=True)
            tiled_burn.launches = 0
            steps_log.append((time.monotonic(), 0))
            thread.start()
            steps = chunks = 0
            while thread.is_alive():
                chunks += 1
                steps += run_burn(seconds=HUB_BURN_CHUNK_S, size=MAIN_SIZE,
                                  report_every=1e9, kernel="cuda",
                                  device="cuda:0", step_hook=tee)
                require(chunks * HUB_BURN_CHUNK_S < 300,
                        "the hub phase did not end in 300 s")
            launches = tiled_burn.launches
            thread.join(timeout=30)
            require(not failure, f"the hub phase failed: {failure}")
            tick_window = window_p50(watch.traced, min(watch.traced),
                                     max(watch.traced))
        # The conservation law once nothing pushes: the fleet's final
        # flush lands, then the daemon stops (its own final push too).
        fleet.stop()
        fleet_stopped = True
        out["fleet_after_quiet"] = fleet.frames()
        fleet_failures = (fleet.frames()["failures"]
                          - out["fleet_before3"]["failures"])
        daemon_failures = (daemon_push_failures(watch)
                           - out["daemon_failures0"])
        out["daemon_rc"], out["daemon_stop_s"] = stop_with_stacks(
            daemon_proc, log)
        out["quiet"] = quiet_conservation(
            hub_port, fleet_failures + daemon_failures)
        out["quiet"]["publisher_failures"] = fleet_failures + daemon_failures
        recorders.pop("procs").stop()
    finally:
        # Pushers first, into a live hub (their final flush lands), then
        # the hubs, then the burn's exporter.
        for recorder in recorders.values():
            recorder._stop.set()
        if fleet is not None and not fleet_stopped:
            fleet.stop()
        if daemon_proc is not None and "daemon_rc" not in out:
            out["daemon_rc"], out["daemon_stop_s"] = stop_with_stacks(
                daemon_proc, log)
        new_hub = out.get("new_hub")
        if new_hub is not None and "new_hub_rc" not in out:
            out["new_hub_rc"], out["new_hub_stop_s"] = stop_with_stacks(
                *new_hub)
        procs_hub = out.get("procs_hub")
        if procs_hub is not None:
            out["procs_hub_rc"], out["procs_hub_stop_s"] = \
                stop_with_stacks(*procs_hub)
            # A child its hub left running is re-parented to this
            # process (adopt_orphans).
            mine = children_of(os.getpid())
            out["procs_kids_left"] = [
                pid for pid in out.get("procs_kids", [])
                + out.get("procs_kids_after", []) if pid in mine]
        if hub_proc is not None and hub_proc.poll() is None:
            stop_with_stacks(hub_proc, hub_log)
        exporter.stop()
        sys.setswitchinterval(saved_switch)
        gc.unfreeze()
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    require(launches == steps + chunks,
            f"{launches} launches for {steps} steps in {chunks} chunks")
    require(out.get("hub_rc") == 0, f"the hub exited {out.get('hub_rc')} "
                                    f"on SIGTERM: {hub_log[-20:]}")
    require(out.get("new_hub_rc") == 0,
            f"the restarted hub exited {out.get('new_hub_rc')}: "
            f"{out['new_hub'][1][-20:]}")
    require(out.get("daemon_rc") == 0,
            f"the hub phase's daemon exited {out.get('daemon_rc')}")
    # Warm restart, by the reference's contract.
    fulls_after = out["after_restart"][1]
    sessions = HUB_NODES
    continued = sessions - fulls_after
    ready_view = out["ready_view"]
    saw_gate = [body for status, body in out["readyz"] if status == 503]
    # The hub runs its host fast paths by default (kts_ingest_native).
    require(out.get("native_active") == 1.0,
            f"the hub's kts_ingest_native is {out.get('native_active')}: "
            f"its native slot store did not run")
    rc_doc, rows = out["doctor"]
    skew = rows["skew"]["data"]["skew"] if "data" in rows["skew"] else {}
    census = (skew.get("ingest") or {}).get("fleet_versions", {})
    downgraded = (skew.get("ingest") or {}).get("downgraded_sessions", [])
    card_rows = rows["cardinality"].get("data", {}).get("cardinality", {})
    live_rates = out["live_rates"]
    hub_rate, burn_rate = live_rates["hub"], live_rates["burn"]
    start_apply, live_apply = out["start_apply"], out["live_apply"]
    per_delta_s = ((live_apply[0] - start_apply[0])
                   / max(1.0, live_apply[2] - start_apply[2]))
    per_full_s = ((start_apply[0] - per_delta_s * start_apply[2])
                  / max(1.0, start_apply[1]))
    cycles = out["cycles_live"] + out["cycles_live2"]
    row = {
        "card": card_line, "interval_s": HUB_INTERVAL_S,
        "nodes": HUB_NODES, "targets": HUB_NODES + 1,
        "native_active": out["native_active"] == 1.0,
        "cards": float(out["live"][1]["rollups"]["slice_chips"]),
        "fleet_start_s": out["fleet_start_s"],
        "convergence_refreshes": {
            "start": out["start_refreshes"],
            "restart": out["restart"][1]["refreshes"]},
        "start_misses": out["start_misses"],
        "same_numbers": {"daemon_tick": out["live"][1]["daemon_tick"],
                         "duplicates": out["live"][1]["duplicates"],
                         "duplicate_families":
                         out["live"][1]["duplicate_families"]},
        "rollups": out["live"][1]["rollups"],
        "steps_per_s": {"hub": hub_rate, "burn": burn_rate,
                        "refreshes": HUB_RATE_REFRESHES,
                        "per_refresh": live_rates["per_refresh"],
                        "main_path_phase": main_cuda_steps_per_s},
        "straggler_ratio": out["live"][1]["straggler_ratio"],
        "warm_restart": {
            "sessions": sessions, "fulls_after": fulls_after,
            "continued_share": continued / sessions,
            "readyz_503s": len(saw_gate), "readyz_503_reasons":
            sorted(set(saw_gate)), "ready_view": ready_view,
            "recovered_refreshes": out["recovered_refreshes"],
            "refreshes_missed": out["restart_misses"],
            "down_s": out["down_s"],
            "daemon_backlog_at_ready_and_converged": out["daemon_backlog"],
            "daemon_tick_old_hub_and_converged":
                out["daemon_tick_at_restart"],
            "fleet_frames_before": out["fleet_before"],
            "fleet_frames_after": out["fleet_after"]},
        "top": out["top"],
        "doctor": {name: [rows[name]["status"], rows[name]["detail"]]
                   for name in ("cardinality", "skew", "stores")},
        "doctor_rc": rc_doc,
        "census": census,
        "refresh_ms": {"p50": statistics.median(cycles), "max": max(cycles),
                       "cycles": len(cycles),
                       "slowest": out["slowest_cycles"]},
        "ingest_apply_ms": {"per_full": per_full_s * 1e3,
                            "per_delta": per_delta_s * 1e3,
                            "fulls": start_apply[1],
                            "deltas_live": live_apply[2] - start_apply[2]},
        "hub_rss_mib": (out["rss"] or 0) / MIB,
        "hub_series": out["series"],
        "daemon_tick_ms": tick_window["tick"],
        "c5_pipelined_tick_ms": c5_tick_ms,
        "scrapes_validated": watch.scrapes,
        "burn": {"steps": steps, "chunks": chunks, "launches": launches}}
    emit("hub", row)
    require(abs(hub_rate - burn_rate) <= HUB_RATE_TOL * burn_rate,
            f"hub: node-00 steps/s {hub_rate} vs the burn's {burn_rate}")
    require(continued / sessions >= HUB_WARM_MIN,
            f"hub: {fulls_after} of {sessions} sessions resynced with a "
            f"FULL after the restart")
    require(ready_view["pending"] == 0
            and ready_view["sessions"] >= continued,
            f"hub: /readyz turned 200 before the replay: {ready_view}")
    require(out["recovered_refreshes"] <= 1,
            f"hub: rollup recovered {out['recovered_refreshes']} refreshes "
            f"after /readyz turned 200")
    require(rows["cardinality"]["status"] == "ok"
            and len(card_rows.get("top_sources", [])) >= 10,
            f"hub: doctor --cardinality {row['doctor']['cardinality']}")
    require(rows["skew"]["status"] == "ok"
            and sum(census.values()) == HUB_NODES and not downgraded,
            f"hub: doctor --skew {row['doctor']['skew']} census {census}")
    stores = rows["stores"].get("data", {}).get("stores", {})
    require(rows["stores"]["status"] == "ok"
            and (stores.get("stores") or {}).get("ingest", {}).get("state")
            == "healthy",
            f"hub: doctor --stores {row['doctor']['stores']} "
            f"{stores.get('stores')}")
    require(tick_window["tick"]["p50_ms"] < TICK_BUDGET_MS,
            f"hub: daemon tick p50 {tick_window['tick']}")
    require(max(cycles) < HUB_INTERVAL_S * 1e3,
            f"hub: a refresh took {max(cycles)} ms of a "
            f"{HUB_INTERVAL_S} s interval: {out['slowest_cycles']}")
    emit("hub_history", {
        "card": card_line, "identities": out["ring"],
        "series_bytes": SERIES_BYTES, "duty_1h": out["duty_1h"],
        "duty_24h": out["duty_24h"], "at": out["at"],
        "caching": out["caching"], "stampede": out["stampede"],
        "restart": out["restart_ring"], "cost": cost})
    # The third leg: ingest through the acceptor processes.
    procs_cycles = out["cycles_procs"]
    (s_seconds, s_full, s_delta), (l_seconds, _, l_delta) = \
        out["procs_apply"]
    procs_per_delta = (l_seconds - s_seconds) / max(1.0, l_delta - s_delta)
    fulls3 = s_full
    continued3 = HUB_NODES - fulls3
    hub_rss3, kids_rss = out["procs_rss"]
    quiet = out["quiet"]
    before3 = out["fleet_before3"]
    kill_before, kill_after = out["kill_frames"]
    fleet_resyncs3 = out["fleet_after_quiet"]["resyncs"] - before3["resyncs"]
    emit("hub_procs", {
        "card": card_line, "procs": HUB_PROCS,
        "hub_start_s": out["procs_hub_start_s"],
        "hub_start_s_single_process": out["hub_start_s"],
        "time_wait_at_bind": out["time_wait"],
        "child": out["child"],
        "daemon_live_s": out["daemon_live_s"],
        "convergence_refreshes": out["procs_start_refreshes"],
        "frames_per_child": out["procs_frames"],
        "continued_share": continued3 / HUB_NODES,
        "ingest_apply_ms": {
            "per_delta": procs_per_delta * 1e3,
            "per_delta_single_process": per_delta_s * 1e3,
            "per_full_single_process": per_full_s * 1e3,
            "fulls": fulls3},
        "relay_round_trip_ms": {
            "through_children": out["probe3"],
            "direct_same_hub": out["probe3_direct"],
            "single_process_hub": out["probe1"]},
        "refresh_ms": {"p50": statistics.median(procs_cycles),
                       "max": max(procs_cycles),
                       "single_process_p50": statistics.median(cycles),
                       "single_process_max": max(cycles),
                       "slowest": out["slowest_procs_cycles"]},
        "rss_mib": {"hub": hub_rss3, "children": kids_rss,
                    "total": hub_rss3 + sum(kids_rss.values()),
                    "single_process_hub": (out["rss"] or 0) / MIB},
        "series": out["procs_series"],
        "kill": {"respawn_s": out["respawn_s"],
                 "reconnect_s": out["reconnect_s"],
                 "refreshes_to_converge": out["after_kill"],
                 "fleet_failures": kill_after["failures"]
                 - kill_before["failures"],
                 "fleet_resyncs": kill_after["resyncs"]
                 - kill_before["resyncs"],
                 "fleet_fulls": kill_after["full"] - kill_before["full"]},
        "conservation": quiet, "fleet_resyncs": fleet_resyncs3,
        "probes": 2 * HUB_PROBES, "query_status": out["procs_query"],
        "hub_rc": out.get("procs_hub_rc"),
        "children_left": out.get("procs_kids_left")})
    require(out.get("procs_hub_rc") == 0,
            f"the procs hub exited {out.get('procs_hub_rc')} on SIGTERM")
    require(not out.get("procs_kids_left"),
            f"hub: acceptor children outlived their hub: "
            f"{out.get('procs_kids_left')}")
    require(continued3 / HUB_NODES >= HUB_WARM_MIN,
            f"hub: {fulls3} of {HUB_NODES} sessions resynced with a FULL "
            f"after the restart into --ingest-procs")
    # Every FULL the fleet re-sent on a 409 is one the hub counted; the
    # hub's count also holds the relay probes' 409s.
    require(quiet["resyncs"] >= 2 * HUB_PROBES + fleet_resyncs3,
            f"hub: {quiet['resyncs']} resyncs counted, the fleet made "
            f"{fleet_resyncs3} and the probes {2 * HUB_PROBES}")
    require(max(procs_cycles) < HUB_INTERVAL_S * 1e3,
            f"hub: a refresh took {max(procs_cycles)} ms with "
            f"--ingest-procs: {out['slowest_procs_cycles']}")
    return launches


# -- the fleet lens on the hub -----------------------------------------------------

FLEET_INTERVAL_S = 1.0
FLEET_DAEMON_INTERVAL_S = 0.1
FLEET_EMBEDDED_INTERVAL_S = 0.05
FLEET_POD_UID = "5a6b7c8d-9e0f-4a1b-8c2d-3e4f5a6b7c8d"
FLEET_NAMESPACE = "fleet"
FLEET_STRAGGLER = 7
FLEET_SILENT = 9
# Refreshes past each of the reference's thresholds a window allows: the
# card's utilization counter and the daemon's push reach the hub up to a
# refresh after the burn changes.
FLEET_MARGIN = 2
FLEET_PAUSE_MIN_S = 22.0    # two whole 10 s ring buckets inside the pause
FLEET_STRAGGLE_REFRESHES = 4
FLEET_STEADY_REFRESHES = 12
FLEET_RATIO_TOL = 0.05
FLEET_SPJ_TOL = 0.15
FLEET_PUSH_DELAY_S = 0.2    # a synthetic round, after the refresh it follows
FLEET_PUSH_LANES = 4        # the synthetic nodes' pushes, in parallel blocks
FLEET_PUSH_SLOT_S = 0.025   # each node's start in its block, apart
FLEET_MAX_S = 400.0
FLEET_HELD_BYTES = 4 << 30
FLEET_SMI_GAP_S = 0.25
FLEET_DOCTOR_BACKEND = "nvml"
# The lens holds card 0's duty against a flat 100% baseline, so the
# burn's thread must queue the next batch before the card runs dry, while
# this process's other threads (the daemon's watcher, the burn's
# exporter, the readers) take the interpreter in turns. So the burn
# queues 128 to 256 steps (27-54 ms of work at 4096^3), not 32 to 64; the
# phase takes the interpreter's lock in 1 ms turns, not 5; and it freezes
# what the earlier phases left on the heap, so no full collection walks
# it mid-window.
FLEET_BATCH = 128
FLEET_SWITCH_S = 0.001

# The synthetic nodes and the recorder of the hub's generations, in
# processes of their own (their threads then take no interpreter time
# from the burn or from the burn's exporter, whose latency the lens
# scores). Every generation the hub publishes: a summary line on stdout
# and the text in a file for the conformance checker. After each
# generation, one round: every node publishes its frozen card values with
# its step counter advanced, and pushes. The nodes are split into
# FLEET_PUSH_LANES blocks, each a process of its own (_FLEET_LANE) that
# starts its block's nodes in node order, each FLEET_PUSH_SLOT_S after
# the one before or once it is done if that is later: each node's frames
# arrive a steady interval apart, and a host that answers a push slowly
# delays only the nodes after it in its block, by what its slots cannot
# absorb. The collector runs right after each round, never inside one:
# in a real fleet one node's collection cannot delay another node's frame.
# Commands on stdin: "template <path> <steps per refresh>", "straggle
# <n>", "unstraggle", "silence <n>", "unsilence", "stop".
_FLEET_SYNTH = r"""
import gc, json, os, re, subprocess, sys, threading, time
import urllib.error, urllib.request
from kube_gpu_stats_tpu_torch.testing.push_grid import PushGrid

hub_url, out_dir = sys.argv[1], sys.argv[2]
nodes, cards = int(sys.argv[3]), int(sys.argv[4])
push_delay, namespace = float(sys.argv[5]), sys.argv[6]
interval, lanes = float(sys.argv[7]), int(sys.argv[8])
slot, lane_source = sys.argv[9], sys.argv[10]
ETAG = re.compile(r'^"(\w+)-(\d+)-m\d\d"$')
COUNT = re.compile(r"^hub_refresh_duration_seconds_count (\S+)$", re.M)
RATIO = re.compile(r'^slice_straggler_ratio\{slice="[^"]*"\} (\S+)$', re.M)
UP = re.compile(r'^slice_target_up\{target="([^"]+)"\} (\S+)$', re.M)
FLEET = re.compile(r"^(kts_fleet_\w+(?:\{[^}]*\})?) (\S+)$", re.M)
CHIPS = re.compile(r'^slice_chips\{slice="[^"]*"\} (\S+)$', re.M)
DOWN_CHIPS = re.compile(r'^accelerator_up\{[^}]*\} 0$', re.M)
RSS = re.compile(r"^process_resident_memory_bytes (\S+)$", re.M)
state = {"straggle": None, "silence": None, "rounds": 0, "gen": -1,
         "detected": 0.0, "stop": False, "pusher": None}
lock = threading.Lock()
detected = threading.Condition(lock)
workers = []


def out(payload):
    sys.stdout.write(json.dumps(payload) + "\n")
    sys.stdout.flush()


def build(template_path, per_refresh):
    size = -(-nodes // lanes)
    for first in range(1, nodes + 1, size):
        workers.append(subprocess.Popen(
            [sys.executable, "-c", lane_source, hub_url, template_path,
             str(first), str(min(nodes, first + size - 1)), str(cards),
             namespace, slot], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True))
    state["per_refresh"] = per_refresh


def push_round():
    with lock:
        straggle, silence = state["straggle"], state["silence"]
        per_refresh = state["per_refresh"]
    t0 = time.monotonic()
    for worker in workers:
        worker.stdin.write(f"push {straggle or 0} {silence or 0} "
                           f"{per_refresh!r}\n")
        worker.stdin.flush()
    results = [json.loads(worker.stdout.readline()) for worker in workers]
    state["rounds"] += 1
    return (time.monotonic() - t0, sum(r["failures"] for r in results),
            max(tuple(r["slowest"]) for r in results))


def pusher():
    # One round per hub generation, push_delay after it was first seen,
    # on a grid that follows the hub's period without jumping (PushGrid).
    followed, grid = -1, PushGrid(interval, push_delay)
    while True:
        with detected:
            while state["gen"] <= followed and not state["stop"]:
                detected.wait(1.0)
            if state["stop"]:
                return
            followed, seen = state["gen"], state["detected"]
        due = grid.next_due(seen)
        time.sleep(max(0.0, due - time.monotonic()))
        took, failures, slowest = push_round()
        out({"round": state["rounds"], "gen": followed, "push_s": took,
             "late_s": time.monotonic() - took - due, "failures": failures,
             "slowest_push_s": slowest[0], "slowest_node": slowest[1],
             "grid_error_s": grid.error, "grid_anchors": grid.anchors})
        gc.collect()


def commands():
    for line in sys.stdin:
        words = line.split()
        if not words:
            continue
        if words[0] == "template":
            build(words[1], float(words[2]))
            gc.collect()
            gc.freeze()
            push_round()
            out({"ready": nodes})
            state["pusher"] = threading.Thread(target=pusher, daemon=True)
            state["pusher"].start()
            continue
        with lock:
            if words[0] == "straggle":
                state["straggle"] = int(words[1])
            elif words[0] == "unstraggle":
                state["straggle"] = None
            elif words[0] == "silence":
                state["silence"] = int(words[1])
            elif words[0] == "unsilence":
                state["silence"] = None
        if words[0] == "stop":
            break
        out({"ack": words, "round": state["rounds"]})
    with detected:
        state["stop"] = True
        detected.notify_all()


gc.disable()
reader = threading.Thread(target=commands, daemon=True)
reader.start()
etag = ""
while reader.is_alive():
    request = urllib.request.Request(
        hub_url + "/metrics", headers={"If-None-Match": etag} if etag else {})
    try:
        with urllib.request.urlopen(request, timeout=10) as resp:
            text = resp.read().decode()
            new = resp.headers.get("ETag", "")
    except urllib.error.HTTPError:
        new = etag                    # 304: no new generation
    except OSError:
        new = etag                    # the hub not up yet
    if new and new != etag:
        seen, mono = time.time(), time.monotonic()
        etag = new
        match = ETAG.match(new)
        generation = int(match.group(2)) if match else -1
        with detected:
            state["gen"], state["detected"] = generation, mono
            detected.notify_all()
        path = os.path.join(out_dir, f"gen-{generation:06d}.prom")
        with open(path, "w") as handle:
            handle.write(text)
        count = COUNT.search(text)
        ratio = RATIO.search(text)
        chips = CHIPS.search(text)
        rss = RSS.search(text)
        out({"gen": generation, "path": path, "seen": seen, "mono": mono,
             "rss": float(rss.group(1)) if rss else None,
             "count": float(count.group(1)) if count else 0.0,
             "ratio": float(ratio.group(1)) if ratio else None,
             "chips": float(chips.group(1)) if chips else 0.0,
             "down_chips": len(DOWN_CHIPS.findall(text)),
             "up": {t: float(v) for t, v in UP.findall(text)},
             "fleet": dict(FLEET.findall(text))})
    time.sleep(0.02)
if state["pusher"] is not None:
    state["pusher"].join(timeout=30)  # its round done, the lanes idle
for worker in workers:
    worker.stdin.close()
    worker.wait(timeout=30)
out({"stopped": state["rounds"]})
"""

# One block of the synthetic nodes (first..last), pushing on command,
# node k of the block no sooner than k slots after the command came:
# "push <straggler> <silent> <steps per refresh>" (0: no such node)
# answers {"failures", "slowest": [seconds, node]}; stdin's end stops it.
_FLEET_LANE = r"""
import gc, json, sys, time
from kube_gpu_stats_tpu_torch import delta, schema
from kube_gpu_stats_tpu_torch.registry import Registry, Series, SnapshotBuilder

hub_url, template_path = sys.argv[1], sys.argv[2]
first, last, cards = int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
namespace, slot = sys.argv[6], float(sys.argv[7])
specs = {m.name: m for m in schema.PER_DEVICE_METRICS
         if m.type is not schema.MetricType.HISTOGRAM}
with open(template_path) as handle:
    mine = json.load(handle)
up = next(labels for name, labels, _ in mine if name == "accelerator_up")
mine = [row for row in mine if row[0] in specs
        and row[0] != "accelerator_workload_steps_total"]
fleet = {}
for n in range(first, last + 1):
    rows = []
    for card in range(cards):
        swap = {"uuid": f"GPU-synthetic-{n:02d}-{card}",
                "minor": str(card), "chip": str(card),
                "device_path": f"/dev/nvidia{card}",
                "worker": f"node-{n:02d}", "pod": f"train-{n:02d}",
                "namespace": namespace}
        for name, labels, value in mine:
            rows.append((specs[name], tuple(
                (k, swap.get(k, v)) for k, v in labels.items()), value))
        rows.append((specs["accelerator_workload_steps_total"], tuple(
            (k, swap.get(k, v)) for k, v in up.items()), None))
    registry = Registry()
    fleet[n] = {"rows": rows, "registry": registry, "steps": 0.0,
                "publisher": delta.DeltaPublisher(
                    registry, hub_url,
                    source=f"http://node-{n:02d}.synthetic:9400/metrics",
                    timeout=10.0)}
gc.collect()
gc.freeze()
gc.disable()
for line in sys.stdin:
    start = time.monotonic()
    words = line.split()
    straggle, silence = int(words[1]), int(words[2])
    per_refresh = float(words[3])
    failures = 0
    slowest = (0.0, 0)
    for k, (n, node) in enumerate(fleet.items()):
        if n == silence:
            continue
        time.sleep(max(0.0, start + k * slot - time.monotonic()))
        t_node = time.monotonic()
        node["steps"] += per_refresh / 2 if n == straggle else per_refresh
        builder = SnapshotBuilder()
        builder.extend_series(
            Series(spec, labels, node["steps"] if value is None else value)
            for spec, labels, value in node["rows"])
        node["registry"].publish(builder.build())
        before = node["publisher"].failures_total
        node["publisher"].push_once()
        failures += node["publisher"].failures_total - before
        slowest = max(slowest, (time.monotonic() - t_node, n))
    sys.stdout.write(json.dumps({"failures": failures,
                                 "slowest": slowest}) + "\n")
    sys.stdout.flush()
    gc.collect()
"""

# Each generation file the fleet process writes, held by validate.check against
# the one before it, then deleted; one result line per file.
_FLEET_CONFORM = r"""
import json, os, sys
from kube_gpu_stats_tpu_torch import validate
previous = None
for line in sys.stdin:
    path = line.strip()
    with open(path) as handle:
        text = handle.read()
    problems = validate.check(text, previous)
    os.unlink(path)
    previous = text
    sys.stdout.write(json.dumps({"path": path, "problems": problems[:5]})
                     + "\n")
    sys.stdout.flush()
"""


class FleetSynth:
    """The fleet process, its summaries as they arrive, and the
    conformance checker the summaries feed."""

    def __init__(self, hub_url: str, workdir: str) -> None:
        gens = os.path.join(workdir, "generations")
        os.makedirs(gens)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _FLEET_SYNTH, hub_url, gens,
             str(HUB_NODES - 1), str(HUB_CARDS), str(FLEET_PUSH_DELAY_S),
             FLEET_NAMESPACE, str(FLEET_INTERVAL_S), str(FLEET_PUSH_LANES),
             str(FLEET_PUSH_SLOT_S), _FLEET_LANE],
            cwd=ROOT, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.conform = subprocess.Popen(
            [sys.executable, "-c", _FLEET_CONFORM], cwd=ROOT,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.gens: dict[float, dict] = {}
        self.rounds: list[dict] = []
        self.ready = threading.Event()
        self.stopped = threading.Event()
        self.errors: list[str] = []
        self.conform_lines: list[str] = []
        self.new = threading.Condition()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        threading.Thread(target=self._errors, daemon=True).start()
        threading.Thread(target=self._conformed, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            payload = json.loads(line)
            if "path" in payload:
                self.conform.stdin.write(payload["path"] + "\n")
                self.conform.stdin.flush()
                with self.new:
                    self.gens.setdefault(payload["count"], payload)
                    self.new.notify_all()
            elif "round" in payload and "push_s" in payload:
                self.rounds.append(payload)
            elif "ready" in payload:
                self.ready.set()
            elif "stopped" in payload:
                self.stopped.set()
        self.stopped.set()
        with self.new:
            self.new.notify_all()

    def _errors(self) -> None:
        for line in self.proc.stderr:
            self.errors.append(line.rstrip("\n"))

    def _conformed(self) -> None:
        for line in self.conform.stdout:
            self.conform_lines.append(line)

    def command(self, text: str) -> None:
        self.proc.stdin.write(text + "\n")
        self.proc.stdin.flush()

    def newest(self) -> float:
        return max(self.gens, default=0.0)

    def wait(self, predicate, after: float, limit: int, what: str
             ) -> dict:
        """The first generation of the ``limit`` refreshes after refresh
        ``after`` that satisfies ``predicate``; fails when none does."""
        seen = after
        with self.new:
            while True:
                for count in sorted(c for c in self.gens if c > seen):
                    require(count - after <= limit,
                            f"fleet: {what} not seen within {limit} "
                            f"refreshes of refresh {after:g}")
                    gen = self.gens[count]
                    if predicate(gen):
                        return gen
                    seen = count
                require(not self.stopped.is_set() and self.proc.poll()
                        is None and self._reader.is_alive(),
                        f"fleet: the fleet process ended: {self.errors[-20:]}")
                self.new.wait(timeout=5.0)

    def refreshes(self, n: int) -> dict:
        """The generation ``n`` refreshes after the newest one now."""
        start = self.newest()
        return self.wait(lambda g: g["count"] >= start + n, start, n,
                         f"{n} refreshes")

    def gaps(self, first: float, last: float) -> list[float]:
        """Refresh counts in [first, last] this recorder did not see."""
        return [c for c in range(int(first), int(last) + 1)
                if float(c) not in self.gens]

    def close(self) -> dict:
        if self.proc.poll() is None:
            try:
                self.command("stop")
            except OSError:
                pass
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self.stopped.wait(timeout=10)
        self.conform.stdin.close()
        self.conform.wait(timeout=120)
        time.sleep(0.2)
        problems = [json.loads(line) for line in self.conform_lines]
        return {"checked": len(problems),
                "failed": [p for p in problems if p["problems"]][:3]}


def fleet_diagnostics(hub_url: str, synth: "FleetSynth") -> None:
    """What a failing window leaves to read: the hub's fleet journal,
    each flagged target's signals, and the fleet process's rounds; one
    ``fleet_diag`` line, the whole of it under chiprun_out/."""
    try:
        status, body, _ = fetch(f"{hub_url}/debug/events")
        events = [(e["kind"], e["tick_seq"], e["attrs"])
                  for e in json.loads(body)["events"]
                  if e["kind"].startswith("fleet_")]
        status, body, _ = fetch(f"{hub_url}/debug/fleet")
        rollup = json.loads(body)
        flagged = {a.get("target") for _k, _s, a in events if a.get("target")}
        signals = {t: rollup["targets"].get(t, {}).get("signals")
                   for t in sorted(t for t in flagged if t)}
        diag = {"events": events, "signals": signals,
                "rounds": synth.rounds[-60:],
                "counts": [(g["count"], g["mono"]) for g in
                           [synth.gens[c] for c in sorted(synth.gens)]]}
        os.makedirs(ROOT / "chiprun_out", exist_ok=True)
        with open(ROOT / "chiprun_out" / "fleet_diag.json", "w") as handle:
            json.dump(diag, handle)
        emit("fleet_diag", {"events": events[-40:],
                            "rounds": synth.rounds[-15:]})
    except Exception as exc:  # noqa: BLE001 - evidence only
        print(f"fleet diagnostics unreadable: {exc}", file=sys.stderr)


def fleet_value(gen: dict, name: str, **labels) -> float | None:
    """One kts_fleet_* value of a generation summary by its labels."""
    for key, value in gen["fleet"].items():
        head, _, raw = key.partition("{")
        if head != name:
            continue
        got = dict(validate._tokenize_labels(raw[:-1])) if raw else {}
        if all(got.get(k) == v for k, v in labels.items()):
            return float(value)
    return None


class CardPods:
    """The burn's exporter's pod labels: the kubelet checkpoint's pod for
    each CUDA card, by the card's UUID — the join the daemon's checkpoint
    attribution makes for the same card, so both exporters' rows of the
    card carry the burn's pod."""

    def __init__(self, path: str) -> None:
        from kube_gpu_stats_tpu_torch.attribution.checkpoint import (
            CheckpointSource)

        self.table = CheckpointSource(path).fetch()

    def lookup(self, device) -> dict:
        if not device.device_path.startswith("/dev/nvidia"):
            return {}
        return dict(self.table.get(
            embedded.cuda_uuid(torch.device("cuda", device.index)), {}))


def fleet_exporter(checkpoint: str):
    """The burn's embedded exporter, its poll loop given the card's pod."""
    from kube_gpu_stats_tpu_torch.poll import PollLoop
    from kube_gpu_stats_tpu_torch.topology import topology_labels

    exporter = embedded.EmbeddedExporter(
        port=0, interval=FLEET_EMBEDDED_INTERVAL_S)
    exporter.poll.stop()
    exporter.poll = PollLoop(
        exporter.collector, exporter.registry,
        interval=FLEET_EMBEDDED_INTERVAL_S, deadline=5.0,
        topology_labels=topology_labels(), version="embedded",
        render_stats=exporter.render_stats.contribute,
        attribution=CardPods(checkpoint))
    return exporter.start()


class SmiPower:
    """``nvidia-smi``'s power.draw for card 0 every FLEET_SMI_GAP_S, each
    reading with its own timestamp, from one ``nvidia-smi -lms`` process
    (a process forked per reading would hold this process's interpreter
    lock through each fork and idle the burn's card meanwhile)."""

    def __init__(self) -> None:
        self.rows: list[tuple[float, float]] = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=timestamp,power.draw",
             "--format=csv,noheader,nounits", "-lms",
             str(int(FLEET_SMI_GAP_S * 1e3))],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> None:
        import datetime

        if self.proc.poll() is None:
            self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        for line in out.splitlines():
            try:
                stamp, watts = line.split(",")
                self.rows.append((datetime.datetime.strptime(
                    stamp.strip(), "%Y/%m/%d %H:%M:%S.%f").timestamp(),
                    float(watts)))
            except ValueError:  # "[N/A]" or a cut line
                continue

    def mean(self, t0: float, t1: float) -> float:
        """Mean draw over [t0, t1], wall clock (after ``stop``)."""
        values = [w for t, w in self.rows if t0 <= t <= t1]
        require(values, "fleet: no nvidia-smi power reading in the window")
        return statistics.fmean(values)


def fleet_doctor(port: int, *flags: str, key: str | None = None
                 ) -> tuple[int, dict]:
    """``doctor`` against the hub: exit code, rows by name."""
    cmd = [sys.executable, "-m", "kube_gpu_stats_tpu_torch", "doctor",
           "--backend", FLEET_DOCTOR_BACKEND, "--attribution", "off",
           "--interval", "0.1",
           "--json", "--url", f"http://127.0.0.1:{port}/metrics", *flags]
    if key is not None:
        cmd += ["--energy-audit-key", key]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    try:
        payload = json.loads(proc.stdout)
    except ValueError:
        raise RuntimeError(f"fleet: doctor {flags}: {proc.stdout[-500:]} "
                           f"{proc.stderr[-1500:]}")
    return proc.returncode, {row["name"]: row for row in payload["checks"]}


def ring_bucket_inside(t0: float, t1: float, step: float = 10.0) -> float:
    """The middle of the ring bucket of ``step`` seconds that lies most
    inside [t0, t1] (wall clock)."""
    best, best_cover = t0, -1.0
    start = math.floor(t0 / step) * step
    while start < t1:
        cover = min(t1, start + step) - max(t0, start)
        if cover > best_cover:
            best, best_cover = start + step / 2, cover
        start += step
    return best


def slowest_values(texts, phase: str) -> set[str]:
    """The rendered kts_slowest_tick_seconds values of ``phase`` in a
    node's own scrapes."""
    out = set()
    for text in texts:
        for name, labels, value in value_strings(text):
            if (name == schema.SLOWEST_TICK_SECONDS.name
                    and labels.get("phase") == phase):
                out.add(value)
    return out


def hub_trace_ms(port: int) -> tuple[list[float], list[float]]:
    """(whole-refresh ms, fleet_score ms) of the hub's recorded cycles."""
    status, body, _ = fetch(f"http://127.0.0.1:{port}/debug/trace?last=128")
    require(status == 200, f"hub /debug/trace answered {status}")
    events = json.loads(body)["traceEvents"]
    cycles = [e["dur"] / 1e3 for e in events if e.get("cat") == "cycle"]
    score = [e["dur"] / 1e3 for e in events
             if e.get("name") == "fleet_score" and "dur" in e]
    return cycles, score


def fleet_card_uuid() -> str:
    return "GPU-" + str(torch.cuda.get_device_properties(0).uuid)


def fleet_hold():
    """Memory the burn keeps on the card through its pause, so the pause
    idles the card without releasing its reservation."""
    return torch.empty(FLEET_HELD_BYTES, dtype=torch.uint8, device="cuda")


class FleetStop(Exception):
    """Raised by the fleet burn's step hook to end its one run_burn."""


def fleet_burn(record) -> None:
    """One ``cuda`` burn for the whole phase (a burn started anew would
    idle the card between runs, which its duty shows), steered from its
    step hook: the hook blocks to pause it with its tensors held and
    raises FleetStop to end it."""
    try:
        run_burn(seconds=FLEET_MAX_S, size=MAIN_SIZE, report_every=1e9,
                 kernel="cuda", device="cuda:0", step_hook=record,
                 batch=FLEET_BATCH)
    except FleetStop:
        torch.cuda.synchronize()
        return
    raise RuntimeError(f"the fleet phase did not end in {FLEET_MAX_S} s")


def phase_fleet(card_line: str) -> int:
    """The fleet lens on the hub at the hub phase's scale, on card 0: the
    hub with the lens and efficiency at their defaults, an audit key and
    the history ring; the NVML daemon at 10 Hz as node-00 pushing, with
    the kubelet checkpoint that gives card 0 to the burn's pod; the
    ``cuda`` burn in this process with its exporter pulled; 63 synthetic
    8-card nodes, each its own pod, in a process of their own. Windows: a
    warm-up; the burn paused with its tensors held (idle reservation); the
    burn stepping without recording steps (low goodput); one synthetic
    worker at half rate (straggler) and then one silent; the doctor's
    lens rows live and after the fact; the signed attestation; the lens's
    cost. Returns the kernel launches."""
    from kube_gpu_stats_tpu_torch import efficiency as efficiency_mod
    from kube_gpu_stats_tpu_torch import energy, fleetlens

    workdir = tempfile.mkdtemp(prefix="kts-fleet-")
    uuid = fleet_card_uuid()
    checkpoint = os.path.join(workdir, "kubelet_internal_checkpoint")
    kubelet_checkpoint(checkpoint, uuid, FLEET_POD_UID)
    key = base64.b16encode(os.urandom(16)).decode()
    targets_file = os.path.join(workdir, "targets.txt")
    warmup = efficiency_mod.DEFAULT_WARMUP_REFRESHES
    idle = efficiency_mod.DEFAULT_IDLE_REFRESHES
    clear = efficiency_mod.CLEAR_REFRESHES
    misses = fleetlens.FRESHNESS_MISS_THRESHOLD
    saved_env = {k: os.environ.get(k) for k in ("KTS_SLICE", "KTS_WORKER")}
    os.environ["KTS_SLICE"], os.environ["KTS_WORKER"] = HUB_SLICE, "node-00"
    out: dict = {"card": card_line, "threads_at_start":
                 threading.active_count()}
    saved_switch = sys.getswitchinterval()
    gc.collect()
    gc.freeze()
    sys.setswitchinterval(FLEET_SWITCH_S)
    held = fleet_hold()
    exporter = fleet_exporter(checkpoint)
    embedded_rec = PublishRecorder(exporter.registry, keep=200)
    embedded_url = f"http://127.0.0.1:{exporter.port}/metrics"
    with open(targets_file, "w") as handle:
        handle.write(f"{embedded_url}\n")
    daemon_port = free_port()
    daemon_source = f"http://127.0.0.1:{daemon_port}/metrics"
    node = lambda n: f"http://node-{n:02d}.synthetic:9400/metrics"
    node00 = {embedded_url, daemon_source}
    mode = {"burn": "run"}
    failure: list = []
    steps_log: list = [(time.monotonic(), 0)]
    hub_proc = daemon_proc = synth = smi = None
    hook = StepCounter()

    def record(n: int, *, seconds: float, flops: float) -> None:
        """The burn's step hook, every FLEET_BATCH steps: forwards them
        to the exporter (``run``), keeps them to itself (``nosteps``: the
        card busy, no step recorded), holds the burn (``pause``: what is
        queued drains, the tensors stay), or ends it (``stop``)."""
        hook(n, seconds=seconds, flops=flops)
        if mode["burn"] == "run":
            exporter.record_step(n, seconds=seconds, flops=flops)
            steps_log.append((time.monotonic(), hook.steps))
        while mode["burn"] == "pause":
            time.sleep(0.01)
        if mode["burn"] == "stop":
            raise FleetStop

    def burn_rate(t0: float, t1: float) -> float:
        log_ = [(t, s) for t, s in list(steps_log) if t0 <= t <= t1]
        require(len(log_) >= 2, "fleet: no steps recorded in the window")
        return (log_[-1][1] - log_[0][1]) / (log_[-1][0] - log_[0][0])

    try:
        hub_port = free_port()
        hub_url = f"http://127.0.0.1:{hub_port}"
        synth = FleetSynth(hub_url, workdir)
        t_start = time.monotonic()
        hub_proc, hub_port, hub_log = start_hub(
            ["--interval", str(FLEET_INTERVAL_S), "--expect-workers",
             str(HUB_NODES), "--targets-file", targets_file,
             "--energy-audit-key", key], hub_port)
        out["hub_start_s"] = time.monotonic() - t_start
        daemon_proc, port, log = start_daemon(workdir, (
            "--interval", str(FLEET_DAEMON_INTERVAL_S), "--textfile-dir", "",
            "--listen-port", str(daemon_port), "--hub-url", hub_url,
            "--hub-push-source", daemon_source, "--hub-push-interval",
            "0.01", "--attribution", "checkpoint", "--checkpoint-path",
            checkpoint, "--energy-audit-key", key))
        smi = SmiPower()
        with DaemonWatcher(daemon_proc, port, log, conform=True,
                           keep_texts=True) as watch:

            def journal(kinds: tuple) -> list[dict]:
                status, body, _ = fetch(f"{hub_url}/debug/events")
                require(status == 200, f"hub /debug/events {status}")
                return [e for e in json.loads(body)["events"]
                        if e["kind"] in kinds]

            def fleet_payload() -> dict:
                status, body, _ = fetch(f"{hub_url}/debug/fleet")
                require(status == 200, f"hub /debug/fleet {status}")
                return json.loads(body)

            def waste(gen: dict, reason: str) -> float | None:
                return fleet_value(gen, schema.FLEET_WASTE_SUSPECT.name,
                                   pod=FLEET_POD_UID, reason=reason)

            def controller() -> None:
                try:
                    windows(out)
                except Exception as exc:  # noqa: BLE001 - re-raised
                    failure.append(exc)
                    fleet_diagnostics(hub_url, synth)
                finally:
                    mode["burn"] = "stop"

            def windows(out: dict) -> None:
                # The pod owns the card once both exporters' first
                # attribution has landed in the daemon's scrape.
                deadline = time.monotonic() + 30
                while not any(f'pod="{FLEET_POD_UID}"' in text
                              for text in list(watch.texts.values())[-3:]):
                    require(time.monotonic() < deadline,
                            "fleet: the daemon never served the pod")
                    time.sleep(0.1)
                t_rate = time.monotonic()
                time.sleep(3.0)
                rate = burn_rate(t_rate, time.monotonic())
                out["burn_steps_per_s_start"] = rate
                # The synthetic nodes' frozen card: the daemon's card 0
                # as it serves it under the burn.
                newest = watch.texts[max(watch.texts)]
                template = [
                    (name, labels, value) for name, labels, value
                    in validate.parse_exposition(newest)
                    if labels.get("uuid") == uuid]
                path = os.path.join(workdir, "template.json")
                with open(path, "w") as handle:
                    json.dump(template, handle)
                synth.command(f"template {path} {rate * FLEET_INTERVAL_S}")
                require(synth.ready.wait(60),
                        f"fleet: the synthetic nodes never started: "
                        f"{synth.errors[-20:]}")
                # 1. Warm-up: every pod seen past the waste warm-up.
                c0 = synth.newest()
                gen = synth.wait(lambda g: g["count"] >= c0 + warmup + 1,
                                  c0, warmup + 1, "the warm-up")
                raised = journal(("fleet_anomaly", "fleet_waste"))
                out["warmup"] = {
                    "refreshes": gen["count"] - c0,
                    "anomalous": fleet_value(
                        gen, schema.FLEET_TARGETS_ANOMALOUS.name),
                    "raised": [(e["attrs"].get("target"),
                                e["attrs"].get("anomaly"),
                                e["attrs"].get("z"))
                               for e in raised]}
                require(not raised and fleet_value(
                    gen, schema.FLEET_TARGETS_ANOMALOUS.name) == 0.0,
                    f"fleet: the warm-up raised {out['warmup']}")
                # 2. The idle reservation.
                t_pause, wall_pause = time.monotonic(), time.time()
                c_pause = synth.newest()
                mode["burn"] = "pause"
                gen = synth.wait(
                    lambda g: waste(g, "idle-reservation") == 1.0,
                    c_pause, idle + FLEET_MARGIN, "idle-reservation")
                out["idle_after"] = gen["count"] - c_pause
                wall_idle = gen["seen"]
                while time.monotonic() - t_pause < FLEET_PAUSE_MIN_S:
                    time.sleep(0.1)
                c_resume, wall_resume = synth.newest(), time.time()
                mode["burn"] = "run"
                gen = synth.wait(
                    lambda g: waste(g, "idle-reservation") == 0.0,
                    c_resume, clear + FLEET_MARGIN, "the waste cleared")
                out["idle_cleared_after"] = gen["count"] - c_resume
                wall_cleared = gen["seen"]
                events = journal(("fleet_anomaly", "fleet_recovered",
                                  "fleet_waste", "fleet_waste_cleared"))
                raised = [e for e in events if e["kind"] == "fleet_anomaly"]
                out["idle_raised"] = sorted(
                    (e["attrs"]["target"], e["attrs"]["anomaly"])
                    for e in raised)
                duty = [e for e in raised
                        if e["attrs"]["target"] == daemon_source
                        and e["attrs"]["anomaly"] == "duty"]
                require(len(duty) == 1, f"fleet: node-00's duty anomaly "
                                        f"raised {len(duty)} times")
                require(all(e["attrs"]["target"] in node00 for e in raised),
                        f"fleet: the pause flagged other targets: "
                        f"{out['idle_raised']}")
                wastes = [e for e in events if e["kind"] == "fleet_waste"]
                require([(e["attrs"]["pod"], e["attrs"]["reason"])
                         for e in wastes]
                        == [(FLEET_POD_UID, "idle-reservation")],
                        f"fleet: waste verdicts {wastes}")
                require(fleet_value(gen, schema.FLEET_ANOMALIES.name,
                                    target=daemon_source, kind="duty")
                        == 1.0, "fleet: kts_fleet_anomalies_total for "
                                "node-00's duty is not 1")
                cleared = [e for e in events
                           if e["kind"] == "fleet_waste_cleared"]
                require(len(cleared) == 1, f"fleet: {cleared}")
                duty_back = [e for e in journal(("fleet_recovered",))
                             if e["attrs"]["target"] == daemon_source
                             and e["attrs"]["anomaly"] == "duty"]
                require(duty_back and duty_back[0]["id"]
                        < cleared[0]["id"],
                        "fleet: node-00's duty not recovered before the "
                        "waste cleared")
                out["pause"] = (wall_pause, wall_resume)
                out["waste_active"] = (wall_idle, wall_cleared)
                # 3. Low goodput: GEMMs, no steps recorded.
                c_flat = synth.newest()
                mode["burn"] = "nosteps"
                gen = synth.wait(lambda g: waste(g, "low-goodput") == 1.0,
                                  c_flat, idle + FLEET_MARGIN,
                                  "low-goodput")
                out["flat_after"] = gen["count"] - c_flat
                c_steps = synth.newest()
                mode["burn"] = "run"
                gen = synth.wait(lambda g: waste(g, "low-goodput") == 0.0,
                                  c_steps, clear + FLEET_MARGIN,
                                  "low-goodput cleared")
                out["flat_cleared_after"] = gen["count"] - c_steps
                wastes = journal(("fleet_waste",))
                require([e["attrs"]["reason"] for e in wastes]
                        == ["idle-reservation", "low-goodput"],
                        f"fleet: waste verdicts {wastes}")
                # 4. The straggler.
                synth.command(f"straggle {FLEET_STRAGGLER}")
                c_straggle = synth.newest()
                gens = []
                while len(gens) < FLEET_STRAGGLE_REFRESHES:
                    gen = synth.wait(lambda g: True,
                                      c_straggle + len(gens), 1,
                                      "a straggler refresh")
                    gens.append(gen)
                ratios = [g["ratio"] for g in gens[1:]]
                out["straggler_ratios"] = ratios
                require(all(r is not None
                            and abs(r - 0.5) <= FLEET_RATIO_TOL
                            for r in ratios),
                        f"fleet: slice_straggler_ratio {ratios}")
                # 5. The silent node (the straggler still straggling).
                synth.command(f"silence {FLEET_SILENT}")
                c_silent = synth.newest()
                silent = node(FLEET_SILENT)
                down = []

                def third_miss(g: dict) -> bool:
                    if g["up"].get(silent) == 0.0:
                        down.append(g["count"])
                    return len(down) == misses

                # The push fence (three intervals) before the first miss.
                gen = synth.wait(third_miss, c_silent, misses + 5,
                                  "the third missed refresh")
                require(synth.gaps(down[0], gen["count"]) == [],
                        "fleet: the recorder missed a refresh")
                before = synth.gens.get(gen["count"] - 1, {})
                out["freshness"] = {
                    "misses": down,
                    "raised_at_third": fleet_value(
                        gen, schema.FLEET_ANOMALIES.name, target=silent,
                        kind="freshness"),
                    "before_third": fleet_value(
                        before, schema.FLEET_ANOMALIES.name, target=silent,
                        kind="freshness") if before else None}
                require(out["freshness"]["raised_at_third"] == 1.0
                        and not out["freshness"]["before_third"],
                        f"fleet: freshness {out['freshness']}")
                # 7. The doctor against the hub, live.
                out["doctor_fleet"] = fleet_doctor(hub_port, "--fleet")
                synth.command("unsilence")
                synth.command("unstraggle")
                c_back = synth.newest()
                gen = synth.wait(lambda g: g["up"].get(silent) == 1.0,
                                  c_back, FLEET_MARGIN,
                                  "the silent node back")
                back = [e for e in journal(("fleet_recovered",))
                        if e["attrs"]["target"] == silent
                        and e["attrs"]["anomaly"] == "freshness"]
                require(back, "fleet: the silent node's freshness did not "
                              "clear")
                # A steady stretch, for the rate and cost readings.
                t_steady, wall_steady = time.monotonic(), time.time()
                gen = synth.refreshes(FLEET_STEADY_REFRESHES)
                t_end = time.monotonic()
                payload = fleet_payload()
                out["steady"] = {"gen": gen, "fleet": payload,
                                 "wall": (wall_steady, time.time()),
                                 "burn": burn_rate(t_steady, t_end)}
                # 7. The rest of the doctor, and the look back.
                out["doctor_eff"] = fleet_doctor(hub_port, "--efficiency",
                                                 key=key)
                out["doctor_eff_wrong"] = fleet_doctor(
                    hub_port, "--efficiency", key=key + "x")
                out["doctor_eff_nokey"] = fleet_doctor(hub_port,
                                                       "--efficiency")
                t_fleet_at = ring_bucket_inside(*out["pause"])
                t_eff_at = ring_bucket_inside(*out["waste_active"])
                out["at"] = (t_fleet_at, t_eff_at)
                out["doctor_fleet_at"] = fleet_doctor(
                    hub_port, "--fleet", "--at", repr(t_fleet_at))
                out["doctor_eff_at"] = fleet_doctor(
                    hub_port, "--efficiency", "--at", repr(t_eff_at))
                # 8. The attestation.
                t0 = time.perf_counter()
                status, body, _ = fetch(f"{hub_url}/debug/efficiency")
                out["efficiency_ms"] = (time.perf_counter() - t0) * 1e3
                require(status == 200, f"/debug/efficiency {status}")
                out["attestation"] = json.loads(body)
                status, body, _ = fetch(f"http://127.0.0.1:{port}"
                                        f"/debug/energy")
                out["daemon_digest"] = json.loads(body)
                out["trace"] = hub_trace_ms(hub_port)
                out["final_gen"] = synth.gens[synth.newest()]
                out["payload_end"] = fleet_payload()

            thread = threading.Thread(target=controller, daemon=True)
            tiled_burn.launches = 0
            thread.start()
            fleet_burn(record)
            launches = tiled_burn.launches
            thread.join(timeout=60)
            require(not failure, f"the fleet phase failed: {failure}")
            out["daemon_texts"] = dict(watch.texts)
        out["daemon_rc"], _ = stop_with_stacks(daemon_proc, log)
    finally:
        if smi is not None:
            smi.stop()
        if daemon_proc is not None and "daemon_rc" not in out:
            stop_with_stacks(daemon_proc, log)
        conform = synth.close() if synth is not None else None
        if hub_proc is not None:
            out["hub_rc"], _ = stop_with_stacks(hub_proc, hub_log)
        exporter.stop()
        del held
        sys.setswitchinterval(saved_switch)
        gc.unfreeze()
        for key_, value in saved_env.items():
            if value is None:
                os.environ.pop(key_, None)
            else:
                os.environ[key_] = value
    # One launch before the loop, one per step queued; the steps of at
    # most two batches were queued but not yet reported when the hook
    # ended the burn.
    require(0 <= launches - 1 - hook.steps <= 2 * FLEET_BATCH,
            f"fleet: {launches} launches for {hook.steps} steps reported")
    require(out.get("hub_rc") == 0, f"fleet: the hub exited "
                                    f"{out.get('hub_rc')}: {hub_log[-20:]}")
    require(out.get("daemon_rc") == 0,
            f"fleet: the daemon exited {out.get('daemon_rc')}")
    require(conform["checked"] >= len(synth.gens) and not conform["failed"],
            f"fleet: the hub's scrapes against the contract: {conform}")
    out["steady"]["power_w"] = smi.mean(*out["steady"]["wall"])
    row = fleet_checks(out, synth, embedded_rec, daemon_source,
                       embedded_url, node, key)
    row.update(launches=launches, conform_checked=conform["checked"])
    emit("fleet", row)
    return launches


def fleet_checks(out: dict, synth: FleetSynth, embedded_rec,
                 daemon_source: str, embedded_url: str, node, key: str
                 ) -> dict:
    """Windows 4-9 from what the phase read: the SLO windows against the
    refreshes this script saw, slow-node attribution, the doctor's rows,
    the attestation, the lens's cost and its steps per joule."""
    from kube_gpu_stats_tpu_torch import energy, fleetlens

    gens = [synth.gens[c] for c in sorted(synth.gens)]
    first, last = gens[0]["count"], gens[-1]["count"]
    end = out["final_gen"]
    grid_errors = [r["grid_error_s"] for r in synth.rounds]
    gaps = synth.gaps(1, end["count"])
    require(not gaps, f"fleet: the recorder missed refreshes {gaps[:10]}")
    # 4. The straggler SLO: the refreshes with a ratio, bad below the
    # objective's minimum, against the lens's windows (the phase is
    # shorter than the 5m window: both hold every refresh).
    upto = [g for g in gens if g["count"] <= end["count"]]
    with_ratio = [g["ratio"] for g in upto if g["ratio"] is not None]
    bad = sum(1 for r in with_ratio if r < fleetlens.DEFAULT_STRAGGLER_RATIO)
    want = round(bad / len(with_ratio), 6)
    budget = 1.0 - fleetlens.DEFAULT_STRAGGLER_TARGET
    slo = {}
    for window in ("5m", "1h"):
        got = fleet_value(end, schema.FLEET_SLO_BAD.name,
                          objective="straggler", window=window)
        burn = fleet_value(end, schema.FLEET_SLO_BURN.name,
                           objective="straggler", window=window)
        slo[window] = (got, burn)
        require(got == want and burn == round(want / budget, 3),
                f"fleet: straggler SLO {window} {got}/{burn}, counted "
                f"{bad} of {len(with_ratio)} = {want}")
    # 5. The freshness SLO: the silent node's 8 last-known cards burn in
    # each refresh it missed.
    payload = out["payload_end"]
    windows = payload["slo"]["freshness"]["windows"]
    missed = [g for g in upto if g["up"].get(node(FLEET_SILENT)) == 0.0]
    other_down = sum(1 for g in upto for t, v in g["up"].items()
                     if v == 0.0 and t != node(FLEET_SILENT))
    stale = sum(g["down_chips"] for g in upto)
    fresh_bad = round(windows["1h"]["bad_ratio"] * windows["1h"]["events"])
    require(other_down == 0 and fresh_bad == HUB_CARDS * len(missed) + stale,
            f"fleet: freshness burn {windows['1h']} for {len(missed)} "
            f"missed refreshes of {HUB_CARDS} cards, {stale} stale, "
            f"{other_down} other misses")
    # 6. Slow-node attribution: node-00 (its daemon or its exporter),
    # the value its own scrape serves.
    worst = {k: v for k, v in end["fleet"].items()
             if k.startswith(schema.FLEET_WORST_TICK.name + "{")}
    require(len(worst) == 1, f"fleet: worst tick {worst}")
    (raw, value), = worst.items()
    labels = dict(validate._tokenize_labels(raw.partition("{")[2][:-1]))
    texts = (list(out["daemon_texts"].values())[-300:]
             if labels["target"] == daemon_source
             else embedded_rec.texts()[-200:])
    require(labels["target"] in (daemon_source, embedded_url)
            and value in slowest_values(texts, labels["phase"]),
            f"fleet: worst tick {labels} {value} is not node-00's own")
    targets = payload["targets"]
    digests = sorted(t for t, e in targets.items() if e.get("digest"))
    require(set(digests) <= {daemon_source, embedded_url},
            f"fleet: digests from {digests}")
    # 7. The doctor.
    rc, rows = out["doctor_fleet"]
    detail = rows["fleet"]["detail"]
    require(rows["fleet"]["status"] == "warn"
            and node(FLEET_STRAGGLER) in detail
            and node(FLEET_SILENT) in detail
            and f"worst node: {labels['target']}" in detail,
            f"fleet: doctor --fleet {rc} {rows['fleet']}")
    rc, rows = out["doctor_eff"]
    require(rows["efficiency"]["status"] == "ok",
            f"fleet: doctor --efficiency {rc} {rows['efficiency']}")
    rc, rows = out["doctor_eff_wrong"]
    require(rc == 1 and rows["efficiency"]["status"] == "fail",
            f"fleet: doctor --efficiency, wrong key: {rows['efficiency']}")
    rc, rows = out["doctor_eff_nokey"]
    require(rows["efficiency"]["status"] == "warn",
            f"fleet: doctor --efficiency, no key: {rows['efficiency']}")
    rc, rows = out["doctor_fleet_at"]
    require(rows["fleet-at"]["status"] == "warn"
            and "straggler worker node-00" in rows["fleet-at"]["detail"],
            f"fleet: doctor --fleet --at {rows['fleet-at']}")
    rc, rows = out["doctor_eff_at"]
    require(rows["efficiency-at"]["status"] == "warn"
            and f"/{FLEET_POD_UID} was wasting chips (idle-reservation"
            in rows["efficiency-at"]["detail"],
            f"fleet: doctor --efficiency --at {rows['efficiency-at']}")
    # 8. The attestation.
    att = out["attestation"]
    leaves = att["leaves"]
    leaf = leaves.get(daemon_source)
    require(leaf is not None and energy.verify_payload(leaf, key)
            and set(leaf) == set(out["daemon_digest"]),
            f"fleet: node-00's leaf {str(leaf)[:300]}")
    joules = round(sum(float(row[2]) for d in leaves.values()
                       if "error" not in d for row in d.get("per_pod") or []
                       if len(row) >= 3), 6)
    stubs = [t for t, d in leaves.items() if "error" in d]
    require(energy.verify_payload(att, key)
            and abs(att["totals"]["joules"] - joules) <= 1e-6
            and len(leaves) == 8 and len(stubs) == 7
            and att["totals"]["targets_total"] == HUB_NODES + 1,
            f"fleet: attestation totals {att['totals']}, {len(stubs)} "
            f"stubs")
    # 9. Cost and fidelity.
    steady = out["steady"]
    pods = steady["fleet"]["efficiency"]["pods"]
    pod = pods.get(f"/{FLEET_POD_UID}") or {}
    spj = pod.get("steps_per_joule")
    want_spj = steady["burn"] / steady["power_w"]
    require(spj is not None and abs(spj / want_spj - 1) <= FLEET_SPJ_TOL,
            f"fleet: steps per joule {spj} vs {want_spj}")
    cycles, score = out["trace"]
    rss = end.get("rss")
    return {
        "card": out["card"], "nodes": HUB_NODES, "cards": HUB_NODES
        * HUB_CARDS - HUB_CARDS + 2, "targets": HUB_NODES + 1,
        "refreshes": last - first + 1,
        "warmup": out["warmup"], "idle_after": out["idle_after"],
        "idle_cleared_after": out["idle_cleared_after"],
        "idle_raised": out["idle_raised"],
        "flat_after": out["flat_after"],
        "flat_cleared_after": out["flat_cleared_after"],
        "straggler_ratios": out["straggler_ratios"],
        "straggler_slo": {"bad": bad, "refreshes": len(with_ratio),
                          "windows": slo},
        "freshness": out["freshness"], "freshness_1h": windows["1h"],
        "worst": [labels, value],
        "doctor_fleet": out["doctor_fleet"][1]["fleet"]["detail"][:400],
        "doctor_at": [out["doctor_fleet_at"][1]["fleet-at"]["detail"][:300],
                      out["doctor_eff_at"][1]["efficiency-at"]["detail"][
                          :300]],
        "attestation": {"totals": att["totals"],
                        "ms": out["efficiency_ms"]},
        "fleet_score_ms": {"p50": statistics.median(score),
                           "max": max(score), "n": len(score)},
        "refresh_ms": {"p50": statistics.median(cycles),
                       "max": max(cycles), "n": len(cycles)},
        "hub_rss_mib": rss / MIB if rss else None,
        "steps_per_joule": {"lens": spj, "burn_over_smi": want_spj,
                            "burn_steps_per_s": steady["burn"],
                            "smi_power_w": steady["power_w"]},
        "push_round_s": statistics.median(r["push_s"]
                                          for r in synth.rounds),
        "push_failures": sum(r["failures"] for r in synth.rounds),
        "push_grid": {"anchors": synth.rounds[-1]["grid_anchors"],
                      "error_s": [min(grid_errors), max(grid_errors)]},
        "threads_at_start": out["threads_at_start"],
    }


# -- bench: the measurement module on the card ---------------------------

NATIVE_SEED = 16
NATIVE_FRAMES = 10_000
NATIVE_MUTATED = 0.1        # share of the frames given a corrupt byte or cut
NATIVE_NODES = 64           # the hub snapshot's synthetic nodes (+1 target)
NATIVE_CARDS = 8
NATIVE_WAVES = 6            # delta waves through the two hubs
NATIVE_GZIP_LEVELS = (1, 3, 6, 9)  # 3: the server's scrape level
NATIVE_REPEATS = 5
# Wall-clock-derived hub families: each hub computes them from its own
# refresh timestamps, so they are equal in shape but not in digits.
NATIVE_CLOCK_FAMILIES = ("slice_worker_steps_per_second",
                         "slice_straggler_ratio",
                         "slice_target_fetch_seconds")


def native_toolchain() -> dict:
    """The compiler and headers the host extension builds with here, and
    the seconds of one fresh build (into a scratch directory, whatever
    the package's build directory already holds)."""
    from kube_gpu_stats_tpu_torch.native import _hostbuild

    version = subprocess.run([_hostbuild.CXX, "--version"],
                             capture_output=True, text=True, timeout=60)
    dirs = [*_hostbuild.include_dirs(), "/usr/include", "/usr/local/include"]

    def header(name: str) -> str | None:
        return next((str(pathlib.Path(d) / name) for d in dirs
                     if (pathlib.Path(d) / name).is_file()), None)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            _hostbuild.command(pathlib.Path(tmp) / "_wirefast.so"),
            capture_output=True, text=True,
            timeout=_hostbuild.BUILD_TIMEOUT_S)
        seconds = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"g++ failed on the host extension: {proc.stderr[-3000:]}")
    return {"cxx": version.stdout.splitlines()[0] if version.stdout
            else version.stderr.strip(),
            "python_h": header("Python.h"), "zlib_h": header("zlib.h"),
            "build_s": seconds,
            "warnings": [line for line in (proc.stderr + proc.stdout)
                         .splitlines() if "warning" in line.lower()]}


def native_node_body(node: int, values) -> str:
    """One synthetic H100 node's exposition: ``NATIVE_CARDS`` cards with
    the daemon's per-card gauges and counters, two links each, and a
    workload step histogram. ``values``: a numpy generator."""
    from kube_gpu_stats_tpu_torch.registry import (HistogramState,
                                                   SnapshotBuilder)

    builder = SnapshotBuilder()
    for card in range(NATIVE_CARDS):
        labels = (("accel_type", "h100-sxm"), ("chip", str(card)),
                  ("device_path", f"/dev/nvidia{card}"),
                  ("uuid", f"GPU-{node:04d}-{card}"),
                  ("pod", f"train-{node // 8}"), ("namespace", "ml"),
                  ("container", "w"), ("slice", f"s{node // 16}"),
                  ("worker", str(node)), ("topology", "8x8"))
        duty = float(values.integers(0, 101))
        builder.add(schema.DEVICE_UP, 1.0, labels)
        builder.add(schema.DUTY_CYCLE, duty, labels)
        builder.add(schema.TENSORCORE_UTIL, duty * 0.8, labels)
        builder.add(schema.MEMORY_USED, float(values.integers(1, 80)) * MIB
                    * 1024, labels)
        builder.add(schema.MEMORY_TOTAL, 80.0 * 1024 * MIB, labels)
        builder.add(schema.POWER, float(values.uniform(80.0, 700.0)), labels)
        builder.add(schema.ENERGY, float(values.uniform(0.0, 1e9)), labels)
        builder.add(schema.TEMPERATURE, float(values.integers(30, 90)),
                    labels)
        builder.add(schema.WORKLOAD_STEPS, float(values.integers(0, 10**6)),
                    labels)
        for link in range(2):
            builder.add(schema.ICI_BANDWIDTH,
                        float(values.uniform(0.0, 4.5e11)),
                        labels + (("link", f"nvlink{link}"),))
    state = HistogramState.empty(schema.WORKLOAD_STEP_DURATION,
                                 (0.001, 0.01, 0.1, 1.0),
                                 labels=(("worker", str(node)),))
    for _ in range(int(values.integers(0, 20))):
        state = state.observe(float(values.uniform(0.0, 2.0)))
    builder.add_histogram(state)
    return builder.build().render()


def native_frames(values) -> list[bytes]:
    """``NATIVE_FRAMES`` seeded DELTA frames, decompressed, a share of
    them with a corrupt byte or cut short: every verdict of the decode
    (frames, FULL fallbacks, skew, truncation, bad UTF-8, slots past
    2^62) comes up."""
    import numpy as np

    from kube_gpu_stats_tpu_torch import snappy

    raws = []
    specials = (float("nan"), float("inf"), float("-inf"), -0.0, 1e300)
    for i in range(NATIVE_FRAMES):
        count = int(values.integers(0, 48))
        gaps = values.integers(1, 300, count)
        if count and values.random() < 0.01:
            gaps[-1] = 2**62
        slots = np.cumsum(gaps, dtype=object) if count else []
        vals = values.standard_normal(count) * 10.0 ** values.integers(-3, 12)
        vals = [specials[int(values.integers(0, len(specials)))]
                if values.random() < 0.05 else float(v) for v in vals]
        proto = int(values.integers(1, 3))
        build = f"b{i % 7}" if proto == 2 and values.random() < 0.5 else ""
        wire = delta.encode_delta(
            f"http://node-{i % 97:03d}:9400/metrics", 1 + i % 13, 2 + i,
            list(zip((int(s) for s in slots), vals)), proto=proto,
            caps=int(values.integers(0, 4)) if proto == 2 else 0,
            build=build)
        raw = bytearray(snappy.decompress(wire))
        if values.random() < NATIVE_MUTATED:
            if values.random() < 0.5:
                raw = raw[:int(values.integers(0, len(raw)))]
            else:
                raw[int(values.integers(0, len(raw)))] = int(
                    values.integers(0, 256))
        raws.append(bytes(raw))
    return raws


def decode_outcome(decode, raw: bytes):
    """A decode's frame (values as their bit patterns) or its verdict."""
    import struct

    try:
        f = decode(raw)
    except ValueError as exc:
        return (type(exc).__name__, str(exc))
    return (f.kind, f.source, f.generation, f.seq, f.body, f.slots,
            struct.pack(f"<{len(f.values)}d", *f.values), f.proto, f.caps,
            f.build)


def native_hub_lines(hub) -> list[str]:
    """The hub's served data series, clock-derived families left out."""
    text = hub.registry.rendered()[0].decode()
    return [line for line in text.splitlines()
            if line.startswith(("accelerator_", "slice_"))
            and not line.startswith(NATIVE_CLOCK_FAMILIES)]


def phase_native(card_line: str) -> None:
    """The host extension (``kube_gpu_stats_tpu_torch/native/wirefast.cc``)
    on the card's host: the toolchain it found, then each fast path held
    byte for byte against its Python path on this interpreter, and both
    paths' times."""
    import numpy as np

    from kube_gpu_stats_tpu_torch import bench, native, snappy
    from kube_gpu_stats_tpu_torch.collectors.mock import MockCollector
    from kube_gpu_stats_tpu_torch.hub import Hub
    from kube_gpu_stats_tpu_torch.poll import PollLoop
    from kube_gpu_stats_tpu_torch.registry import Registry

    t0 = time.monotonic()
    out: dict = {"card": card_line, "toolchain": native_toolchain()}
    start = time.perf_counter()
    module = native.load_render()
    native.load_ingest()
    out["load_s"] = time.perf_counter() - start
    out["library"] = str(native.library_path())
    values = np.random.default_rng(NATIVE_SEED)
    ms: dict = {}

    def best_ms(fn) -> float:
        times = []
        for _ in range(NATIVE_REPEATS):
            start = time.perf_counter()
            fn()
            times.append((time.perf_counter() - start) * 1e3)
        return min(times)

    # Render and gzip: an 8-card daemon snapshot and a ~6,000-series hub
    # snapshot, both formats, three gzip levels.
    daemon_registry = Registry(native=False)
    loop = PollLoop(MockCollector(num_devices=NATIVE_CARDS), daemon_registry,
                    pipeline_fetch=False)
    loop.tick()
    loop.tick()
    bodies = [native_node_body(node, values) for node in range(NATIVE_NODES)]
    sources = [f"http://node-{node:03d}:9400/metrics"
               for node in range(NATIVE_NODES)] + ["http://embedded:9401/metrics"]
    bodies.append(bench.build_pusher_body(NATIVE_NODES))
    hubs = {"native": Hub([], targets_provider=lambda: [], interval=10.0,
                          push_fence=1e9),
            "python": Hub([], targets_provider=lambda: [], interval=10.0,
                          push_fence=1e9, native_ingest=False)}
    encoders = {path: [delta.DeltaEncoder(source, generation=i + 1)
                       for i, source in enumerate(sources)]
                for path in hubs}
    apply_ms = {path: 0.0 for path in hubs}

    def feed(path: str, i: int, body: str) -> None:
        encoder = encoders[path][i]
        wire, _kind = encoder.encode_next(body)
        start = time.perf_counter()
        code, _resp, _hdrs = hubs[path].delta.handle(wire)
        apply_ms[path] += (time.perf_counter() - start) * 1e3
        require(code == 200, f"{path} hub answered {code} to {sources[i]}")
        encoder.ack()

    def refresh_both(wave: int) -> None:
        for path, hub in hubs.items():
            with native.python_paths(
                    "--no-native-ingest" if path == "python" else None):
                hub.refresh_once()
        got, want = (native_hub_lines(hubs["native"]),
                     native_hub_lines(hubs["python"]))
        require(got == want,
                f"wave {wave}: the native hub's /metrics differs from the "
                f"--no-native-ingest hub's: "
                f"{[l for l in want if l not in got][:5]}")

    try:
        for i, body in enumerate(bodies):
            for path in hubs:
                with native.python_paths(
                        "--no-native-ingest" if path == "python" else None):
                    feed(path, i, body)
        refresh_both(0)
        for path in hubs:
            apply_ms[path] = 0.0
        for wave in range(1, NATIVE_WAVES + 1):
            bodies = [native_node_body(node, values)
                      for node in range(NATIVE_NODES)] + [
                bench.build_pusher_body(NATIVE_NODES, duty=50.0 + wave)]
            for path in hubs:
                with native.python_paths(
                        "--no-native-ingest" if path == "python" else None):
                    for i, body in enumerate(bodies):
                        feed(path, i, body)
            refresh_both(wave)
        require(hubs["native"].delta.native_active
                and not hubs["python"].delta.native_active
                and all(hubs["native"]._parse_cache.get(s).patch_program
                        is not None for s in sources),
                "the native hub did not apply through its slot store")
        hub_snapshot = hubs["native"].registry.snapshot()
        out["hub"] = {"targets": len(sources),
                      "series": len(hub_snapshot.series),
                      "histograms": len(hub_snapshot.histograms),
                      "waves": NATIVE_WAVES,
                      "lines_compared": len(native_hub_lines(hubs["native"]))}
        ms["apply_per_wave"] = {path: apply_ms[path] / NATIVE_WAVES
                                for path in hubs}
    finally:
        for hub in hubs.values():
            hub.stop()

    renders = {}
    for what, snapshot in (("daemon_8_cards", daemon_registry.snapshot()),
                           ("hub", hub_snapshot)):
        for om in (False, True):
            want = snapshot.render(openmetrics=om).encode()
            got = module.render_exposition(snapshot.series,
                                           snapshot.histograms, om)
            require(got == want, f"native render of the {what} snapshot "
                                 f"(openmetrics={om}) differs")
            for level in NATIVE_GZIP_LEVELS:
                require(module.gzip_compress(want, level)
                        == gzip.compress(want, compresslevel=level, mtime=0),
                        f"native gzip level {level} of the {what} snapshot "
                        f"differs from gzip.compress")
        renders[what] = {"series": len(snapshot.series), "bytes": len(want)}
    out["renders"] = renders
    text = hub_snapshot.render().encode()
    ms["render_hub"] = {
        "native": best_ms(lambda: module.render_exposition(
            hub_snapshot.series, hub_snapshot.histograms, False)),
        "python": best_ms(lambda: hub_snapshot.render().encode())}
    ms["gzip_hub_level3"] = {
        "native": best_ms(lambda: module.gzip_compress(text, 3)),
        "python": best_ms(lambda: gzip.compress(text, compresslevel=3,
                                                mtime=0))}

    # Decode: every seeded frame through both decoders, then snappy.
    raws = native_frames(values)
    start = time.perf_counter()
    got = [decode_outcome(delta.decode_frame_raw, raw) for raw in raws]
    native_decode_ms = (time.perf_counter() - start) * 1e3
    with native.python_paths("--no-native"):
        start = time.perf_counter()
        want = [decode_outcome(delta.decode_frame_raw, raw) for raw in raws]
        python_decode_ms = (time.perf_counter() - start) * 1e3
    diverged = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    require(not diverged, f"{len(diverged)} frames decode differently, "
                          f"first {raws[diverged[0]].hex() if diverged else ''}")
    errors = collections.Counter(w[0] for w in want if isinstance(w[0], str))
    out["decode"] = {"frames": len(raws), "decoded": len(raws) - sum(
        errors.values()), "verdicts": dict(errors)}
    ms["decode_10k_frames"] = {"native": native_decode_ms,
                               "python": python_decode_ms}
    wires = [snappy.compress(raw) for raw in raws]
    for wire, raw in zip(wires, raws):
        require(snappy.decompress(wire) == raw == snappy._decompress_py(wire),
                "a snappy round trip differs")
    cut = [wire[:len(wire) // 2] for wire in wires[:1000]]
    for wire in cut:
        outcomes = []
        for decoder in (snappy.decompress, snappy._decompress_py):
            try:
                outcomes.append(decoder(wire))
            except ValueError as exc:
                outcomes.append(str(exc))
        require(outcomes[0] == outcomes[1],
                f"snappy verdicts differ on {wire.hex()}: {outcomes}")
    ms["snappy_10k_frames"] = {
        "native": best_ms(lambda: [snappy.decompress(w) for w in wires]),
        "python": best_ms(lambda: [snappy._decompress_py(w)
                                   for w in wires])}
    out["snappy"] = {"round_trips": len(wires), "cut_streams": len(cut)}
    out["ms"] = ms
    out["faults"] = native.faults()
    require(not out["faults"], f"a fast path faulted: {out['faults']}")
    out["seconds"] = time.monotonic() - t0
    emit("native", out)


BENCH_TICKS = 50
BENCH_WARMUP = 5
BENCH_SIZE = 4096
BUSY_MIN = 0.9
SWEEP_BENCH = (2048, 4096, 8192)
BENCH_SOFT_S = 240.0
# Every host measurement of the phase, each at the reference's defaults
# (the phase makes no cut: it runs in about 140 s of its 240 s).
BENCH_MEASUREMENTS = (
    "measure_quiet_tick_delta", "measure_delta_federation",
    "measure_hub_merge", "measure_ingest_storm",
    "measure_ingest_storm_procs", "measure_warm_restart",
    "measure_overload_shed", "measure_cardinality_admission",
    "measure_query_serving", "measure_partition_drain",
    "measure_degraded_overhead", "measure_burst_overhead",
    "measure_hoststats", "measure_fleet_localize",
    "measure_efficiency_score")
PROFILE_INGEST_ARGS = {"sources": 1000, "waves": 5}
# The hub measurements run again with the host fast paths off
# (native=False: --no-native-ingest and the Python snappy and delta
# decode): each figure with native on and off, beside its budget. A
# measurement's later runs in one process find warm intern pools and
# memos, so the cheap ones alternate (on, off, on, off) and every run is
# reported in order; the storm runs once each way.
NATIVE_PAIRS = {
    "measure_delta_federation": (("delta_ingest_ms_per_refresh",
                                  "root_merge_p50_ms"), 2),
    "measure_hub_merge": (("cold_ms", "p50_ms"), 2),
    "measure_ingest_storm": (("delta_ingest_10k_ms_per_refresh",
                              "ingest_cpu_pct"), 1),
}
# measure_collector's keys, as the reference's returns them (a collector
# without rpc_stats, as the NVML and embedded ones are).
COLLECTOR_KEYS = frozenset((
    "chips", "ticks", "durations_ms", "mean_ms", "p50_ms", "p90_ms",
    "p99_ms", "metrics_per_chip", "max_hz", "scrape_p50_ms",
    "scrape_p99_ms", "gc_collections", "gc_max_pause_ms",
    "tick_alloc_objects_per_tick", "tick_series_per_tick",
    "tick_series_reused_per_tick", "tick_spans_per_tick",
    "trace_overhead_ns_per_span"))
REAL_KEYS = COLLECTOR_KEYS | {"mode", "path"}
EMBEDDED_KEYS = COLLECTOR_KEYS | {
    "mode", "path", "device_kind", "workload_steps_per_s_during_bench",
    "workload_busy_fraction_during_bench",
    "workload_mfu_pct_during_bench", "mfu_sweep"}
# Each measurement's keys, as the reference's returns them
# (tests/test_torch_bench_smoke.py holds this table against it).
BENCH_KEYS = {
    "measure_quiet_tick_delta": ("full_bytes", "quiet_delta_bytes",
                                 "ratio"),
    "measure_delta_federation": (
        "workers", "leaves", "root_merge_p50_ms", "root_merge_cold_ms",
        "delta_ingest_ms_per_refresh", "delta_bytes_per_refresh",
        "full_bytes_total", "root_series"),
    "measure_hub_merge": ("p50_ms", "cold_ms", "body_cache_hit_rate",
                          "parse_mb_per_s", "render_cache_hits",
                          "fleet_score_ms_per_refresh"),
    "measure_ingest_storm": (
        "pushers", "lanes", "native", "seed_s", "cold_refresh_ms",
        "warm_refresh_ms", "delta_ingest_10k_ms_per_refresh",
        "ingest_cpu_pct", "resync_storm_recovery_s",
        "resync_storm_sessions", "resync_storm_dropped",
        "resync_storm_served"),
    "measure_ingest_storm_procs": (
        "procs", "pushers", "seed_ms", "delta_ingest_procs_ms_per_refresh",
        "ingest_procs_cpu_pct", "accepted_total", "hub_frames_total",
        "conserved", "per_proc_accepted"),
    "measure_warm_restart": ("pushers", "warm_restart_sessions",
                             "resumed_fraction", "resyncs", "replay_s",
                             "recovery_s", "dropped"),
    "measure_overload_shed": ("pushers", "delta_shed", "full_refused",
                              "fence_held", "sessions_alive",
                              "sources_served_fraction", "shed_counts"),
    "measure_cardinality_admission": (
        "cardinality_admission_ns_per_series", "ingest_ns_per_series",
        "cardinality_admission_overhead_pct", "hub_rss_mb_under_bomb",
        "bomb_series_attempted", "bomb_live_series"),
    "measure_query_serving": (
        "query_p50_ms_256readers", "query_p99_ms_256readers",
        "scrape_304_ratio", "history_write_ns_per_refresh",
        "history_rss_mb", "query_requests"),
    "measure_partition_drain": (
        "frames", "spill_spool_ms_per_frame", "spill_bytes_per_tick",
        "partition_drain_frames_per_s", "partition_catchup_s",
        "spill_dropped"),
    "measure_degraded_overhead": (
        "healthy_store_ms_per_tick", "degraded_store_ms_per_tick",
        "degraded_overhead_pct", "degraded_lost_counted"),
    "measure_burst_overhead": ("burst_overhead_pct",
                               "burst_fold_ms_per_tick",
                               "burst_samples_per_sec",
                               "burst_thread_cpu_pct"),
    "measure_hoststats": ("hoststats_read_ms_per_tick",
                          "hoststats_read_p99_ms", "hoststats_families"),
    "measure_fleet_localize": ("fleet_localize_ms",),
    "measure_efficiency_score": ("fleet_efficiency_ms_per_refresh",),
}
# The figures that do not depend on the host's speed, at the defaults:
# what the reference computes there on the CPU
# (tests/test_torch_bench_smoke.py holds this table against it).
BENCH_EXACT = {
    "measure_quiet_tick_delta": {"full_bytes": 1308,
                                 "quiet_delta_bytes": 31, "ratio": 42.2},
    "measure_delta_federation": {"workers": 4096, "leaves": 64,
                                 "delta_bytes_per_refresh": 9269,
                                 "full_bytes_total": 132967,
                                 "root_series": 9192},
    "measure_hub_merge": {"body_cache_hit_rate": 0.889,
                          "render_cache_hits": 3},
    "measure_warm_restart": {"pushers": 2000,
                             "warm_restart_sessions": 2000,
                             "resumed_fraction": 0.98, "resyncs": 40,
                             "dropped": 0},
    "measure_cardinality_admission": {"bomb_series_attempted": 400000,
                                      "bomb_live_series": 2036},
    "measure_query_serving": {"scrape_304_ratio": 1.0,
                              "history_rss_mb": 2.872,
                              "query_requests": 1536},
    "measure_partition_drain": {"frames": 200,
                                "spill_bytes_per_tick": 528.0,
                                "spill_dropped": 0},
    "measure_degraded_overhead": {"degraded_lost_counted": 200},
    "measure_hoststats": {"hoststats_families": 18},
}
# profile_ingest's ingest counters at PROFILE_INGEST_ARGS (the same
# test holds them against the reference's).
PROFILE_INGEST_EXACT = {"full_frames": 1000, "delta_frames": 6000,
                        "duplicate_frames": 0, "bytes": 1077718,
                        "resyncs": 0, "sessions": 1000, "quarantined": 0,
                        "shed": 0, "warm_restart_pending": 0,
                        "skew_refused": 0}
# The budgets the reference's tests/test_latency.py pins on each timing:
# (key, "<" or ">" or ">=", limit). Reported beside each figure, not
# required: these are host timings on the card machine's shared host.
BENCH_BUDGETS = {
    "real": (("p50_ms", "<", 50.0), ("scrape_p50_ms", "<", 5.0),
             ("trace_overhead_ns_per_span", "<", 25_000.0)),
    "embedded": (("p50_ms", "<", 50.0), ("scrape_p50_ms", "<", 5.0),
                 ("trace_overhead_ns_per_span", "<", 25_000.0)),
    "measure_delta_federation": (("root_merge_p50_ms", "<", 10.0),
                                 ("delta_ingest_ms_per_refresh", "<", 9.0)),
    "measure_hub_merge": (("cold_ms", "<", 90.0),),
    "measure_ingest_storm": (
        ("delta_ingest_10k_ms_per_refresh", "<", 2500.0),
        ("ingest_cpu_pct", "<", 25.0),
        ("resync_storm_recovery_s", "<", 10.0)),
    "measure_warm_restart": (("replay_s", "<", 10.0),
                             ("recovery_s", "<", 20.0)),
    "measure_overload_shed": (("sources_served_fraction", ">=", 0.9),),
    "measure_cardinality_admission": (
        ("cardinality_admission_overhead_pct", "<", 2.0),),
    "measure_query_serving": (("query_p99_ms_256readers", "<", 25.0),
                              ("query_p50_ms_256readers", "<", 15.0),
                              ("history_write_ns_per_refresh", "<", 10e6),
                              ("history_rss_mb", "<", 20.0)),
    "measure_partition_drain": (("spill_spool_ms_per_frame", "<", 50.0),
                                ("spill_bytes_per_tick", "<", 16_384),
                                ("partition_drain_frames_per_s", ">", 100.0),
                                ("partition_catchup_s", "<", 10.0)),
    "measure_degraded_overhead": (("degraded_overhead_pct", "<", 10.0),),
    "measure_burst_overhead": (("burst_overhead_pct", "<", 2.0),
                               ("burst_samples_per_sec", ">", 100.0)),
    "measure_hoststats": (("hoststats_read_ms_per_tick", "<", 10.0),),
}


def budgets(name: str, result: dict) -> dict:
    """Each budgeted figure beside its limit, with ``budget_ok``."""
    out = {}
    for key, op, limit in BENCH_BUDGETS.get(name, ()):
        value = result[key]
        ok = {"<": value < limit, ">": value > limit,
              ">=": value >= limit}[op]
        out[key] = {"value": value, "limit": f"{op} {limit:g}",
                    "budget_ok": ok}
    return out


class LogTail(logging.Handler):
    """Prints, and keeps, the formatted records (tracebacks included) that
    the port's loggers send while the bench phase runs, so a
    measurement's None names its exception in the failure."""

    def __init__(self) -> None:
        super().__init__(logging.WARNING)
        self.records: list[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        text = self.format(record)
        self.records.append(text)
        print(text, file=sys.stderr, flush=True)


def require_bench(result, name: str, tail: LogTail) -> dict:
    require(isinstance(result, dict),
            f"{name} returned {result!r}; logged: {tail.records[-3:]}")
    return result


def bench_invariants(name: str, r: dict, kwargs: dict) -> None:
    """The exact figures that follow from a measurement's arguments
    (``kwargs`` over its defaults)."""
    from kube_gpu_stats_tpu_torch import bench

    args = {key: param.default for key, param in inspect.signature(
        getattr(bench, name)).parameters.items()}
    args.update(kwargs)
    if name == "measure_ingest_storm":
        pushers = args["pushers"]
        require(r["pushers"] == pushers and r["native"] is args["native"]
                and r["resync_storm_sessions"] == pushers
                and r["resync_storm_served"] == pushers
                and r["resync_storm_dropped"] == 0, f"{name}: {r}")
    elif name == "measure_ingest_storm_procs":
        require(r["conserved"] is True
                and r["accepted_total"] == r["hub_frames_total"]
                == args["pushers"] * (args["waves"] + 1)
                and sum(r["per_proc_accepted"].values())
                == r["accepted_total"]
                and len(r["per_proc_accepted"]) == args["procs"],
                f"{name}: {r}")
    elif name == "measure_overload_shed":
        pushers = args["pushers"]
        # Every shed counted once: the deltas refused for the rate, the
        # one new source refused by the session fence.
        require(r["delta_shed"] > 0 and r["full_refused"] == 0
                and r["fence_held"] is True
                and r["sessions_alive"] == pushers
                and r["shed_counts"] == {"memory": 1,
                                         "delta_rate": r["delta_shed"]},
                f"{name}: {r}")


def finite_times(name: str, r: dict) -> None:
    exact = set(BENCH_EXACT.get(name, ()))
    for key, value in r.items():
        if key in exact or isinstance(value, (bool, dict, list, str)):
            continue
        require(value is not None and math.isfinite(value) and value >= 0,
                f"{name}: {key} = {value!r}")


def phase_bench(card_line: str) -> int:
    """The measurement module (``kube_gpu_stats_tpu_torch/bench.py``) on
    the card; returns the kernel launches of its in-process burns."""
    from kube_gpu_stats_tpu_torch import bench, profiler, tracing

    tail = LogTail()
    logging.getLogger("kube_gpu_stats_tpu_torch").addHandler(tail)
    t0 = time.monotonic()
    out: dict = {"card": card_line, "cuts": [], "seconds": {}}
    try:
        # The NVML harness under its co-launched cuda burn.
        start = time.monotonic()
        real, probe = bench.try_real_harness(ticks=BENCH_TICKS,
                                             warmup=BENCH_WARMUP)
        out["seconds"]["try_real_harness"] = time.monotonic() - start
        out["probe"] = probe
        require_bench(real, "try_real_harness", tail)
        require(set(real) == REAL_KEYS,
                f"try_real_harness keys: {sorted(set(real) ^ REAL_KEYS)}")
        require(real["mode"] == "real" and real["path"] == "nvml"
                and real["ticks"] == BENCH_TICKS
                and len(real["durations_ms"]) == BENCH_TICKS,
                f"try_real_harness: {real['mode']}, {real['path']}")
        colaunch = probe["burn_colaunch"]
        require(colaunch["loaded"] and colaunch["returncode"] is not None
                and colaunch["returncode"] <= 0,
                f"the co-launched burn: {colaunch}")
        duty0 = probe["nvml_attempt"]["last_duty"].get("0")
        require(duty0 is not None and duty0 >= DUTY_MIN,
                f"card 0's duty in the NVML harness's last snapshot: "
                f"{duty0} (< {DUTY_MIN})")
        finite_times("try_real_harness", {
            k: v for k, v in real.items() if k != "durations_ms"})
        out["real"] = {"figures": real, "budgets": budgets("real", real)}

        # The embedded harness: the cuda burn and the sweep in this
        # process, through B1.
        tiled_burn.launches = 0
        start = time.monotonic()
        emb = bench.try_embedded_harness(probe, ticks=BENCH_TICKS,
                                         warmup=BENCH_WARMUP,
                                         size=BENCH_SIZE)
        launches = tiled_burn.launches
        out["seconds"]["try_embedded_harness"] = time.monotonic() - start
        require_bench(emb, "try_embedded_harness", tail)
        require(set(emb) == EMBEDDED_KEYS,
                f"try_embedded_harness keys: "
                f"{sorted(set(emb) ^ EMBEDDED_KEYS)}")
        require(emb["mode"] == "real" and emb["path"] == "embedded"
                and emb["device_kind"] == torch.cuda.get_device_name(0),
                f"try_embedded_harness: {emb['mode']}, {emb['path']}, "
                f"{emb['device_kind']}")
        require(emb["workload_busy_fraction_during_bench"] >= BUSY_MIN
                and emb["workload_steps_per_s_during_bench"] > 0,
                f"the embedded harness's card was not loaded: busy "
                f"{emb['workload_busy_fraction_during_bench']}, steps/s "
                f"{emb['workload_steps_per_s_during_bench']}")
        mfu = emb["workload_mfu_pct_during_bench"]
        require(mfu is not None and 0 < mfu <= MFU_MAX, f"MFU {mfu}")
        sweep = emb["mfu_sweep"]
        require([row.get("size") for row in sweep] == list(SWEEP_BENCH)
                and all("tflops_per_s" in row and row["tflops_per_s"] > 0
                        and "error" not in row and "skipped" not in row
                        for row in sweep), f"the sweep: {sweep}")
        require(launches > 0, "the embedded harness did not launch B1")
        finite_times("try_embedded_harness", {
            k: v for k, v in emb.items() if k != "durations_ms"})
        out["embedded"] = {"figures": emb,
                           "budgets": budgets("embedded", emb),
                           "launches": launches}

        # The host measurements. The stores' health registry is process
        # wide and the hub serves a series set per store: each
        # measurement starts from an empty one, as in a fresh process
        # (and as measure_degraded_overhead leaves it).
        for name in BENCH_MEASUREMENTS:
            wal.reset_store_stats()
            start = time.monotonic()
            result = require_bench(getattr(bench, name)(), name, tail)
            out["seconds"][name] = time.monotonic() - start
            keys = set(BENCH_KEYS[name])
            require(set(result) == keys,
                    f"{name} keys: {sorted(set(result) ^ keys)}")
            want = BENCH_EXACT.get(name, {})
            got = {key: result[key] for key in want}
            require(got == want, f"{name}: {got} != {want}")
            bench_invariants(name, result, {})
            finite_times(name, result)
            out[name] = {"figures": result, "budgets": budgets(name, result)}
        pairs = {}
        for name, (keys, rounds) in NATIVE_PAIRS.items():
            runs = [(True, out[name]["figures"])]
            start = time.monotonic()
            for native_on in [False, True] * (rounds - 1) + [False]:
                wal.reset_store_stats()
                what = f"{name}(native={native_on})"
                result = require_bench(getattr(bench, name)(
                    native=native_on), what, tail)
                want = BENCH_EXACT.get(name, {})
                got = {key: result[key] for key in want}
                require(got == want, f"{what}: {got} != {want}")
                bench_invariants(name, result, {"native": native_on})
                finite_times(name, result)
                runs.append((native_on, result))
            out["seconds"][f"{name}_pairs"] = time.monotonic() - start
            limits = {key: f"{op} {limit:g}"
                      for key, op, limit in BENCH_BUDGETS.get(name, ())}
            pairs[name] = {"order": ["native" if on else "python"
                                     for on, _ in runs]}
            for key in keys:
                pairs[name][key] = {
                    "native": [r[key] for on, r in runs if on],
                    "python": [r[key] for on, r in runs if not on],
                    "limit": limits.get(key)}
        out["native_pairs"] = pairs
        start = time.monotonic()
        span_ns = tracing.measure_overhead_ns()
        require(math.isfinite(span_ns) and span_ns > 0, f"span {span_ns}")
        out["measure_overhead_ns"] = {
            "figures": span_ns, "budgets": {"trace_overhead_ns_per_span": {
                "value": span_ns, "limit": "< 25000",
                "budget_ok": span_ns < 25_000}}}
        report, summary = profiler.profile_ingest(**PROFILE_INGEST_ARGS)
        out["seconds"]["profile_ingest"] = time.monotonic() - start
        require(summary["path"] == "native"
                and summary["ingest"] == PROFILE_INGEST_EXACT
                and "function calls" in report,
                f"profile_ingest: {summary}")
        out["profile_ingest"] = summary
    finally:
        logging.getLogger("kube_gpu_stats_tpu_torch").removeHandler(tail)
    out["seconds"]["phase"] = time.monotonic() - t0
    out["over_soft_limit"] = out["seconds"]["phase"] > BENCH_SOFT_S
    out["budget_misses"] = sorted(
        f"{name}.{key}" for name, entry in out.items()
        if isinstance(entry, dict) and "budgets" in entry
        for key, row in entry["budgets"].items() if not row["budget_ok"])
    emit("bench", out)
    return launches


class FaultsStop(Exception):
    """Ends the faults phase's burn from its step hook."""


def phase_faults(card_line: str) -> int:
    """The survival layer on the card: the NVML daemon over
    ``testing.nvml_faults.NvmlFaults`` (the real binding, with faults
    scripted over it) in a process of its own with no torch, as the
    DaemonSet runs it, while this process burns card 0 with the ``cuda``
    kernel. ``python -m kube_gpu_stats_tpu_torch.testing.nvml_faults``
    runs ``run_scenarios``: card 0 lost for 5 ticks (down within 2 ticks
    with nothing of it served, up within 2 of the fault clearing, then
    duty and memory held as the daemon phase holds them); the driver gone
    until the ``nvml`` breaker opens, then back (the breaker's 2 in a
    scrape, the doctor's ``resilience`` row failing on ``nvml``, the
    probe's real ``nvmlShutdown`` closing the library and its
    ``nvmlInit_v2`` opening a fresh session under the burn, the card up
    and fresh within 2 ticks of it, joules monotone); a hung
    ``begin_tick`` respawned by the watchdog; a soak with card 0 flapping
    under scrapers. The driver is never unloaded (no root here, and an
    unload would end the burn's context): the library's answers are.
    Returns B1's launches."""
    t0 = time.monotonic()
    hook = StepCounter()
    stop = threading.Event()
    burn: dict = {}

    def record(n: int, *, seconds: float, flops: float) -> None:
        hook(n, seconds=seconds, flops=flops)
        if stop.is_set():
            raise FaultsStop

    def burner() -> None:
        try:
            run_burn(seconds=FAULTS_MAX_S, size=MAIN_SIZE,
                     report_every=1e9, kernel="cuda", device="cuda:0",
                     step_hook=record)
        except FaultsStop:
            torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 - failed below
            burn["error"] = repr(exc)

    cmd = [sys.executable, "-X", "faulthandler", "-m",
           "kube_gpu_stats_tpu_torch.testing.nvml_faults", "--card", "0",
           "--interval", str(FAULTS_INTERVAL_S), "--soak", str(FAULTS_SOAK_S),
           "--flap", str(FAULTS_FLAP_S), "--scrapers", str(FAULTS_SCRAPERS),
           "--duty-min", str(DUTY_MIN), "--mem-tol-mib", str(MEM_TOL_MIB)]
    tiled_burn.launches = 0
    thread = threading.Thread(target=burner, name="faults-burn",
                              daemon=True)
    thread.start()
    try:
        time.sleep(FAULTS_LEAD_S)
        child = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                               text=True, timeout=FAULTS_MAX_S)
    finally:
        stop.set()
        thread.join(timeout=60)
    launches = tiled_burn.launches
    idle_from = time.monotonic()
    while float(smi("utilization.gpu")[0][0]) > 0.0:
        require(time.monotonic() - idle_from < FAULTS_IDLE_S,
                f"card 0 not idle {FAULTS_IDLE_S} s after the faults burn")
        time.sleep(0.25)
    idle_s = time.monotonic() - idle_from
    lines = child.stdout.strip().splitlines()
    require(lines, f"the faults process printed nothing (exit "
                   f"{child.returncode}): {child.stderr[-1500:]}")
    result = json.loads(lines[-1])
    require(child.returncode == 0 and result.get("ok"),
            f"faults: {result.get('error')} (exit {child.returncode}); "
            f"{child.stderr[-1500:]}")
    require(not result["torch_loaded"], "the faults process loaded torch")
    require("error" not in burn, f"the faults burn: {burn.get('error')}")
    require(not thread.is_alive(), "the faults burn did not end")
    require(launches >= hook.steps > 0,
            f"{launches} launches for {hook.steps} burn steps")
    emit("faults", {
        "card": card_line, "interval_s": FAULTS_INTERVAL_S,
        "scenarios": result["scenarios"], "b1_launches": launches,
        "burn_steps": hook.steps, "daemon_seconds": result["seconds"],
        "idle_after_s": idle_s,
        "seconds": time.monotonic() - t0,
        "injected": "NVML's answers through testing.nvml_faults in the "
                    "daemon's own process; the driver stays loaded (no "
                    "unload, no GPU reset)"})
    return launches


def listener_probe() -> dict:
    """A short run of ``testing.listener_probe``: how this host's network
    stack answers a sender whose receiver's listener closes."""
    probe = subprocess.run(
        [sys.executable, "-m",
         "kube_gpu_stats_tpu_torch.testing.listener_probe",
         "--closed-seconds", "3", "--cycles", "10"],
        cwd=ROOT, capture_output=True, text=True, timeout=180)
    lines = probe.stdout.strip().splitlines()
    return json.loads(lines[-1]) if lines else {"stderr": probe.stderr[-800:]}


def phase_sims(card_line: str) -> int:
    """The hub and protocol sims on the card's host, the card idle: each
    of SIMS_PHASE at the reference's full parameters in a process of its
    own with no torch, as a hub runs on a CPU node. Each child must exit
    0 with the figures SIMS_EXACT gives; the cardinality child's RSS
    must grow less than SIMS_RSS_PIN_MB. A failed child is reported with
    a short ``listener_probe`` run beside it (the card machine can hang a
    connection made as a listener closes). Launches no kernel."""
    t0 = time.monotonic()
    out: dict = {"card": card_line, "gpu_util_pct": [],
                 "sims": {}, "seconds": {}}
    out["gpu_util_pct"].append(float(smi("utilization.gpu")[0][0]))
    for name in SIMS_PHASE:
        start = time.monotonic()
        child = subprocess.run(
            [sys.executable, "-X", "faulthandler", "-m",
             "kube_gpu_stats_tpu_torch.sims", name],
            cwd=ROOT, capture_output=True, text=True, timeout=SIMS_MAX_S)
        out["seconds"][name] = time.monotonic() - start
        lines = child.stdout.strip().splitlines()
        report = None
        try:
            report = json.loads(lines[-1])
        except (IndexError, ValueError):
            pass
        sim = (report or {}).get("sims", {}).get(name, {})
        if child.returncode != 0 or not sim.get("ok"):
            emit("sims_failed", {"sim": name, "exit": child.returncode,
                                 "stdout": child.stdout[-4000:],
                                 "stderr": child.stderr[-2000:],
                                 "listener_probe": listener_probe()})
        require(child.returncode == 0 and sim.get("ok"),
                f"sims {name}: exit {child.returncode}: "
                f"{child.stdout[-1500:]} {child.stderr[-800:]}")
        require(report["torch_loaded"] is False,
                f"the {name} sim's process loaded torch")
        figures = sim["figures"]
        wrong = {key: (figures.get(key), want)
                 for key, want in SIMS_EXACT[name].items()
                 if figures.get(key) != want}
        require(not wrong, f"sims {name}: (got, want) {wrong}")
        out["sims"][name] = {"figures": figures, "timings": sim["timings"],
                             "seconds": out["seconds"][name]}
    out["gpu_util_pct"].append(float(smi("utilization.gpu")[0][0]))
    query = out["sims"]["query"]
    require(min(query["figures"]["ratio_304"].values()) >= SIMS_RATIO_FLOOR,
            f"query 304 ratios {query['figures']['ratio_304']}")
    rss = out["sims"]["cardinality"]["timings"]["rss_growth_mb"]
    require(rss < SIMS_RSS_PIN_MB,
            f"cardinality RSS grew {rss:.1f} MB (pin {SIMS_RSS_PIN_MB})")
    partition = out["sims"]["partition"]["timings"]
    skew = out["sims"]["skew"]["timings"]
    qt = query["timings"]
    out["reported"] = {
        "query_p50_ms": qt["p50_ms"], "query_p50_pin_ms": qt["p50_pin_ms"],
        "query_p99_ms": qt["p99_ms"], "query_p99_pin_ms": qt["p99_pin_ms"],
        "query_pins_met": qt["pins_met"], "query_shed_429": qt["shed_429"],
        "cardinality_rss_growth_mb": rss,
        "cardinality_rss_pin_mb": SIMS_RSS_PIN_MB,
        "cardinality_rss_source": out["sims"]["cardinality"]["timings"][
            "rss_source"],
        "partition_drain_per_s": partition["drain.drain_per_s"],
        "partition_drain_cap_per_s": SIMS_EXACT["partition"][
            "drain.rate_cap"],
        "skew_hub_upgrade_resumed": skew["hub-upgrade.resumed"],
        "skew_hub_upgrade_replayed": skew["hub-upgrade.replayed"],
        "skew_hub_upgrade_fulls": skew["hub-upgrade.upgrade_fulls"],
        "skew_key_change_fulls": {
            "matrix": skew["matrix.churn_fulls"],
            "prenegotiation": skew["prenegotiation.churn_fulls"],
            "hub-upgrade": skew["hub-upgrade.churn_fulls"]}}
    out["seconds"]["phase"] = time.monotonic() - t0
    out["over_soft_limit"] = out["seconds"]["phase"] > SIMS_SOFT_S
    out["smoke_seconds"] = time.monotonic() - STARTED
    emit("sims", out)
    return 0


def _operator_alarm(signum, frame) -> None:
    raise TimeoutError(f"operator: over its {OPERATOR_LIMIT_S} s limit")


def run_step(cmd: list, cwd: pathlib.Path, env: dict, what: str
             ) -> subprocess.CompletedProcess:
    proc = subprocess.run([str(part) for part in cmd], cwd=cwd, env=env,
                          capture_output=True, text=True,
                          timeout=OPERATOR_STEP_S)
    require(proc.returncode == 0, f"{what}: exit {proc.returncode}: "
                                  f"{proc.stdout[-1500:]} "
                                  f"{proc.stderr[-1500:]}")
    return proc


def exposition_families(text: str) -> set[str]:
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def phase_operator(card_line: str) -> int:
    """The operator surface on the card's host, under its own SIGALRM
    limit of OPERATOR_LIMIT_S: the project's wheel built from this
    checkout and installed into a venv, as the reference's ``make ci``
    does; the venv's console script serving the NVML daemon (host fast
    paths on) and the hub over it; every family the port's alert rules,
    recording rules and board name served by one of them or listed in
    ``deploy/assets.CONDITIONAL``; ``helm template`` of the chart where
    ``helm`` exists. Launches no kernel."""
    t0 = time.monotonic()
    previous = signal.signal(signal.SIGALRM, _operator_alarm)
    signal.alarm(OPERATOR_LIMIT_S)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="kts-operator-"))
    procs: list[subprocess.Popen] = []
    try:
        out = _operator(card_line, tmp, procs)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"]["phase"] = time.monotonic() - t0
    out["smoke_seconds"] = time.monotonic() - STARTED
    emit("operator", out)
    return 0


def _operator(card_line: str, tmp: pathlib.Path,
              procs: list[subprocess.Popen]) -> dict:
    # Nothing of the checkout on the path: what runs is the wheel's.
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONFAULTHANDLER"] = "1"
    seconds: dict[str, float] = {}
    src = tmp / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(ROOT / name, src / name)
    for package in ("kube_gpu_stats_tpu", "kube_gpu_stats_tpu_torch"):
        shutil.copytree(ROOT / package, src / package,
                        ignore=shutil.ignore_patterns("__pycache__"))
    tree_libraries = sorted(str(p.relative_to(src))
                            for p in src.rglob("*.so"))
    start = time.monotonic()
    run_step([sys.executable, "-m", "pip", "wheel", "--no-deps",
              "--no-build-isolation", "--no-index", "-w", tmp / "dist",
              "."], src, env, "pip wheel")
    seconds["wheel_build"] = time.monotonic() - start
    (wheel,) = (tmp / "dist").glob("*.whl")
    with zipfile.ZipFile(wheel) as archive:
        names = archive.namelist()
        entry_points = next(archive.read(n).decode() for n in names
                            if n.endswith(".dist-info/entry_points.txt"))
    for shipped in ("kube_gpu_stats_tpu_torch/native/wirefast.cc",
                    "kube_gpu_stats_tpu_torch/csrc/tiled_gemm.cu"):
        require(shipped in names, f"the wheel lacks {shipped}")
    wheel_libraries = [n for n in names if n.endswith(".so")]
    require(not wheel_libraries,
            f"the wheel carries built libraries: {wheel_libraries}")
    require(f"{OPERATOR_SCRIPT} = kube_gpu_stats_tpu_torch.cli:main"
            in entry_points, f"entry points: {entry_points}")
    venv = tmp / "venv"
    start = time.monotonic()
    run_step([sys.executable, "-m", "venv", "--system-site-packages", venv],
             tmp, env, "venv")
    run_step([venv / "bin" / "pip", "install", "--no-index", "--no-deps",
              wheel], tmp, env, "pip install")
    seconds["venv_install"] = time.monotonic() - start
    package = run_step(
        [venv / "bin" / "python", "-I", "-c",
         "import kube_gpu_stats_tpu_torch as m; print(m.__file__)"],
        tmp, env, "import from the venv").stdout.strip()
    require(pathlib.Path(package).is_relative_to(venv),
            f"the venv resolved another copy: {package}")
    script = venv / "bin" / OPERATOR_SCRIPT
    require(script.is_file(), f"no console script {script}")

    start = time.monotonic()
    port = free_port()
    daemon, bound, dlog = start_logged(
        [str(script), "--backend", "nvml", "--listen-host", "127.0.0.1",
         "--listen-port", str(port), "--interval",
         str(OPERATOR_DAEMON_INTERVAL_S), "--attribution", "off"],
        r"listening on \S+:(\d+)", "the daemon", cwd=tmp, env=env,
        limit_s=OPERATOR_STEP_S)
    procs.append(daemon)
    require(bound == port, f"the daemon bound {bound}, asked {port}")
    first, series = fresh_scrape(port, 0)
    seconds["daemon_first_scrape"] = time.monotonic() - start
    smi_cards = len(subprocess.run(
        ["nvidia-smi", "-L"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines())
    up = per_card(series, schema.DEVICE_UP.name)
    require(len(up) == smi_cards and set(up.values()) == {1.0},
            f"served cards {up}, nvidia-smi -L {smi_cards}")
    require(one(series, schema.SELF_DEVICES.name) == smi_cards,
            "collector_devices != nvidia-smi -L")
    require(scrape(port, "/healthz").startswith("ok\n"), "daemon /healthz")
    doctor = run_step(
        [script, "doctor", "--backend", "nvml", "--attribution", "off",
         "--json", "--url", f"http://127.0.0.1:{port}/metrics"],
        tmp, env, "doctor")
    rows = {row["name"]: row for row in json.loads(doctor.stdout)["checks"]}
    library = rows["native"].get("data", {}).get("library", "")
    require(rows["native"]["status"] == "ok" and
            pathlib.Path(library).is_relative_to(venv),
            f"the doctor's native row: {rows['native']}")

    targets = tmp / "targets.txt"
    targets.write_text(f"http://127.0.0.1:{port}/metrics\n")
    start = time.monotonic()
    hub, hub_port, hlog = start_logged(
        [str(script), "hub", "--listen-host", "127.0.0.1", "--listen-port",
         str(free_port()), "--interval", "1", "--targets-file",
         str(targets), "--expect-workers", "1", "--ingest-checkpoint",
         str(tmp / "ingest.ckpt")],
        r"hub serving .* on \S+:(\d+)", "the hub", cwd=tmp, env=env,
        limit_s=OPERATOR_STEP_S)
    procs.append(hub)
    refreshes = schema.HUB_REFRESH_DURATION.name + "_count"
    while True:
        hub_body = scrape(hub_port)
        hub_series = validate.parse_exposition(hub_body)
        done = sum(v for f, _, v in hub_series if f == refreshes)
        if done >= OPERATOR_HUB_REFRESHES:
            break
        require(hub.poll() is None, f"the hub exited: {hlog[-40:]}")
        time.sleep(0.2)
    seconds["hub_refreshes"] = time.monotonic() - start
    target_up = [v for f, _, v in hub_series
                 if f == schema.HUB_TARGET_UP.name]
    require(target_up == [1.0], f"slice_target_up {target_up}")
    second = scrape(port)  # after scrapes: the render families too

    served = (exposition_families(first) | exposition_families(second)
              | exposition_families(hub_body))
    named = set().union(*assets.named_families().values())
    conditional = sorted((named - served) & set(assets.CONDITIONAL))
    missing = sorted(named - served - set(assets.CONDITIONAL))
    require(not missing, f"families the assets name that neither the "
                         f"daemon nor the hub served: {missing}")

    helm = shutil.which("helm")
    if helm:
        chart = ROOT / "kube_gpu_stats_tpu_torch/deploy/helm/kube-tpu-stats-h100"
        for extra in ([], ["--set", "hub.enabled=true"]):
            run_step([helm, "template", "kts", chart, *extra], tmp, env,
                     "helm template")
        helm_result = "rendered"
    else:
        print("helm: absent", flush=True)
        helm_result = "absent"
    for proc, log, what in ((hub, hlog, "hub"), (daemon, dlog, "daemon")):
        rc, _ = stop_with_stacks(proc, log)
        require(rc == 0, f"the {what} exited {rc}: {log[-40:]}")
    return {"card": card_line, "seconds": seconds,
            "wheel": wheel.name, "wheel_files": len(names),
            "wheel_libraries": len(wheel_libraries),
            "tree_libraries": tree_libraries, "package": package,
            "native_library": library, "cards": smi_cards,
            "served_families": len(served),
            "daemon_families": len(exposition_families(second)),
            "hub_families": len(exposition_families(hub_body)),
            "named_families": len(named),
            "named_served": len(named & served),
            "named_conditional": len(conditional),
            "named_missing": len(missing),
            "conditional": conditional, "helm": helm_result}


def library_call():
    """The yardstick: one PyTorch call computing the same function. Returns
    (name, fn(a, b))."""
    probe = torch.zeros((128, 128), dtype=torch.bfloat16, device="cuda")
    try:
        torch.mm(probe, probe, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return "torch.matmul (bf16 out)", torch.matmul
    return ("torch.mm(out_dtype=float32)",
            lambda a, b: torch.mm(a, b, out_dtype=torch.float32))


def bound(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time (ms) the card could take, and what bounds it."""
    name = torch.cuda.get_device_name(0)
    peak = _kind_peak_flops(name)
    rate = _kind_lookup(HBM_BYTES_PER_S, name)
    require(peak is not None and rate is not None,
            f"no datasheet peak for {name}")
    ops_ms = 2 * m * n * k / peak * 1e3
    bytes_ms = (2 * (m * k + k * n) + 4 * m * n) / rate * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_timing(card: str) -> dict:
    library_name, library_fn = library_call()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    at_main = None
    for size in SWEEP_SIZES:
        a = randn_bf16((size, size), 100)
        b = randn_bf16((size, size), 101)
        kernel = time_ms(lambda: tiled_matmul(a, b))
        plain = time_ms(lambda: tiled_matmul_reference(a, b))
        library = time_ms(lambda: library_fn(a, b))
        bound_ms, bound_by = bound(size, size, size)
        block_n, grid = tiled_burn.gemm_plan(size, size, sms)
        row = {"size": size, "ms": kernel["ms"], "plain_ms": plain["ms"],
               "library_ms": library["ms"], "library": library_name,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "tflops_per_s": 2 * size**3 / kernel["ms"] / 1e9,
               "bound_share": bound_ms / kernel["ms"],
               "block_n": block_n, "grid": grid,
               "spread": {"kernel": kernel, "plain": plain,
                          "library": library},
               "card": card}
        emit("timing", row)
        if size == MAIN_SIZE:
            at_main = row
        del a, b
    return at_main


# prctl(2): orphaned descendants are re-parented to this process.
PR_SET_CHILD_SUBREAPER = 36
STOP_GRACE_S = 5.0


def adopt_orphans() -> None:
    """Make this process the reaper of its descendants' orphans, so that
    ``stop_children`` sees every process the run started, however deep."""
    libc = ctypes.CDLL(None, use_errno=True)
    require(libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) == 0,
            f"prctl(PR_SET_CHILD_SUBREAPER): errno {ctypes.get_errno()}")


def stop_children() -> list[str]:
    """Stop multiprocessing's resource tracker, reap every child that has
    exited, and stop (SIGTERM, then SIGKILL) and reap every one still
    running. Returns the live ones' pid and command line."""
    stop_resource_tracker()
    live, me = [], os.getpid()
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            fields = pathlib.Path(f"/proc/{entry}/stat").read_text(
                ).rsplit(")", 1)[1].split()
            cmd = pathlib.Path(f"/proc/{entry}/cmdline").read_bytes(
                ).replace(b"\0", b" ").decode(errors="replace")
        except OSError:  # it ended meanwhile
            continue
        if int(fields[1]) != me:
            continue
        pid = int(entry)
        if fields[0] != "Z":
            live.append(f"{pid}: {cmd}")
            os.kill(pid, signal.SIGTERM)
        deadline = time.monotonic() + STOP_GRACE_S
        while os.waitpid(pid, os.WNOHANG) == (0, 0):
            if time.monotonic() > deadline:
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
                break
            time.sleep(0.05)
    return live


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    adopt_orphans()
    alone = None
    try:
        if argv:
            alone = phases_alone(argv)
        else:
            phases()
    finally:
        live = stop_children()
    require(not live, f"processes still running after the last phase: "
                      f"{live}")
    if alone is not None:
        return alone
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phases() -> None:
    card = phase_card()
    phase_build()
    phase_native(card)
    max_abs_err = phase_correctness()
    launches, cuda_steps_per_s = phase_main_path()
    phase_trace()
    phase_entry()
    phase_multichip(card)
    embedded_launches, embedded_paths = phase_embedded(card, cuda_steps_per_s)
    launches += embedded_launches
    launches += phase_daemon(card, embedded_paths)
    launches += phase_doctor(card)
    c5_launches, c5_tick_ms = phase_c5(card)
    launches += c5_launches
    launches += phase_burst(card)
    launches += phase_energy(card, c5_tick_ms)
    launches += phase_egress(card, c5_tick_ms)
    launches += phase_hub(card, c5_tick_ms, cuda_steps_per_s)
    launches += phase_fleet(card)
    launches += phase_faults(card)
    launches += phase_bench(card)
    launches += phase_sims(card)
    launches += phase_operator(card)
    t = phase_timing(card)
    emit("kernels", [{
        "name": KERNEL_NAME, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_abs_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "design": KERNEL_DESIGN,
        "bound_share": t["bound_share"]}])


ALONE = {
    "daemon": lambda card: phase_daemon(card, {}),
    "native": phase_native,
    "doctor": phase_doctor,
    "c5": phase_c5,
    "burst": phase_burst,
    "energy": lambda card: phase_energy(card, {}),
    "egress": lambda card: phase_egress(card, {}),
    "hub": lambda card: phase_hub(card, {}, 0.0),
    "fleet": phase_fleet,
    "faults": phase_faults,
    "bench": phase_bench,
    "sims": phase_sims,
    "operator": phase_operator,
}


def phases_alone(specs: list[str]) -> int:
    """Each ``name[:times]`` phase run that many times after the card and
    build phases; exit code 1 when any run failed."""
    runs = []
    for spec in specs:
        name, _, times = spec.partition(":")
        require(name in ALONE, f"no phase {name!r} runs alone: "
                               f"{sorted(ALONE)}")
        runs += [name] * int(times or 1)
    card = phase_card()
    phase_build()
    outcomes = []
    for name in runs:
        t0 = time.monotonic()
        try:
            ALONE[name](card)
            outcome = "ok"
        except Exception as exc:  # noqa: BLE001 - reported, then counted
            outcome = repr(exc)[:300]
        outcomes.append({"phase": name, "outcome": outcome,
                         "seconds": time.monotonic() - t0})
        print(f"{name}: {outcome}", file=sys.stderr, flush=True)
    emit("phases_alone", outcomes)
    return int(any(o["outcome"] != "ok" for o in outcomes))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
