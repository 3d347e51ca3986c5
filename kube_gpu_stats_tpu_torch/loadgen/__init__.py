"""GPU load generator — validation workload for the telemetry exporter.

A workload that drives the H100's tensor cores (bf16 matmuls) on every
local card, so the accelerator metrics visibly respond:

    python -m kube_gpu_stats_tpu_torch.loadgen --kernel cuda --size 4096

``--embedded-port 0`` serves the embedded exporter while it burns;
``--mode ici`` rotates an NVLink ring over one rank per card instead
(``ici_burn.py``). The port of ``kube_gpu_stats_tpu.loadgen``: the
matmul burn, the ring, and the sharded train step
(``burn.make_sharded_train_step`` over ``mesh.py``'s ranks).
"""

from .burn import entry_fn, run_burn  # noqa: F401
