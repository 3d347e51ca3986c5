"""Whole-system fault sims over the port's daemons and hubs.

The port of the reference's ``tools/*_sim.py`` that drive a device
backend: real daemons over ``testing.fake_nvml``, real hubs and real
HTTP under injected faults. ``python -m kube_gpu_stats_tpu_torch.sims
<name>`` runs one (``--help`` lists its options); ``all`` runs every
one in the reference's ``make ci`` order. Each exits 0 with a PASS line,
else 1 with the problems, and prints the figures its scenario fixes and
the host timings it measured, then, as its last line, one JSON object:
each sim's ``ok``, ``figures`` and ``timings``, and ``torch_loaded``.
They run on the CPU: host code over fakes.
"""

# In the order of the reference's `make ci` (its Makefile's `tools/*_sim.py`
# lines).
SIMS = ("fleet", "federation", "energy", "host", "chaos", "partition",
        "skew", "localfault", "cardinality", "query")
