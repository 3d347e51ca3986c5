"""The tiled GEMM kernel on the card (sm_90a) against its plain version,
the embedded collector's memory and MFU on the card, and the NVML binding
and backend on the card: the binding's constants and struct layouts
against the toolkit's ``nvml.h``, discovery against ``nvidia-smi``, one
sample within the ranges of the smoke test.

Marked ``cuda``: these skip without a compute-capability-9.0 card. On
one, run them with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
This file imports no JAX, so it also runs where JAX is not installed.
"""

import ctypes
import json
import os
import pathlib
import shutil
import stat
import subprocess

import pytest
import torch

from kube_gpu_stats_tpu_torch.device import is_hopper
from kube_gpu_stats_tpu_torch.loadgen import tiled_burn

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch.cuda.is_available() is False")
    if not is_hopper("cuda"):
        pytest.skip("needs compute capability 9.0 (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, device):
    gen = torch.Generator(device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.bfloat16)


def _assert_matches_plain(got, a, b):
    want = tiled_burn.tiled_matmul_reference(a, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    # Same exact bf16 products, f32 sums in another order.
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("m,k,n,tiles", [
    (256, 512, 384, dict(tile_m=128, tile_n=128, tile_k=128)),
    (128, 1024, 128, dict(tile_m=128, tile_n=128, tile_k=256)),
    (384, 384, 384, {}),      # the 128-wide instance
    (1024, 2048, 512, {}),
    (128, 128, 128, {}),      # K shorter than the ring
    # 9 x 10 tiles of 128 x 128 on a partial wave; 10 K stages, not a
    # multiple of the ring's 6
    (1152, 640, 1280, {}),
    # 512 wide tiles on 132 blocks: the ring's barrier phases carry on
    # across the tiles of a block
    (4096, 4096, 4096, {}),
])
def test_kernel_matches_plain_version(card, m, k, n, tiles):
    a = _randn((m, k), 0, card)
    b = _randn((k, n), 1, card)
    before = tiled_burn.launches
    got = tiled_burn.tiled_matmul(a, b, **tiles)
    assert tiled_burn.launches == before + 1
    _assert_matches_plain(got, a, b)


def test_back_to_back_launches_on_new_inputs(card):
    pairs = [(_randn((2048, 1024), 2 + i, card),
              _randn((1024, 1536), 4 + i, card)) for i in range(2)]
    outs = [tiled_burn.tiled_matmul(a, b) for a, b in pairs]
    for (a, b), got in zip(pairs, outs):
        _assert_matches_plain(got, a, b)


def test_plan_mirror_matches_the_kernel(card):
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for m, n in [(128, 128), (384, 384), (1024, 1024), (1152, 1280),
                 (2048, 1536), (4096, 4096), (8192, 8192)]:
        assert tiled_burn.kernel_plan(m, n, sms) == tiled_burn.gemm_plan(
            m, n, sms)


def test_kernel_rejects_what_it_cannot_take(card):
    a = torch.zeros((256, 256), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        tiled_burn.tiled_matmul(a.t()[:128], a[:, :128].contiguous())
    with pytest.raises(TypeError, match="bf16"):
        tiled_burn.tiled_matmul(a.float(), a.float())
    with pytest.raises(ValueError, match="one CUDA device"):
        tiled_burn.tiled_matmul(a, a.cpu())


def test_burn_step_on_the_card(card):
    step, xs, ws, n, flops = tiled_burn.tiled_all_device_burn(512, card)
    assert n == 1 and flops == 2 * 512**3
    out = step(xs, ws)
    torch.cuda.synchronize()
    want = torch.tanh(tiled_burn.tiled_matmul_reference(xs[0], ws[0]))
    assert out[0].dtype == torch.bfloat16
    assert (out[0].float() - want).abs().max().item() <= 1e-2


class _Clock:
    """Stands in for the ``time`` module inside embedded.py."""

    now = 10.0

    def monotonic(self):
        return self.now

    def perf_counter(self):
        return self.now


def test_embedded_collector_reports_card_memory(card):
    from kube_gpu_stats_tpu_torch import embedded, schema

    col = embedded.TorchIntrospectCollector("cuda:0")
    (dev,) = col.discover()
    assert dev.accel_type == "gpu-h100"
    # The minor number's file (NVML is there on the card's machine).
    assert dev.device_path.startswith("/dev/nvidia")
    assert stat.S_ISCHR(os.stat(dev.device_path).st_mode)
    held = torch.empty(256 << 20, dtype=torch.uint8, device="cuda:0")
    col.begin_tick()
    values = col.sample(dev).values
    used = values[schema.MEMORY_USED.name]
    total = values[schema.MEMORY_TOTAL.name]
    assert used >= held.numel()
    assert used <= total == torch.cuda.mem_get_info(0)[1]
    assert values[schema.MEMORY_PEAK.name] >= used
    del held


def test_embedded_collector_mfu_against_the_h100_peak(card, monkeypatch):
    from kube_gpu_stats_tpu_torch import embedded, schema

    clock = _Clock()
    monkeypatch.setattr(embedded, "time", clock)
    col = embedded.TorchIntrospectCollector("cuda:0")
    (dev,) = col.discover()
    col.record_step(1, seconds=0.5, flops=1e12)
    col.begin_tick()
    clock.now += 2.0
    col.record_step(1, seconds=0.5, flops=989e12)
    col.begin_tick()
    values = col.sample(dev).values
    assert values[schema.PEAK_FLOPS.name] == 989e12
    # 989e12 FLOPs over a 2 s window on one card: 50% of the peak.
    assert values[schema.WORKLOAD_MFU.name] == pytest.approx(50.0, rel=1e-12)


# -- NVML ----------------------------------------------------------------------

# The binding's constants, by their nvml.h names.
_NVML_CONSTANTS = (
    "NVML_SUCCESS", "NVML_ERROR_UNINITIALIZED", "NVML_ERROR_NOT_SUPPORTED",
    "NVML_ERROR_DRIVER_NOT_LOADED", "NVML_ERROR_LIBRARY_NOT_FOUND",
    "NVML_ERROR_FUNCTION_NOT_FOUND", "NVML_ERROR_GPU_IS_LOST",
    "NVML_ERROR_UNKNOWN", "NVML_TEMPERATURE_GPU",
    "NVML_DEVICE_UUID_V2_BUFFER_SIZE", "NVML_DEVICE_NAME_V2_BUFFER_SIZE",
    "NVML_SYSTEM_DRIVER_VERSION_BUFFER_SIZE",
    "NVML_FI_DEV_NVLINK_LINK_COUNT", "NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_TX",
    "NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_RX", "NVML_FI_DEV_POWER_INSTANT",
    "NVML_VALUE_TYPE_DOUBLE",
    "NVML_VALUE_TYPE_UNSIGNED_INT", "NVML_VALUE_TYPE_UNSIGNED_LONG",
    "NVML_VALUE_TYPE_UNSIGNED_LONG_LONG", "NVML_VALUE_TYPE_SIGNED_LONG_LONG",
    "NVML_VALUE_TYPE_SIGNED_INT", "NVML_GPM_SUPPORT_VERSION",
    "NVML_GPM_METRICS_GET_VERSION", "NVML_GPM_METRIC_ANY_TENSOR_UTIL",
    "NVML_GPM_METRIC_DRAM_BW_UTIL", "NVML_GPM_METRIC_MAX",
)
# Binding constants whose nvml.h spelling is another name or a macro.
_NVML_EXPRESSIONS = {"NVML_MEMORY_V2_VERSION": "nvmlMemory_v2"}
# Bound calls, by the C function-pointer type the binding's argtypes and
# restype spell; the probe fails to compile where nvml.h declares another.
_NVML_PROTOTYPES = {
    "nvmlSystemGetDriverVersion": "nvmlReturn_t (*)(char *, unsigned int)",
    "nvmlSystemGetCudaDriverVersion_v2": "nvmlReturn_t (*)(int *)",
}


def _nvml_structs():
    from kube_gpu_stats_tpu_torch.native import nvml as binding

    return {"nvmlUtilization_t": binding.NvmlUtilization,
            "nvmlMemory_v2_t": binding.NvmlMemoryV2,
            "nvmlValue_t": binding.NvmlValue,
            "nvmlFieldValue_t": binding.NvmlFieldValue,
            "nvmlGpmSupport_t": binding.NvmlGpmSupport,
            "nvmlGpmMetric_t": binding.NvmlGpmMetric,
            "nvmlGpmMetricsGet_t": binding.NvmlGpmMetricsGet}


def _nvml_header() -> pathlib.Path:
    roots = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in filter(None, roots):
        for sub in ("include", "targets/x86_64-linux/include"):
            path = pathlib.Path(root) / sub / "nvml.h"
            if path.exists():
                return path
    raise AssertionError(f"no nvml.h under {roots}")


def test_nvml_binding_matches_the_header(card, tmp_path):
    """Compiles a probe against the toolkit's nvml.h and holds every
    constant, struct size and member offset of the binding against it,
    and the prototypes of the calls in _NVML_PROTOTYPES."""
    from kube_gpu_stats_tpu_torch.native import nvml as binding

    header = _nvml_header()
    lines = ["#include <stdio.h>", "#include <stddef.h>", "#include <nvml.h>"]
    for fn, pointer in _NVML_PROTOTYPES.items():
        # __typeof__ does not evaluate: no link against libnvidia-ml.
        lines.append(f"_Static_assert(__builtin_types_compatible_p("
                     f'__typeof__(&{fn}), {pointer}), "{fn}");')
    lines += ["int main(void) {", 'printf("{");']
    constants = {name: name for name in _NVML_CONSTANTS}
    constants.update(_NVML_EXPRESSIONS)
    for name, expr in constants.items():
        lines.append(f'printf("\\"{name}\\": %lld, ", (long long)({expr}));')
    for ctype, cls in _nvml_structs().items():
        lines.append(f'printf("\\"sizeof {ctype}\\": %zu, ", '
                     f"sizeof({ctype}));")
        for member, _ in cls._fields_:
            lines.append(f'printf("\\"{ctype}.{member}\\": %zu, ", '
                         f"offsetof({ctype}, {member}));")
    lines += ['printf("\\"end\\": 0}\\n");', "return 0; }"]
    source = tmp_path / "probe.c"
    source.write_text("\n".join(lines))
    compiler = shutil.which("cc") or shutil.which("gcc")
    cmd = ([compiler] if compiler else
           [shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc", "-x", "c"])
    exe = tmp_path / "probe"
    subprocess.run(cmd + [f"-I{header.parent}", str(source), "-o", str(exe)],
                   check=True, capture_output=True, timeout=300)
    got = json.loads(subprocess.run([str(exe)], check=True,
                                    capture_output=True, text=True,
                                    timeout=60).stdout)
    for name in constants:
        assert getattr(binding, name) == got[name], name
    for ctype, cls in _nvml_structs().items():
        assert ctypes.sizeof(cls) == got[f"sizeof {ctype}"], ctype
        for member, _ in cls._fields_:
            assert getattr(cls, member).offset == got[f"{ctype}.{member}"], \
                f"{ctype}.{member}"


def _smi(fields: str) -> list[list[str]]:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                          "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    return [[c.strip() for c in line.split(",")]
            for line in out.strip().splitlines()]


def test_nvml_discovery_matches_nvidia_smi(card):
    from kube_gpu_stats_tpu_torch.collectors.nvml import NvmlCollector

    collector = NvmlCollector()
    try:
        devices = collector.discover()
    finally:
        collector.close()
    rows = _smi("index,uuid,name")
    assert [(d.index, d.uuid) for d in devices] == \
        [(int(r[0]), r[1]) for r in rows]
    for dev, row in zip(devices, rows):
        assert dev.device_path.startswith("/dev/nvidia")
        assert dev.accel_type == ("gpu-h100" if "H100" in row[2]
                                  else dev.accel_type)
    assert "GPU-" + str(torch.cuda.get_device_properties(0).uuid) in \
        {d.uuid for d in devices}


def test_nvml_sample_within_the_smoke_ranges(card):
    import time

    from kube_gpu_stats_tpu_torch import schema
    from kube_gpu_stats_tpu_torch.collectors.nvml import NvmlCollector

    held = torch.empty(256 << 20, dtype=torch.uint8, device="cuda:0")
    uuid = "GPU-" + str(torch.cuda.get_device_properties(0).uuid)
    limits = {r[0]: (float(r[1]), float(r[2]))
              for r in _smi("uuid,memory.total,power.limit")}
    collector = NvmlCollector()
    try:
        (dev,) = [d for d in collector.discover() if d.uuid == uuid]
        collector.sample(dev)
        # GPM needs two samples over 100 ms apart.
        time.sleep(0.3)
        values = collector.sample(dev).values
        smi_used_mib = float({r[0]: r[1] for r in
                              _smi("uuid,memory.used")}[uuid])
        state = collector.gpm_state[dev.device_id]
    finally:
        collector.close()
    total_mib, limit_w = limits[uuid]
    assert 0 <= values[schema.DUTY_CYCLE.name] <= 100
    assert 0 <= values[schema.MEMORY_BANDWIDTH_UTIL.name] <= 100
    assert (schema.TENSORCORE_UTIL.name in values) == (state == "on")
    used = values[schema.MEMORY_USED.name]
    total = values[schema.MEMORY_TOTAL.name]
    assert torch.cuda.memory_reserved(0) <= used <= total
    # v2's used leaves the driver's reservation out, as nvidia-smi does.
    assert abs(used - smi_used_mib * 1024**2) <= 32 * 1024**2
    assert abs(total - total_mib * 1024**2) <= 1024**2
    assert 0 < values[schema.POWER.name] <= limit_w
    assert 20 <= values[schema.TEMPERATURE.name] <= 100
    del held


def test_nvml_read_burst_gives_a_plausible_wattage(card):
    """One read of the instantaneous power field on card 0: a positive
    wattage within reach of the card's power limit; or, on a card that
    refuses the field, None with NVML's answer recorded."""
    from kube_gpu_stats_tpu_torch.collectors.nvml import NvmlCollector

    uuid = "GPU-" + str(torch.cuda.get_device_properties(0).uuid)
    limit_w = {r[0]: float(r[1]) for r in _smi("uuid,power.limit")}[uuid]
    collector = NvmlCollector()
    try:
        (dev,) = [d for d in collector.discover() if d.uuid == uuid]
        watts = collector.read_burst(dev)
        state = collector.burst_state.get(dev.device_id)
    finally:
        collector.close()
    if watts is None:
        assert "Not Supported" in state
        return
    assert 0 < watts <= 1.5 * limit_w
    assert state is None


def test_embedded_device_path_is_the_daemons(card):
    from kube_gpu_stats_tpu_torch import embedded
    from kube_gpu_stats_tpu_torch.collectors.nvml import NvmlCollector

    collector = NvmlCollector()
    try:
        daemon = {d.uuid: d.device_path for d in collector.discover()}
    finally:
        collector.close()
    col = embedded.TorchIntrospectCollector()
    for dev in col.discover():
        uuid = embedded.cuda_uuid(torch.device("cuda", dev.index))
        assert dev.device_path == daemon[uuid]


def test_one_rank_nccl_step_and_ring_match_the_cpu(card):
    import numpy as np

    from kube_gpu_stats_tpu_torch.loadgen.mesh import run_ranks
    from kube_gpu_stats_tpu_torch.testing import ranks

    [on_card] = run_ranks(ranks.train_step, 1, device="cuda",
                          args=("cuda",), timeout=300)
    [on_cpu] = run_ranks(ranks.train_step, 1, device="cpu",
                         args=("cpu",), timeout=300)
    for key in ("w1", "w2", "x"):
        np.testing.assert_array_equal(on_card[key], on_cpu[key])
    for key in ("new_w1", "new_w2"):
        np.testing.assert_allclose(on_card[key], on_cpu[key], rtol=1e-5,
                                   atol=1e-6)
    assert on_card["loss"] == pytest.approx(on_cpu["loss"], rel=1e-5)
    [(before, after)] = run_ranks(ranks.ring, 1, device="cuda",
                                  args=("cuda", 1.0, 3), timeout=300)
    np.testing.assert_array_equal(after, before + 3)
