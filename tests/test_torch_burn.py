"""The port's burn (kube_gpu_stats_tpu_torch.loadgen.burn) against the JAX
package's, on the CPU: the chain's numerics on the same inputs, the FLOP
and step-hook contracts, result keys, sweep rows, and that the entry
points refuse to run without CUDA unless asked for the CPU."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kube_gpu_stats_tpu.loadgen import burn as jax_burn  # noqa: E402
from kube_gpu_stats_tpu_torch import entry, kinds  # noqa: E402
from kube_gpu_stats_tpu_torch.convert import from_jax_arrays  # noqa: E402
from kube_gpu_stats_tpu_torch.loadgen import burn  # noqa: E402

RESULT_KEYS = {"steps_per_s", "tflops_per_s", "devices", "size", "depth"}


class Hook:
    def __init__(self):
        self.steps = 0
        self.flops = 0.0
        self.calls = 0

    def __call__(self, n, *, seconds, flops):
        assert seconds >= 0
        self.calls += 1
        self.steps += n
        self.flops += flops


def test_matmul_chain_matches_jax():
    fn, (x, w) = jax_burn.entry_fn(size=256, depth=4)
    x_np, w_np = np.asarray(x), np.asarray(w)
    want = np.asarray(jax.jit(jax_burn._matmul_chain(4))(x, w)
                      .astype(jnp.float32))
    blocks, w_t = from_jax_arrays(x_np, w_np, "cpu")
    got = burn._matmul_chain(4)(blocks[0], w_t)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    # Both round acc @ w to bf16 at each of the 4 steps, at places that
    # differ: about 3 bf16 ulps at |y| near 1 at worst, tiny on average.
    assert diff.max() <= 2.5e-2
    assert diff.mean() < 1e-4


@pytest.mark.parametrize("depth", [1, 4, 16])
def test_flops_per_step_matches_jax(depth):
    _, _, _, jax_n, jax_flops = jax_burn.make_all_device_burn(128, depth)
    step, x_blocks, w_blocks, n, flops = burn.make_all_device_burn(
        128, depth, device="cpu")
    assert jax_flops == 2 * depth * jax_n * 128**3
    assert flops == 2 * depth * n * 128**3
    assert n == len(x_blocks) == len(w_blocks) == 1
    out = step(x_blocks, w_blocks)
    assert out[0].shape == (128, 128) and out[0].dtype == torch.bfloat16


@pytest.mark.parametrize("kernel,per_step", [
    ("torch", 2 * 16 * 128**3),
    ("cuda", 2 * 128**3),
])
def test_run_burn_feeds_the_hook_exact_flops(kernel, per_step):
    hook = Hook()
    result = {}
    steps = burn.run_burn(seconds=0.2, size=128, report_every=1e9,
                          kernel=kernel, step_hook=hook, result=result,
                          device="cpu")
    assert steps > 0
    assert hook.steps == steps
    assert hook.flops == steps * per_step
    assert set(result) == RESULT_KEYS
    assert result["devices"] == 1 and result["size"] == 128
    assert result["depth"] == (16 if kernel == "torch" else None)


@pytest.mark.parametrize("n_cards", [1, 2])
def test_run_burn_waits_for_the_batch_before_the_last(n_cards, monkeypatch):
    """With events to wait on (the cards' streams), each batch boundary
    waits for the boundary before it, so one batch stays queued, and the
    hook hears of a batch once it has run: 32 steps a call, the rest at
    the end, every step once. The step is a stand-in: the loop is under
    test, not the product."""
    marks, waits = [], []

    class Event:
        def __init__(self, index):
            self.index = index

        def synchronize(self):
            waits.append(self.index)

    def mark(devices):
        assert len(devices) == n_cards
        marks.append(len(marks))
        return [Event(marks[-1]) for _ in devices]

    def stand_in(size, depth, device):
        blocks = [torch.zeros(1) for _ in range(n_cards)]
        return (lambda x, w: x), blocks, blocks, n_cards, 1.0

    monkeypatch.setattr(burn, "mark", mark)
    monkeypatch.setattr(burn, "make_all_device_burn", stand_in)
    hook = Hook()
    sizes = []

    def record(n, *, seconds, flops):
        sizes.append(n)
        hook(n, seconds=seconds, flops=flops)

    steps = burn.run_burn(seconds=0.05, size=128, report_every=1e9,
                          step_hook=record, device="cpu")
    assert len(marks) == steps // 32 >= 2
    assert waits == [index for index in marks[:-1] for _ in range(n_cards)]
    assert sizes[:-1] == [32] * (len(marks) - 1)
    assert sizes[-1] == steps - 32 * (len(marks) - 1)
    assert hook.steps == steps


def test_run_burn_batch_sets_the_steps_between_waits(monkeypatch):
    """``batch`` steps are queued between waits: each boundary waits for
    the one before it and the hook hears of ``batch`` steps a call."""
    marks, waits = [], []

    class Event:
        def __init__(self, index):
            self.index = index

        def synchronize(self):
            waits.append(self.index)

    def mark(devices):
        marks.append(len(marks))
        return [Event(marks[-1])]

    def stand_in(size, depth, device):
        blocks = [torch.zeros(1)]
        return (lambda x, w: x), blocks, blocks, 1, 1.0

    monkeypatch.setattr(burn, "mark", mark)
    monkeypatch.setattr(burn, "make_all_device_burn", stand_in)
    sizes = []
    steps = burn.run_burn(seconds=0.05, size=128, report_every=1e9,
                          step_hook=lambda n, **_: sizes.append(n),
                          device="cpu", batch=128)
    assert len(marks) == steps // 128 >= 2
    assert waits == marks[:-1]
    assert sizes[:-1] == [128] * (len(marks) - 1)
    assert sum(sizes) == steps
    with pytest.raises(ValueError, match="batch"):
        burn.run_burn(seconds=0.01, size=128, device="cpu", batch=0)


@pytest.mark.parametrize("jax_kernel,kernel", [("xla", "torch"),
                                               ("pallas", "cuda")])
def test_run_burn_result_keys_match_jax(jax_kernel, kernel):
    want, got = {}, {}
    jax_burn.run_burn(seconds=0.1, size=128, report_every=1e9,
                      kernel=jax_kernel, depth=2, result=want)
    burn.run_burn(seconds=0.1, size=128, report_every=1e9, kernel=kernel,
                  depth=2, result=got, device="cpu")
    assert set(got) == set(want) == RESULT_KEYS
    assert (got["depth"] is None) == (want["depth"] is None)


def test_pulsed_burn_reports_each_pulse():
    hook = Hook()
    steps = burn.run_burn(seconds=0.3, size=128, report_every=1e9,
                          kernel="cuda", step_hook=hook, pulse_ms=50,
                          device="cpu")
    assert steps > 0 and hook.steps == steps
    assert hook.calls >= 2


@pytest.mark.parametrize("bad", ["Pallas", "xla", "pallas", ""])
def test_unknown_kernel_rejected(bad):
    with pytest.raises(ValueError, match="unknown kernel"):
        burn.run_burn(seconds=0.1, size=128, kernel=bad, device="cpu")
    if bad == "Pallas":
        with pytest.raises(ValueError, match="unknown kernel"):
            jax_burn.run_burn(seconds=0.1, size=128, kernel=bad)


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_sweep_on_cpu_has_no_mfu(kernel):
    rows = burn.sweep_burn((128, 256), seconds_per_size=0.1, depth=2,
                           kernel=kernel, device="cpu")
    assert [row["size"] for row in rows] == [128, 256]
    for row in rows:
        assert "mfu_pct" not in row
        assert row["device_kind"] == "cpu"
        assert row["tflops_per_s"] > 0


def test_sweep_deadline_skips_like_jax():
    rows = burn.sweep_burn((128, 256), seconds_per_size=0.1, depth=2,
                           deadline_seconds=0.0, device="cpu")
    assert rows[1] == {"size": 256, "skipped": "sweep deadline"}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("call", [
    lambda: burn.run_burn(seconds=0.1, size=128),
    lambda: burn.run_burn(seconds=0.1, size=128, kernel="cuda"),
    lambda: burn.sweep_burn((128,), seconds_per_size=0.1),
    lambda: burn.entry_fn(size=128),
    lambda: entry.entry(),
    lambda: burn.main(["--seconds", "0.1", "--size", "128"]),
], ids=["run_burn", "run_burn_cuda", "sweep_burn", "entry_fn", "entry",
        "main"])
def test_entry_points_refuse_the_cpu_without_being_asked(no_cuda, call):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_entry_on_cpu_when_asked():
    fn, (x, w) = entry.entry(device="cpu")
    assert x.shape == w.shape == (512, 512) and x.dtype == torch.bfloat16
    y = fn(x, w)
    assert y.shape == (512, 512) and y.dtype == torch.bfloat16
    assert torch.isfinite(y.float()).all()


def test_inputs_are_seeded():
    _, x1, w1, _ = burn.all_device_burn_inputs(128, "cpu")
    _, x2, w2, _ = burn.all_device_burn_inputs(128, "cpu")
    assert torch.equal(x1[0], x2[0]) and torch.equal(w1[0], w2[0])
    assert not torch.equal(x1[0], w1[0])


@pytest.mark.parametrize("argv", [["--kernel", "pallas"], ["--kernel", "xla"],
                                  ["--mode", "hbm"],
                                  ["--shard-mb", "four"]])
def test_main_offers_only_this_slice(argv):
    with pytest.raises(SystemExit):
        burn.main(argv)


@pytest.mark.parametrize("name,capacity,peak", [
    ("NVIDIA H100 NVL", 94 * 1024**3, 835e12),
    ("NVIDIA H100 PCIe", 80 * 1024**3, 756e12),
    ("NVIDIA H100 80GB HBM3", 80 * 1024**3, 989e12),
    ("NVIDIA A100-SXM4-80GB", None, None),
    ("cpu", None, None),
    ("TPU v5 lite", None, None),
])
def test_kind_tables(name, capacity, peak):
    assert kinds._kind_capacity(name) == capacity
    assert kinds._kind_peak_flops(name) == peak
