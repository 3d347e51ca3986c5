"""The monitored job: the program's burn (``loadgen.burn.run_burn`` with the
``cuda`` kernel) on inputs the benchmark makes from the seed.

``run_burn`` builds its inputs through ``tiled_burn.tiled_all_device_burn``;
``BurnJob.installed()`` puts the benchmark's builder in its place for the
window, so the program runs its own loop, step and hook on seeded inputs.
The builder's step calls the program's ``tiled_burn_step`` and, around it,
counts the steps the card ran, keeps a reservoir of (input, output) pairs
drawn from the seed for the reference to judge after the window, and opens
and closes the profiler's sub-window in a traced run.
"""

from __future__ import annotations

import contextlib
import random
import time

import torch

# Pairs of (step input, step output) kept for the reference, besides the
# first step's: the first is the only one whose input is the seed's own
# (a fault that makes rows repeat, such as half the batch left out and its
# rows copied over, leaves every later state consistent with itself).
SAMPLES = 4


class BurnJob:
    def __init__(self, size: int, seed: int, device: torch.device) -> None:
        from kube_gpu_stats_tpu_torch.loadgen import tiled_burn

        self._module = tiled_burn
        self.size = size
        self.device = device
        gen = torch.Generator(device).manual_seed(seed)
        self.x = torch.randn((size, size), generator=gen, device=device,
                             dtype=torch.bfloat16)
        self.w = torch.randn((size, size), generator=gen, device=device,
                             dtype=torch.bfloat16)
        self.calls = 0
        self.samples: list[tuple[torch.Tensor, torch.Tensor, int]] = []
        self._rng = random.Random(seed * 2 + 1)
        self._step = tiled_burn.tiled_burn_step
        # (start, stop) on time.monotonic of a traced run's profiled
        # sub-window; None in an untraced run.
        self.profile_window: tuple[float, float] | None = None
        self._prof = None
        self._done = None

    # -- set-up ----------------------------------------------------------

    def warm(self, profiler: bool, steps: int = 8) -> None:
        """Run the program's step on this cell's shapes (kernel build and
        load, allocator, the epilogue's kernels) and, for a traced run, the
        profiler once, outside any window."""
        x = [self.x]
        for _ in range(steps):
            x = self._step(x, [self.w])
        if profiler:
            with _profiler(self.device):
                for _ in range(steps):
                    x = self._step(x, [self.w])
                _sync(self.device)
        _sync(self.device)

    @contextlib.contextmanager
    def installed(self):
        """``run_burn`` builds this job's inputs and step while in the block."""
        original = self._module.tiled_all_device_burn

        def build(size=1024, device=None):
            if size != self.size:
                raise ValueError(f"the job was made for size {self.size}, "
                                 f"run_burn asked for {size}")
            x, self.x = self.x, None
            return self.step, [x], [self.w], 1, 2 * size ** 3

        self._module.tiled_all_device_burn = build
        try:
            yield self
        finally:
            self._module.tiled_all_device_burn = original
            if self._prof is not None:
                self._stop_profile()

    # -- the window --------------------------------------------------------

    def step(self, x_blocks, w_blocks):
        out = self._step(x_blocks, w_blocks)
        t = self.calls
        self.calls += 1
        pair = (x_blocks[0], out[0], t)
        if len(self.samples) < SAMPLES + 1:
            self.samples.append(pair)
        else:
            # Reservoir over the steps after the first (slot 0 keeps it).
            j = self._rng.randrange(t)
            if j < SAMPLES:
                self.samples[1 + j] = pair
        if self.profile_window is not None and self._done is None:
            now = time.monotonic()
            if self._prof is None and now >= self.profile_window[0]:
                self._prof = _profiler(self.device)
                self._prof.start()
            elif self._prof is not None and now >= self.profile_window[1]:
                self._stop_profile()
        return out

    def _stop_profile(self) -> None:
        _sync(self.device)
        self._prof.stop()
        self._done, self._prof = self._prof, None

    def export_trace(self, path: str) -> bool:
        """Write the sub-window's trace to ``path`` (Chrome trace JSON);
        False when the window closed before the sub-window opened."""
        if self._done is None:
            return False
        self._done.export_chrome_trace(path)
        self._done = None
        return True

    # -- after the window --------------------------------------------------

    def live_bytes(self) -> int:
        """Bytes PyTorch's allocator holds for the tensors this job keeps:
        each storage once, rounded up to the allocator's 512-byte blocks."""
        storages = {}
        tensors = [self.w] + [t for x, out, _ in self.samples for t in (x, out)]
        if self.x is not None:
            tensors.append(self.x)
        for tensor in tensors:
            storage = tensor.untyped_storage()
            storages[storage.data_ptr()] = storage.nbytes()
        return sum(-(-n // 512) * 512 for n in storages.values())

    def release(self) -> None:
        self.samples = []
        self.x = self.w = None


def _profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities = [torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=activities)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
