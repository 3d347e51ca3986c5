"""The port's multi-card load generator against the JAX package's, on the
CPU: gloo ranks (spawned processes that import no JAX) against the
reference on conftest's 8-device CPU mesh, on the same numpy arrays.

NCCL refuses two ranks on one card, so multi-rank numerics are shown
here only; on the card, ``chip_smoke.py`` runs one NCCL rank.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from kube_gpu_stats_tpu.loadgen.burn import \
    make_sharded_train_step as ref_sharded_train_step
from kube_gpu_stats_tpu.loadgen.ici_burn import make_ici_burn as ref_ici_burn
from kube_gpu_stats_tpu_torch import cli, entry
from kube_gpu_stats_tpu_torch.loadgen import burn, ici_burn
from kube_gpu_stats_tpu_torch.loadgen.mesh import _mesh_shape, run_ranks
from kube_gpu_stats_tpu_torch.testing import ranks

# A hung rank fails its test well inside the suite's limit.
TIMEOUT_S = 180.0
WIDTHS = dict(d_model=64, d_hidden=128, batch=32)
# f32 on both sides; the sums run in another order (XLA's psum against
# gloo's all-reduce, XLA's dot against torch's).
RTOL, ATOL = 1e-5, 1e-6


def _reference_step(n):
    """The reference's step on its n-device mesh: the full arrays before,
    the full updated weights and the loss after."""
    mesh, train_step, params, x = ref_sharded_train_step(n, **WIDTHS)
    arrays = tuple(np.asarray(a) for a in (params["w1"], params["w2"], x))
    with mesh:
        new_params, loss = train_step(params, x)
    return (arrays, {k: np.asarray(v) for k, v in new_params.items()},
            float(loss), mesh)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_sharded_train_step_matches_jax(n):
    arrays, want, want_loss, _ = _reference_step(n)
    out = run_ranks(ranks.train_step, n, device="cpu",
                    args=("cpu", arrays, WIDTHS), timeout=TIMEOUT_S)
    dp, tp = _mesh_shape(n)
    hidden = arrays[0].shape[1] // tp
    rows = arrays[2].shape[0] // dp
    for rank, got in enumerate(out):
        d, m = divmod(rank, tp)
        assert (got["data"], got["model"], got["dp"], got["tp"]) == \
            (d, m, dp, tp)
        cols = slice(m * hidden, (m + 1) * hidden)
        np.testing.assert_array_equal(got["w1"], arrays[0][:, cols])
        np.testing.assert_array_equal(got["x"],
                                      arrays[2][d * rows:(d + 1) * rows])
        np.testing.assert_allclose(got["loss"], want_loss, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got["new_w1"], want["w1"][:, cols],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["new_w2"], want["w2"][cols],
                                   rtol=RTOL, atol=ATOL)
    assert want_loss > 0


def test_six_ranks_round_batch_and_hidden_up_as_the_reference():
    """n = 6 is the (3, 2) mesh: batch 32 rounds up to 33 and every shard
    has the reference's shape; the port's own seeded step runs too."""
    _, _, _, mesh = _reference_step(6)
    assert mesh.devices.shape == _mesh_shape(6) == (3, 2)
    mesh_, _, params, x = ref_sharded_train_step(6, **WIDTHS)
    want = {name: {s.data.shape for s in arr.addressable_shards}
            for name, arr in (("w1", params["w1"]), ("w2", params["w2"]),
                              ("x", x))}
    out = run_ranks(ranks.train_step, 6, device="cpu",
                    args=("cpu", None, WIDTHS), timeout=TIMEOUT_S)
    for got in out:
        assert {got["w1"].shape} == want["w1"] == {(64, 64)}
        assert {got["w2"].shape} == want["w2"] == {(64, 64)}
        assert {got["x"].shape} == want["x"] == {(11, 64)}
        assert got["loss"] > 0
    assert len({got["loss"] for got in out}) == 1


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_matches_the_reference(n):
    steps = 3
    fn, x = ref_ici_burn(n, shard_mb=0.001, steps=steps)
    original = np.asarray(x).reshape(n, -1)  # before fn donates x
    want = np.asarray(fn(x)).reshape(n, -1)
    out = run_ranks(ranks.ring, n, device="cpu", args=("cpu", 0.001, steps),
                    timeout=TIMEOUT_S)
    np.testing.assert_array_equal(np.stack([b for b, _ in out]), original)
    got = np.stack([a for _, a in out])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.roll(original, steps, axis=0)
                                  + steps)


def test_ring_of_one_is_the_identity_plus_steps():
    fn, x = ref_ici_burn(1, shard_mb=0.001, steps=4)
    original = np.asarray(x)
    want = np.asarray(fn(x))
    [(before, after)] = run_ranks(ranks.ring, 1, device="cpu",
                                  args=("cpu", 0.001, 4), timeout=TIMEOUT_S)
    np.testing.assert_array_equal(before, original)
    np.testing.assert_array_equal(after, want)
    np.testing.assert_array_equal(after, original + 4)


@pytest.mark.parametrize("n", [1, 4])
def test_dryrun_multichip_on_cpu_ranks(n):
    entry.dryrun_multichip(n, device="cpu")


def test_a_failing_rank_fails_the_caller_without_hanging():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(ranks.fail_on, 3, device="cpu", args=(1,),
                  timeout=TIMEOUT_S)


# In a fresh interpreter: ranks, then the exit handlers as the exit runs
# them; the resource tracker the spawn started must be stopped and
# reaped by then, so no process of this one outlives it.
_TRACKER_AT_EXIT = """
import atexit, os
from multiprocessing import resource_tracker
from kube_gpu_stats_tpu_torch.loadgen.mesh import run_ranks
from kube_gpu_stats_tpu_torch.testing import ranks
run_ranks(ranks.ring, 1, device="cpu", args=("cpu", 0.001, 1))
pid = resource_tracker._resource_tracker._pid
assert pid is not None, "no tracker was started"
atexit._run_exitfuncs()
assert resource_tracker._resource_tracker._fd is None
try:
    os.kill(pid, 0)
except ProcessLookupError:
    print("tracker gone")
"""


def test_the_spawns_resource_tracker_ends_with_the_process():
    out = subprocess.run([sys.executable, "-c", _TRACKER_AT_EXIT],
                         capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "tracker gone"


def test_run_ici_burn_spawns_ranks_and_reports(capfd):
    result = {}
    rounds = ici_burn.run_ici_burn(0.5, n_devices=2, shard_mb=0.001,
                                   steps=2, report_every=0.1, device="cpu",
                                   result=result)
    assert rounds == result["rounds"] >= ici_burn.AGREE_EVERY
    assert rounds % ici_burn.AGREE_EVERY == 0
    # 256 floats a shard, two shards, two hops.
    assert result["bytes_per_round"] == 256 * 4 * 2 * 2
    assert result["devices"] == 2 and result["gb_per_s"] > 0
    assert "ici-burn:" in capfd.readouterr().out


def test_loadgen_main_mode_ici_on_cpu(capfd):
    assert burn.main(["--mode", "ici", "--seconds", "0.3", "--shard-mb",
                      "0.001"], device="cpu") == 0
    capfd.readouterr()


@pytest.mark.parametrize("call", [
    lambda: entry.dryrun_multichip(1),
    lambda: ici_burn.run_ici_burn(0.1),
    lambda: cli.main(["loadgen", "--mode", "ici", "--seconds", "0.1"]),
    lambda: run_ranks(ranks.ring, 1, device="cuda", args=("cuda", 1.0, 1)),
], ids=["dryrun", "run_ici_burn", "cli_loadgen_ici", "run_ranks"])
def test_without_cuda_the_card_entry_points_raise(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


@pytest.mark.parametrize("call", [
    lambda: burn.make_sharded_train_step(1, device="cpu"),
    lambda: ici_burn.make_ici_burn(1, device="cpu"),
], ids=["train_step", "ici_burn"])
def test_the_per_rank_constructors_need_a_process_group(call):
    with pytest.raises(RuntimeError, match="no process group is up"):
        call()


def test_one_card_per_process_under_two_gloo_ranks():
    """Under one process per card (a group up, LOCAL_WORLD_SIZE 2) each
    process owns its current card only, and the embedded collector serves
    exactly this rank's own burn FLOPs: the burn scales its hook by the
    world size, the collector divides by it."""
    out = run_ranks(ranks.one_card_per_process, 2, device="cpu",
                    args=(64, 0.3), timeout=TIMEOUT_S)
    for rank, got in enumerate(out):
        assert got["one_each"] is True
        assert got["owned"] == [("cuda", rank)]
        assert got["steps"] > 0
        assert got["served_flops"] == pytest.approx(got["own_flops"],
                                                    rel=1e-12)
