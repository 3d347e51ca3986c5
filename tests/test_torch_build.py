"""The port's kernel build (kube_gpu_stats_tpu_torch._build) off the card:
where nvcc is looked up, and that the library's name follows the sources
so an edited kernel is never run from a stale build."""

import pytest

from kube_gpu_stats_tpu_torch import _build


def test_missing_nvcc_raises_with_a_clear_message(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_nvcc_under_cuda_home_is_found(monkeypatch, tmp_path):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.nvcc_path() == str(nvcc)


def test_library_name_follows_the_sources(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one")
    first = _build._library_path([src])
    assert first == _build._library_path([src])
    src.write_text("// two")
    assert _build._library_path([src]) != first
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"


def test_the_kernel_sources_are_in_the_package():
    names = {p.name for p in _build.CSRC.glob("*.cu")}
    assert "tiled_gemm.cu" in names
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
