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


def test_ptxas_reports_each_kernels_resources():
    assert ("-Xptxas", "-v") == _build.NVCC_FLAGS[-2:]
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z4wideILi256EEv' for 'sm_90a'
ptxas info    : Function properties for _Z4wideILi256EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z6narrowv' for 'sm_90a'
ptxas info    : Function properties for _Z6narrowv
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 90 registers, 1024 bytes smem, 384 bytes cmem[0]
ptxas warning : (C7508) setmaxnreg ignored; unable to determine register count at entry
"""
    report = _build.ptxas_report(log)
    assert report["kernels"] == {
        "_Z4wideILi256EEv": dict(registers=168, static_smem=0,
                                 spill_stores=0, spill_loads=0),
        "_Z6narrowv": dict(registers=90, static_smem=1024, spill_stores=4,
                           spill_loads=12),
    }
    assert len(report["warnings"]) == 1 and "C7508" in report["warnings"][0]
    assert _build.ptxas_report("") == {"kernels": {}, "warnings": []}


def test_build_keeps_nvccs_output_beside_the_library(monkeypatch, tmp_path):
    lib = tmp_path / "libkts_kernels_0123.so"

    def fake_nvcc(cmd, **kwargs):
        assert "-Xptxas" in cmd and "-v" in cmd
        open(cmd[cmd.index("-o") + 1], "w").close()
        return _build.subprocess.CompletedProcess(
            cmd, 0, stdout="", stderr="ptxas info    : Used 8 registers\n")

    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    _build._compile([tmp_path / "k.cu"], lib)
    assert lib.exists()
    assert lib.with_suffix(".log").read_text() == (
        "ptxas info    : Used 8 registers\n")


def test_failed_build_raises_with_nvccs_output(monkeypatch, tmp_path):
    lib = tmp_path / "libkts_kernels_0123.so"
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(
        _build.subprocess, "run",
        lambda cmd, **kw: _build.subprocess.CompletedProcess(
            cmd, 2, stdout="", stderr="error: bad wgmma"))
    with pytest.raises(RuntimeError, match="bad wgmma"):
        _build._compile([tmp_path / "k.cu"], lib)
    assert not lib.exists() and not lib.with_suffix(".log").exists()


def test_build_log_is_empty_before_a_build(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert _build.build_log() == ""
