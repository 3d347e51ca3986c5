"""Fakes for tests: a scripted NVML (``fake_nvml.py``)."""
