"""Fakes for tests: a scripted NVML (``fake_nvml.py``) and host-signal
fixture trees (``host_fixture.py``)."""
