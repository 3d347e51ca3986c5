"""Native transports: the ctypes binding to NVML (``nvml.py``)."""
