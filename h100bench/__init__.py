"""Benchmark harness of the PyTorch/CUDA exporter port (see BENCHMARK.json)."""
