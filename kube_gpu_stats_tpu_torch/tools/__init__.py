"""Developer tools for the port, each run as ``python -m
kube_gpu_stats_tpu_torch.tools.<name>``: the package lints
(``check_supervised_threads``, ``check_wal_versions``) and the poll-tick
profilers (``profile_tick``, a cProfile table; ``trace_dump``, a Chrome
trace). The reference project keeps their counterparts under its
``tools/``. None of them imports torch."""
