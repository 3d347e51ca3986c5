"""The program's DaemonSet entry, run as ``python -m kube_gpu_stats_tpu_torch``
would run it, that reports on its way out which forbidden modules it held.

    python -m h100bench.core.daemon_child <report path> <daemon arguments...>

Once the program's ``main`` returns (on SIGTERM, the daemon's own stop), the
launcher writes the forbidden modules it finds in ``sys.modules`` to the
report path as a JSON list. A run whose daemon wrote no report has no
result.
"""

from __future__ import annotations

import json
import os
import runpy
import sys

from h100bench.core.isolation import forbidden_modules


def main() -> int:
    report = sys.argv[1]
    sys.argv = ["kube_gpu_stats_tpu_torch", *sys.argv[2:]]
    code: int | str | None = 0
    try:
        runpy.run_module("kube_gpu_stats_tpu_torch", run_name="__main__",
                         alter_sys=True)
    except SystemExit as exc:
        code = exc.code
    finally:
        partial = f"{report}.part"
        with open(partial, "w") as fh:
            json.dump(forbidden_modules(), fh)
        os.replace(partial, report)
    if code is None or isinstance(code, int):
        return code or 0
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
