"""CLI entry point: ``python -m kube_gpu_stats_tpu_torch``.

Bare flags run the exporter daemon (the DaemonSet entry point).
``loadgen …`` runs the load generator (``loadgen/burn.py``'s ``main``:
the matmul burn, ``--mode ici`` the NVLink ring), ``validate …`` the
exposition-contract checker (``validate.py``), ``doctor …`` the node
preflight (``doctor.py``), ``hub …`` the slice aggregation service
(``hub.py``) and ``top …`` the live per-card view (``top.py``). Every
subcommand but ``loadgen`` runs without importing torch.
"""

from __future__ import annotations

import sys
from typing import Sequence


def main(argv: Sequence[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args and args[0] == "loadgen":
        from .loadgen.burn import main as loadgen_main

        return loadgen_main(args[1:])
    if args and args[0] == "validate":
        from .validate import main as validate_main

        return validate_main(args[1:])
    if args and args[0] == "doctor":
        from .doctor import main as doctor_main

        return doctor_main(args[1:])
    if args and args[0] == "top":
        from .top import main as top_main

        return top_main(args[1:])
    if args and args[0] == "hub":
        from .hub import main as hub_main

        return hub_main(args[1:])
    from .config import from_args
    from .daemon import run

    return run(from_args(args))


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
