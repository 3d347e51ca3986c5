"""CLI entry point: ``python -m kube_gpu_stats_tpu_torch``.

Bare flags run the exporter daemon (the DaemonSet entry point).
``loadgen …`` runs the load generator (``loadgen/burn.py``'s ``main``:
the matmul burn, ``--mode ici`` the NVLink ring), ``validate …`` the
exposition-contract checker (``validate.py``) and ``doctor …`` the node
preflight (``doctor.py``). The reference's other operational subcommands
(``top``, ``hub``) are not ported yet: each exits 2 and says so.
"""

from __future__ import annotations

import sys
from typing import Sequence

NOT_PORTED = ("top", "hub")


def main(argv: Sequence[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args and args[0] in NOT_PORTED:
        print(f"kube_gpu_stats_tpu_torch: '{args[0]}' is not ported yet; "
              f"the daemon (bare flags), loadgen, validate and doctor run",
              file=sys.stderr)
        return 2
    if args and args[0] == "loadgen":
        from .loadgen.burn import main as loadgen_main

        return loadgen_main(args[1:])
    if args and args[0] == "validate":
        from .validate import main as validate_main

        return validate_main(args[1:])
    if args and args[0] == "doctor":
        from .doctor import main as doctor_main

        return doctor_main(args[1:])
    from .config import from_args
    from .daemon import run

    return run(from_args(args))


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
