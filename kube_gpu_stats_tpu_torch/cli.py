"""CLI entry point: ``python -m kube_gpu_stats_tpu_torch``.

Bare flags run the exporter daemon (the DaemonSet entry point). The
reference's operational subcommands (``doctor``, ``validate``, ``top``,
``hub``) are not ported yet: each exits 2 and says so.
"""

from __future__ import annotations

import sys
from typing import Sequence

NOT_PORTED = ("doctor", "validate", "top", "hub")


def main(argv: Sequence[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args and args[0] in NOT_PORTED:
        print(f"kube_gpu_stats_tpu_torch: '{args[0]}' is not ported yet; "
              f"only the daemon runs (bare flags)", file=sys.stderr)
        return 2
    from .config import from_args
    from .daemon import run

    return run(from_args(args))


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
