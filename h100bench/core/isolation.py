"""Which modules the benchmark's processes may not hold: JAX, its
libraries and the JAX package the program was ported from, compared by
whole top-level name (the part before the first dot), since the port's own
name begins with the JAX package's.

Every process of a run reports what it holds once the window has closed:
the one that prints the result checks itself; the job's child, the
daemon's launcher and the scraper child send their lists to it.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "kube_gpu_stats_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """The names in ``modules`` (default ``sys.modules``) whose top-level
    name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted({name for name in list(names)
                   if name.split(".", 1)[0] in FORBIDDEN})
