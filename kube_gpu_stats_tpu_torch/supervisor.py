"""Thread birth for the port's long-lived workers.

The port's copy of the reference supervisor's ``spawn``: every long-lived
thread of the exporter stack (poll loop, sampler pool, HTTP server, render
warmer, textfile writer) is created here, daemonic and named, so it shows
under a real name in a stack dump and never gates process exit.
"""

from __future__ import annotations

import threading
from typing import Callable


def spawn(target: Callable, *, name: str, daemon: bool = True,
          args: tuple = (), kwargs: dict | None = None) -> threading.Thread:
    """Returns the (unstarted) thread; callers keep their own ``.start()``."""
    return threading.Thread(target=target, name=name, daemon=daemon,
                            args=args, kwargs=kwargs or {})
