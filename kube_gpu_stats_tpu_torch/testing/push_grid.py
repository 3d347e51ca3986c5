"""When a synthetic fleet pushes, relative to the hub it pushes into.

Test support for a process that plays many nodes at once: after each
hub generation it sees, it pushes one round, every node one frame,
``delay`` seconds after the generation appeared. The rounds keep a
steady grid of ``interval`` seconds, because the poll that sees a
generation is too coarse for the frames' spacing: the hub scores each
pushed node's frame inter-arrival gap against its own baseline, whose
deviation floors at 2% of the mean (20 ms at a 1 s interval).

The hub's own period is not exactly ``interval``: its timer wakes a
little late or early each refresh, so the two grids drift apart. A grid
that jumps to catch up moves every node's gap by the jump at once, and
the hub rightly scores that as an anomaly on every node. So the grid
follows the hub by at most ``SLEW`` seconds a round (a fraction
``GAIN`` of its phase error), which tracks a drift of up to ``SLEW`` a
refresh with a standing error of drift / ``GAIN``; it anchors anew only
when the error passes ``MAX_ERROR`` (a stall, a skipped generation), and
counts each time it does.
"""

from __future__ import annotations


class PushGrid:
    """The due times of a synthetic fleet's rounds, one per generation."""

    GAIN = 0.2
    SLEW = 0.01
    MAX_ERROR = 0.3

    def __init__(self, interval: float, delay: float) -> None:
        self.interval = interval
        self.delay = delay
        self.due: float | None = None
        self.anchors = 0
        self.error = 0.0

    def next_due(self, seen: float) -> float:
        """The time to start the round that follows a generation first
        seen at ``seen`` (monotonic clock); call once per round."""
        ideal = seen + self.delay
        if self.due is not None:
            self.due += self.interval
            self.error = ideal - self.due
        if self.due is None or abs(self.error) > self.MAX_ERROR:
            self.due = ideal
            self.error = 0.0
            self.anchors += 1
        else:
            self.due += max(-self.SLEW, min(self.SLEW,
                                            self.GAIN * self.error))
        return self.due
