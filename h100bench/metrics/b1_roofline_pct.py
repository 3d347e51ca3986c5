"""B1's share of its roofline over the traced sub-window (device trace):
the least time a launch could take, the larger of its operations
(2 * size^3) at the card's peak bf16 rate and its bytes (two bf16 inputs
read once, the float32 product written once: 8 * size^2) at the card's
peak bandwidth, over the device time of B1's launches. At 4096
the operations bound it."""

from h100bench.core.readers import is_b1


def read(ctx):
    trace, peaks = ctx["trace"], ctx["peaks"]
    if trace is None or peaks is None:
        return None
    launches = [dur for name, _, dur in trace.ops if is_b1(name)]
    if not launches:
        return None
    size = ctx["size"]
    least_s = max(2 * size ** 3 / peaks[0], 8 * size ** 2 / peaks[1])
    return 100.0 * len(launches) * least_s / (sum(launches) / 1e6)
