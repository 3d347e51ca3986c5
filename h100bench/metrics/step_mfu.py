"""The whole burn step's share of the card's peak over the traced
sub-window (device trace): B1's operations (2 * size^3 a launch, the only
matrix work of the step) over the sub-window's length at the peak bf16
rate. A kernel taken off the path leaves its own roofline silent; this
share still bounds the step."""

from h100bench.core.readers import is_b1


def read(ctx):
    trace, peaks = ctx["trace"], ctx["peaks"]
    if trace is None or peaks is None or trace.window_us <= 0:
        return None
    launches = sum(1 for name, _, _ in trace.ops if is_b1(name))
    if not launches:
        return None
    flops = launches * 2 * ctx["size"] ** 3
    return 100.0 * flops / (trace.window_us / 1e6 * peaks[0])
