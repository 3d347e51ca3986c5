"""The tanh and bf16-cast kernels' share of all device time in the traced
sub-window (device trace)."""

from h100bench.core.readers import is_epilogue


def read(ctx):
    trace = ctx["trace"]
    if trace is None or not trace.ops:
        return None
    total = sum(dur for _, _, dur in trace.ops)
    epilogue = sum(dur for name, _, dur in trace.ops if is_epilogue(name))
    if total <= 0 or epilogue <= 0:
        return None
    return 100.0 * epilogue / total
