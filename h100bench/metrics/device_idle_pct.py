"""The traced sub-window's share in which no operation ran on the device
(device trace): its length less the union of the operations' intervals."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us / trace.window_us)
