"""Process start to the first measured instant (host clock)."""


def read(ctx):
    return ctx["setup_s"]
