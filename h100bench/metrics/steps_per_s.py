"""The monitored job's steps that the card ran in the window, over the
window (host clock; the window ends when the last step has run)."""


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return ctx["steps"] / ctx["window_s"]
