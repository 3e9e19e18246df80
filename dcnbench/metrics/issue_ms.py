"""The host's time in CapturedStep.__call__ (the inputs' copy and the
graph's launch), the mean over the steps timed before the traced
window."""

UNIT = "ms"
LAYER = "compiled step"


def read(ctx):
    if ctx.trace is None:
        return None
    return 1e3 * sum(ctx.issue_s) / len(ctx.issue_s)
