"""The share of the traced window in which no operation ran on the
device."""

UNIT = "%"
LAYER = "device"


def read(ctx):
    if ctx.trace is None:
        return None
    return 100 * (1 - ctx.trace["busy_s"] / ctx.trace["window_s"])
