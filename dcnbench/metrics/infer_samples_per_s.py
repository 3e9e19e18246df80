"""Served samples a second: the samples of every request the window
completed over the window's wall time."""

UNIT = "samples/s"


def read(ctx):
    return ctx.steps * ctx.batch / ctx.window_s
