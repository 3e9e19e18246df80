"""Training samples a second: the samples of every step of the window over
the window's wall time, which ends when the device has finished them."""

UNIT = "samples/s"


def read(ctx):
    return ctx.steps * ctx.batch / ctx.window_s
