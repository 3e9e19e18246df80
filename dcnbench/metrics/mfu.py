"""The model's operations a step (2 per multiply-add of every conv,
deformable conv and linear, counted from shapes by the reference; three
times the forward for a training step) over the time a step of the steps
timed before the traced window, as a share of the card's published TF32
peak."""

UNIT = "%"
LAYER = "model step"


def read(ctx):
    if ctx.trace is None:
        return None
    per_step = ctx.window_s / ctx.steps
    return 100 * ctx.flops_per_step / per_step / ctx.peak_flops
