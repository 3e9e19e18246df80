"""The op-level bound of a step's deformable ops (each op's inputs read
once, outputs written once, its products, forward and, in training,
backward; bytes at 3.35 TB/s or products at 495 TFLOP/s, the longer) over
their device time."""

UNIT = "%"
LAYER = "deformable op"


def read(ctx):
    if ctx.trace is None:
        return None
    dcn_s = sum(t * ctx.dcn_share.get(n, 0.0)
                for n, t in ctx.trace["by_name"].items()) / ctx.trace_steps
    if dcn_s <= 0:
        return None
    return 100 * ctx.dcn_bound_s / dcn_s
