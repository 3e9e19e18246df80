"""Device time a step of everything outside the deformable ops: the dense
and predictor convs, GroupNorm, elementwise kernels, the head, the input
copy and, in training, AdamW."""

UNIT = "ms"
LAYER = "library and rest"


def read(ctx):
    if ctx.trace is None:
        return None
    total = sum(ctx.trace["by_name"].values())
    dcn = sum(t * ctx.dcn_share.get(n, 0.0)
              for n, t in ctx.trace["by_name"].items())
    return 1e3 * (total - dcn) / ctx.trace_steps
