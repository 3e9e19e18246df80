"""Device time a step (a training step, or a served request's forward) of
everything launched inside the deformable ops: each device operation's
time in the traced window, times the share of it that ran inside the
ops in the fenced eager step."""

UNIT = "ms"
LAYER = "deformable op"


def dcn_s(ctx):
    """The deformable ops' device seconds over the traced window."""
    return sum(t * ctx.dcn_share.get(n, 0.0)
               for n, t in ctx.trace["by_name"].items())


def read(ctx):
    if ctx.trace is None:
        return None
    return 1e3 * dcn_s(ctx) / ctx.trace_steps
