"""From the process's start until the window opens: imports, the kernels'
build where it is needed, weights and inputs, warm-up and capture, and
the first steps the reference follows."""

UNIT = "s"


def read(ctx):
    return ctx.setup_s
