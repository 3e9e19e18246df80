"""The card's peak of allocated memory, from a reset at the process's start
through set-up, capture and window, before the reference runs."""

UNIT = "GiB"


def read(ctx):
    if not ctx.memory_peak_bytes:
        return None
    return ctx.memory_peak_bytes / 2 ** 30
