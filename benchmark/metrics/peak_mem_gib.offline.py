"""Peak device memory allocated in the traced window (GiB), after a
reset at its start."""

UNIT = "GiB"


def read(ctx):
    if ctx.tag != "offline" or not ctx.peak_window_bytes:
        return None
    return ctx.peak_window_bytes / 2**30
