"""95th percentile over the window's frames of the time from a frame's
due time to its submission: how late the generator and the backlog ran."""

import numpy as np

UNIT = "ms"


def read(ctx):
    values = getattr(ctx, "queue_wait_ms", None)
    if ctx.tag != "stream" or not values:
        return None
    return float(np.percentile(values, 95))
