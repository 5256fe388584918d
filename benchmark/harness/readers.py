"""Shared arithmetic of the per-layer metric readers in `metrics/`. Each
reader takes the run's context and returns a number, or None where the
run has nothing for it to read."""

import numpy as np


def layer_mean_ms(ctx, tag, layer):
    """Mean device ms of a layer's calls in the traced window, per request
    (a stream's request is one frame)."""
    values = ctx.layer_ms.get(layer) if ctx.tag == tag else None
    return float(np.mean(values)) if values else None


def host_mean_ms(ctx, tag, name):
    values = getattr(ctx, name, None) if ctx.tag == tag else None
    return float(np.mean(values)) if values else None


def mfu_pct(ctx, tag):
    """The least time the chip needs for the frames done in the window,
    as a share of the time they were served."""
    if ctx.tag != tag or getattr(ctx, "min_s_done", None) is None \
            or not ctx.service_s:
        return None
    return 100.0 * ctx.min_s_done / ctx.service_s


def idle_pct(ctx, tag):
    t = ctx.trace
    if ctx.tag != tag or t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
