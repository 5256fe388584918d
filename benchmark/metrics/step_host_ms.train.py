"""Host ms the system spends in a training step (its whole call: forward,
losses, backward and optimizer): the median over the window's steps of its
tracer's `train.step` span (`harness/inside.py`)."""

from benchmark.harness.inside import request_ms

UNIT = "ms"


def read(ctx):
    return request_ms(ctx, "train", "train.step", "train.step")
