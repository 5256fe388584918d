"""Host ms the system spends in a training step's optimizer (the clip and
AdamW over every parameter): the median over the window's steps of its
tracer's `train.optimizer` span (`harness/inside.py`)."""

from benchmark.harness.inside import request_ms

UNIT = "ms"


def read(ctx):
    return request_ms(ctx, "train", "train.step", "train.optimizer")
