"""Host ms the system spends in the neck and the head in an offline request
(a batch of 8): the median over the window's requests of its tracer's `neck`
+ `head` spans (`harness/inside.py`)."""

from benchmark.harness.inside import request_ms

UNIT = "ms"


def read(ctx):
    return request_ms(ctx, "offline", "serving.request", "neck", "head")
