"""Host ms the system spends in predict (decode and NMS) in an offline
request (a batch of 8): the median over the window's requests of its
tracer's `predict` span (`harness/inside.py`)."""

from benchmark.harness.inside import request_ms

UNIT = "ms"


def read(ctx):
    return request_ms(ctx, "offline", "serving.request", "predict")
