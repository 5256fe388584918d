"""Host ms the system spends in predict (decode and NMS) in a stream request
(one frame): the median over the window's requests of its tracer's `predict`
span (`harness/inside.py`)."""

from benchmark.harness.inside import request_ms

UNIT = "ms"


def read(ctx):
    return request_ms(ctx, "stream", "serving.request", "predict")
