"""Host ms the system spends in the reader (voxelize, K1, the pillar MLP) in
a stream request (one frame): the median over the window's requests of its
tracer's `reader` span (`harness/inside.py`)."""

from benchmark.harness.inside import request_ms

UNIT = "ms"


def read(ctx):
    return request_ms(ctx, "stream", "serving.request", "reader")
