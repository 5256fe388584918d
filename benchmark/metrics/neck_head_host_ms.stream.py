"""Host ms the system spends in the neck and the head in a stream request
(one frame): the median over the window's requests of its tracer's `neck` +
`head` spans (`harness/inside.py`)."""

from benchmark.harness.inside import request_ms

UNIT = "ms"


def read(ctx):
    return request_ms(ctx, "stream", "serving.request", "neck", "head")
