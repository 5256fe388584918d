"""Host ms a stream request (one frame) waits for the card: the median of
the system's `serving.sync` spans in the window (`runtime.serving.to_host`,
one a request; `harness/inside.py`)."""

from benchmark.harness.inside import span_ms

UNIT = "ms"


def read(ctx):
    return span_ms(ctx, "stream", "serving.sync")
