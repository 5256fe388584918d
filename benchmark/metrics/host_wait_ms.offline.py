"""Host ms an offline request (a batch of 8) waits for the card: the median
of the system's `serving.sync` spans in the window
(`runtime.serving.to_host`, one a request; `harness/inside.py`)."""

from benchmark.harness.inside import span_ms

UNIT = "ms"


def read(ctx):
    return span_ms(ctx, "offline", "serving.sync")
