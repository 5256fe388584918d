"""Host ms from a stream request's submission until the serving entry (or
the pipeline) returns, mean per request of the traced window."""

from benchmark.harness.readers import host_mean_ms

UNIT = "ms"


def read(ctx):
    return host_mean_ms(ctx, "stream", "host_issue_ms")
