"""Device ms of the neck_head layer per offline request: CUDA events around
its calls in the traced window."""

from benchmark.harness.readers import layer_mean_ms

UNIT = "ms"


def read(ctx):
    return layer_mean_ms(ctx, "offline", "neck_head")
