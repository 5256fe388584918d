"""Device ms of a training step's backward (CUDA events from the end of
the losses to the optimizer's step), mean over the traced window's
steps."""

from benchmark.harness.readers import layer_mean_ms

UNIT = "ms"


def read(ctx):
    return layer_mean_ms(ctx, "train", "backward")
