"""Device ms of a training step's forward with its losses (CUDA events
from the model's call to the end of `loss`), mean over the traced
window's steps."""

from benchmark.harness.readers import layer_mean_ms

UNIT = "ms"


def read(ctx):
    return layer_mean_ms(ctx, "train", "forward")
