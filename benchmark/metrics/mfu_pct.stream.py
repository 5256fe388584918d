"""The least time one H100 needs for the frames' operations (counts.py:
active sites, each part at the peak of its arithmetic) as a share of the
time the stream frames were served in the traced window."""

from benchmark.harness.readers import mfu_pct

UNIT = "%"


def read(ctx):
    return mfu_pct(ctx, "stream")
