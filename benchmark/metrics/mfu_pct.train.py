"""The least time one H100 needs for the window's training steps (three
times each sample's forward operations, counts.py: active sites at the
f32 peak) as a share of the window."""

from benchmark.harness.readers import mfu_pct

UNIT = "%"


def read(ctx):
    return mfu_pct(ctx, "train")
