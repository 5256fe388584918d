"""The share of two traced training steps in which no kernel ran on the
card."""

from benchmark.harness.readers import idle_pct

UNIT = "%"


def read(ctx):
    return idle_pct(ctx, "train")
