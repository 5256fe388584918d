"""The share of the traced stretch in which no kernel ran on the card
(offline: inside the intervals in which requests were being served)."""

from benchmark.harness.readers import idle_pct

UNIT = "%"


def read(ctx):
    return idle_pct(ctx, "offline")
