"""The rate sweep of a stream cell, on the chip: one set-up, then the
cell's open loop at each rate for a while; per rate the latency's median
and 95th percentile and whether the backlog grew (the last quarter's
median latency more than twice the first quarter's, or more than one
period above it). The highest rate without a growing backlog is the
cell's capacity; the cell runs at about four fifths of it.

    python3 benchmark/tools/sweep.py --workload nusc_f32_stream \
        --seed 5 --seconds 8 --rates 8 10 12 13 14 15 16
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import session  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = session.load_cell(args.workload)
    s = session.Setup(cell, args.seed, torch.device("cuda", 0))
    session.warm_up(s)
    for rate in args.rates:
        s.cell["traffic"]["rate_hz"] = rate
        _, recs, _ = session.drive_stream(s, args.seconds)
        lat = np.array([(done - due) * 1e3 for due, _, _, done in recs])
        svc = np.array([(done - sub) * 1e3 for _, sub, _, done in recs])
        q = max(1, len(lat) // 4)
        first, last = np.median(lat[:q]), np.median(lat[-q:])
        grows = bool(last > 2 * first or last - first > 1e3 / rate)
        print(json.dumps({"rate_hz": rate, "frames": len(lat),
                          "latency_p50_ms": float(np.median(lat)),
                          "latency_p95_ms": float(np.percentile(lat, 95)),
                          "service_p50_ms": float(np.median(svc)),
                          "first_quarter_ms": float(first),
                          "last_quarter_ms": float(last),
                          "backlog_grows": grows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
