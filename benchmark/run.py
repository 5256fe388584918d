"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
    python3 benchmark/run.py --list

A cell is `workloads/<cell>.json`; it names a configuration
(`configs/`), a traffic mix (`traffic/`) and the limits of the
comparison with the plain reference (`reference/`). With `--trace 0` the
line carries the cell's end-to-end metrics, with `--trace 1` the per-layer
metrics that the readers in `metrics/` find something to read for, the
device's busy time and a breakdown. The last line of standard output is
the result; the compared numbers, each beside its limit, are the last
lines of standard error and the `checks` key of the result.
"""

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
# every build and kernel cache at a fixed path inside the checkout
CACHE = os.path.join(CHECKOUT, "build", "benchmark_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)


def parse(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--list", action="store_true",
                   help="print the cells, configurations, traffic mixes "
                        "and per-layer metrics found, and exit")
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import json

    from benchmark.harness import session

    if args.list:
        print(json.dumps(session.listing(), sort_keys=True))
        return 0
    if args.workload not in session.cell_names():
        print(f"unknown workload {args.workload!r}; cells: "
              f"{session.cell_names()}", file=sys.stderr)
        return 2
    cell = session.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result, lines = session.run(cell, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda", 0),
                                t_start=T_START)
    found = session.forbidden_modules()
    if found:
        print(f"modules that must not load: {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
