"""The longest idle gaps of a cell's device, each put down to what the host
was doing: the benchmark's `bench.*` span (as the result line's
`breakdown` labels it), the innermost span of the system's own tracer
(`pillarnet.*`: `pillarnet_lts_torch/runtime/tracing.py` enters a
`record_function` range per span while a profiler records) and the
innermost operator (`aten::`, or a hand kernel's `pillarnet::` op), each at
the gap's middle.

    python3 benchmark/tools/gaps.py --workload <cell> --seed <n> [--top 10]

Set-up and warm-up as a run of the cell; then, with the benchmark's layer
hooks attached as in a traced run, a short stretch under `torch.profiler`
(a stream's next 12 frames at its rate, 4 requests through the pipeline,
or 2 training steps) reduced by `harness/spans.py::reduce_trace` once per
kind of label. Prints the gaps, then one JSON line with them and the
device's busy share. Needs the card.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

PREFIXES = ("bench.", "pillarnet.", "aten::", "pillarnet::")


def profiled(fn):
    """`spans.profiled` keeping every host range the labels need: the
    benchmark's (`bench.` taken off, as there), the system's
    (`pillarnet.*`) and the operators' (`aten::*`, `pillarnet::*`). ->
    (kernels, ranges, the share of device events lost)."""
    import torch
    from torch.autograd import DeviceType

    from benchmark.harness import spans

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    best = None
    for _ in range(spans.TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            spans._prime()
            fn()
            torch.cuda.synchronize()
            spans._prime()
        kernels, ranges, launches = [], [], 0
        for e in prof.events():
            user = getattr(e, "is_user_annotation", False)
            if e.device_type == DeviceType.CUDA and not user:
                if spans.PRIMER not in e.name:
                    kernels.append((e.name, e.time_range.start,
                                    e.time_range.end))
            elif e.device_type == DeviceType.CPU:
                if e.name.startswith(PREFIXES):
                    name = (e.name[6:] if e.name.startswith("bench.")
                            else e.name)
                    ranges.append((name, e.time_range.start,
                                   e.time_range.end))
                elif any(k in e.name for k in spans.LAUNCH_CALLS):
                    launches += 1
        lost = max(launches - 2 * spans.PRIMERS - len(kernels), 0)
        share = lost / max(launches - 2 * spans.PRIMERS, 1)
        if best is None or share < best[2]:
            best = (kernels, ranges, share)
        if not lost:
            break
    return best


def _serving_stretch(cell, seed, device):
    from benchmark.harness import program, session, spans

    s = session.Setup(cell, seed, device)
    session.warm_up(s)
    hooks = spans.Spans(s.model, program.layers(s.model), device)
    tr = cell["traffic"]
    if tr["kind"] == "stream":
        seconds = session.STRETCH_FRAMES / tr["rate_hz"]
        out = profiled(lambda: session.drive_stream(s, seconds))
        window = "frame"
    else:
        def stretch():
            pipe = program.pipeline(s.infer, tr["depth"])
            with session._rf("stretch"), session._rf("pipeline"):
                for _ in pipe.map(s.request(k) for k in
                                  range(session.STRETCH_REQUESTS)):
                    pass
        out = profiled(stretch)
        window = "stretch"
    hooks.detach()
    return out, window


def _train_stretch(cell, seed, device):
    from benchmark.harness import session, training

    s = training.TrainSetup(cell, seed, device)
    checked = cell["traffic"]["checked_steps"]
    for k in range(checked):
        float(s.step(s.feed(k))["loss"])
    hooks = training._TrainSpans(s, device)

    def stretch():
        with session._rf("stretch"):
            for i in range(training.STRETCH_STEPS):
                with session._rf("step"):
                    m = s.step(s.feed(checked + i))
                float(m["loss"])

    out = profiled(stretch)
    hooks.detach()
    return out, "stretch"


def gap_intervals(kernels, windows):
    """(start, end) of every idle gap of the device inside `windows`, in
    the order of `reduce_trace`'s gaps (longest first)."""
    from benchmark.harness.spans import clip, union

    windows = union(windows)
    busy = union(clip(union((s, e) for _, s, e in kernels), windows))
    out = []
    for ws, we in windows:
        inside = [iv for iv in busy if iv[1] > ws and iv[0] < we]
        edges = [ws] + [x for iv in inside for x in iv] + [we]
        out += [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    out.sort(key=lambda g: -(g[1] - g[0]))
    return out


def innermost(ranges, t):
    """The name of the shortest range holding time t, or "host"."""
    held = [(e - s, n) for n, s, e in ranges if s <= t <= e]
    return min(held)[1] if held else "host"


def labelled_gaps(kernels, ranges, window, top):
    """The `top` longest idle gaps inside the `window` ranges, each with
    its ms and three labels: the benchmark's span and the system's
    (`reduce_trace`'s labels over each set of ranges), and the operator
    the host was in. -> (rows, busy s, window s)."""
    from benchmark.harness.spans import reduce_trace

    windows = [(a, b) for n, a, b in ranges if n == window]
    ops = [r for r in ranges if r[0].startswith(("aten::", "pillarnet::"))]
    program = [r for r in ranges if r[0].startswith("pillarnet.")]
    bench = [r for r in ranges if not r[0].startswith(PREFIXES[1:])]
    by_bench = reduce_trace(kernels, bench, windows)
    by_program = reduce_trace(kernels, program, windows)
    rows = []
    for (label, sec), (span, _), (a, b) in zip(
            by_bench["gaps"][:top], by_program["gaps"],
            gap_intervals(kernels, windows)):
        if abs((b - a) * 1e-6 - sec) > 1e-9:
            raise RuntimeError("gap order differs from reduce_trace's")
        rows.append({"ms": sec * 1e3, "bench": label, "program": span,
                     "op": innermost(ops, (a + b) / 2)})
    return rows, by_bench["busy_s"], by_bench["window_s"]


def main(argv=None):
    import argparse

    import torch

    from benchmark.harness import session

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gaps.py needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    cell = session.load_cell(args.workload)
    device = torch.device("cuda", 0)
    stretch = (_train_stretch if cell["traffic"]["kind"] == "train"
               else _serving_stretch)
    (kernels, ranges, lost), window = stretch(cell, args.seed, device)
    rows, busy_s, window_s = labelled_gaps(kernels, ranges, window, args.top)
    print(f"{args.workload}: busy {busy_s * 1e3:.2f} of "
          f"{window_s * 1e3:.2f} ms ({100 * busy_s / window_s:.2f}%), "
          f"lost events {lost:.4f}; the {len(rows)} longest idle gaps:")
    for i, r in enumerate(rows, 1):
        print(f"{i:3d} {r['ms']:8.3f} ms  bench {r['bench']:<10s} "
              f"program {r['program']:<28s} op {r['op']}")
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": torch.cuda.get_device_name(device),
                      "busy_s": busy_s, "window_s": window_s,
                      "lost": lost, "gaps": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
