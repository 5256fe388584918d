"""Spans around the calls into the system's layers, and the device trace
of a short steady stretch.

`Spans` hooks the detector's layer modules (and wraps `predict`) from the
benchmark's side: CUDA events around each call for its device time, and a
`record_function` range named `bench.<layer>` so that the profiler's
timeline knows what the host was doing. `profiled` is a copy of the
system's profiler session (`chip_smoke.profiled`): primer kernels on each
side, a session that lost device events taken again, the one that lost
the fewest kept. `GROUPS` is a copy of its kernel groups.
"""

import time

import torch

PRIMER = "spin_kernel"  # torch.cuda._sleep's kernel, which pads a session
PRIMERS = 8
TRIES = 3
LAUNCH_CALLS = ("LaunchKernel", "cuLaunch", "Memset", "Memcpy")

GROUPS = (("K1' pillar_scatter_max_tiled", ("scatter_max_sorted",
                                            "SortedRuns")),
          ("K1 pillar_scatter_max", ("scatter_max_claim", "scatter_max_merge",
                                     "ClaimedPillars")),
          ("K2 rotated_overlap", ("rotated_overlap",)),
          ("K3 suppression_mask", ("suppression_mask",)),
          ("K4 int8_conv", ("int8_conv_kernel",)),
          ("K5 int8_stage", ("int8_stage_kernel",)),
          ("index_select", ("indexSelect", "vectorized_gather")),
          ("conv", ("conv", "implicit_gemm", "cudnn", "winograd", "fft",
                    "cf32", "dgrad", "wgrad", "fprop")),
          ("gemm", ("gemm", "gemv")),
          ("transpose", ("nchwToNhwc", "nhwcToNchw", "transpose")),
          ("memcpy", ("memcpy", "Memcpy")),
          ("elementwise", ("elementwise", "vectorized", "reduce")))


def group_of(kernel):
    low = kernel.lower()
    for g, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return g
    return "other"


class Timer:
    """A pair of marks on the device's timeline (CUDA events), or on the
    host's clock for a CPU run."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b):
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class Spans:
    """Per layer, the (start, end) marks of every call while attached;
    `ms(layer)` gives their durations once the device has finished."""

    def __init__(self, model, layers, device):
        self.timer = Timer(device)
        self.marks = {}
        self.handles = []
        self.model = model
        for name, first, last in layers:
            self.marks[name] = []
            self.handles.append(first.register_forward_pre_hook(
                self._enter(name)))
            self.handles.append(last.register_forward_hook(self._exit(name)))
        self.marks["predict"] = []
        predict = model.predict

        def timed_predict(*args, **kwargs):
            rf = torch.profiler.record_function("bench.predict")
            rf.__enter__()
            start = self.timer.mark()
            try:
                return predict(*args, **kwargs)
            finally:
                self.marks["predict"].append((start, self.timer.mark()))
                rf.__exit__(None, None, None)

        model.predict = timed_predict
        self._open = {}

    def _enter(self, name):
        def hook(module, args):
            rf = torch.profiler.record_function(f"bench.{name}")
            rf.__enter__()
            self._open[name] = (self.timer.mark(), rf)
        return hook

    def _exit(self, name):
        def hook(module, args, out):
            start, rf = self._open.pop(name)
            self.marks[name].append((start, self.timer.mark()))
            rf.__exit__(None, None, None)
        return hook

    def detach(self):
        for h in self.handles:
            h.remove()
        del self.model.predict  # back to the class's method

    def ms(self, name):
        return [self.timer.ms(a, b) for a, b in self.marks[name]]


def _prime():
    for _ in range(PRIMERS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def profiled(fn):
    """Run fn() under `torch.profiler` and return its timeline: kernels
    [(name, start_us, end_us)] without the primers, host ranges
    [(name, start_us, end_us)] of the `bench.*` spans, and the share of
    device events the kept session lost."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    best = None
    for _ in range(TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            _prime()
            fn()
            torch.cuda.synchronize()
            _prime()
        events = prof.events()
        kernels, ranges, launches, primed = [], [], 0, 0
        for e in events:
            user = getattr(e, "is_user_annotation", False)
            if e.device_type == DeviceType.CUDA and not user:
                if PRIMER in e.name:
                    primed += 1
                else:
                    kernels.append((e.name, e.time_range.start,
                                    e.time_range.end))
            elif e.device_type == DeviceType.CPU:
                if e.name.startswith("bench."):
                    ranges.append((e.name[6:], e.time_range.start,
                                   e.time_range.end))
                elif any(k in e.name for k in LAUNCH_CALLS):
                    launches += 1
        lost = max(launches - 2 * PRIMERS - len(kernels), 0)
        share = lost / max(launches - 2 * PRIMERS, 1)
        if best is None or share < best[2]:
            best = (kernels, ranges, share)
        if not lost:
            break
    return best


def union(intervals):
    """Merge (start, end) intervals -> sorted disjoint list."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clip(intervals, windows):
    """The parts of disjoint `intervals` inside the disjoint `windows`."""
    out = []
    for ws, we in windows:
        for s, e in intervals:
            a, b = max(s, ws), min(e, we)
            if b > a:
                out.append((a, b))
    return out


def reduce_trace(kernels, ranges, windows):
    """The device's busy time inside `windows` (host ranges in the trace's
    microseconds), the kernel time by group, and the longest idle gaps
    inside the windows, each labelled by the innermost `bench.*` span the
    host was in at the gap's middle. -> dict of seconds."""
    windows = union(windows)
    busy_iv = union(clip(union((s, e) for _, s, e in kernels), windows))
    busy = sum(e - s for s, e in busy_iv)
    total = sum(e - s for s, e in windows)
    groups = {}
    for name, s, e in kernels:
        for a, b in clip([(s, e)], windows):
            g = group_of(name)
            groups[g] = groups.get(g, 0.0) + (b - a) * 1e-6
    gaps = []
    for ws, we in windows:
        inside = [iv for iv in busy_iv if iv[1] > ws and iv[0] < we]
        edges = [ws] + [x for iv in inside for x in iv] + [we]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                mid = (a + b) / 2
                spans = [(s, e, n) for n, s, e in ranges
                         if s <= mid <= e and n not in ("frame", "stretch")]
                label = (min(spans, key=lambda t: t[1] - t[0])[2]
                         if spans else "host")
                gaps.append((label, (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return {"busy_s": busy * 1e-6, "window_s": total * 1e-6,
            "groups": sorted(groups.items(), key=lambda g: -g[1]),
            "gaps": gaps}
