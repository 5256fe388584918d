"""One run of one cell: set-up from the seed, the timed window, the traced
stretch, the comparison with the reference, the result line.

A cell (`workloads/<name>.json`) names a configuration
(`configs/<name>.json`), a traffic mix (`traffic/<name>.json`) and the
limits of its comparison. Traffic is data for the one general driver
here, by its `kind`:

- "stream": one lidar stream, open loop: frame k is due at k / rate_hz;
  the host waits for the due time, copies the frame to the card, calls the
  serving entry and copies its detections back (`runtime.serving.to_host`);
  a frame's latency runs from its due time to its detections on the host.
- "closed": batches of `batch` clouds through the system's serving
  pipeline at `depth`; the next batch goes in as soon as the pipeline
  takes it.
"""

import gc
import glob
import json
import os
import sys
import time
import types

import numpy as np
import torch

from .. import counts
from ..reference.model import Quant, Reference, param_spec, spread_head
from . import check, program, spans
from .inputs import cloud_pool, make_weights, sub_seed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "pillarnet_lts_tpu")
STRETCH_FRAMES = 12  # frames of the traced stretch of a stream
STRETCH_REQUESTS = 4  # requests of the traced stretch of a closed loop


def _load(kind, name):
    with open(os.path.join(ROOT, kind, f"{name}.json")) as f:
        return json.load(f)


def cell_names():
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(ROOT, "workloads",
                                                  "*.json")))


def load_cell(name):
    """A cell with its configuration and traffic read in."""
    cell = _load("workloads", name)
    cell["name"] = name
    cell["config"] = dict(_load("configs", cell["config"]),
                          name=cell["config"])
    cell["traffic"] = dict(_load("traffic", cell["traffic"]),
                           name=cell["traffic"])
    return cell


def metric_readers():
    """{metric name: module} of every file in `metrics/`."""
    import importlib.util

    out = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "metrics", "*.py"))):
        name = os.path.basename(path)[:-3]
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def f32_model_cfg(model_cfg):
    """The configuration's network with every layer in f32 (no int8)."""
    m = json.loads(json.dumps(model_cfg))
    m.pop("dtype", None)
    for k in ("reader", "backbone", "neck", "bbox_head"):
        m[k].pop("quant", None)
    return m


def is_quant(model_cfg):
    return any(model_cfg[k].get("quant") for k in ("reader", "backbone",
                                                   "neck", "bbox_head"))


def class_offsets(model_cfg):
    out, at = [], 0
    for t in model_cfg["bbox_head"]["tasks"]:
        out.append(at)
        at += len(t["class_names"])
    return out


class Setup:
    """Everything a run makes from its seed before the window."""

    def __init__(self, cell, seed, device):
        self.phases = [("start", time.perf_counter())]
        cfg, tr = cell["config"], cell["traffic"]
        mc = cfg["model"]
        self.cell, self.seed, self.device = cell, seed, device
        pc = mc["reader"]["pc_range"]
        n = tr["points"]
        self.weights = make_weights(param_spec(mc), seed, device)
        calib_pts, calib_msk = cloud_pool(cfg["calibration_clouds"], n, pc,
                                          sub_seed(seed, 2), tr["nsweeps"])
        self.calib = [(calib_pts[i:i + 1].to(device),
                       calib_msk[i:i + 1].to(device))
                      for i in range(len(calib_pts))]
        self._phase("weights, calibration clouds")
        # the head is spread by the f32 reference on the first cloud
        ref = Reference(f32_model_cfg(mc), cfg["test_cfg"], self.weights)
        with torch.no_grad():
            spread_head(self.weights, ref.forward(*self.calib[0]))
        del ref
        self._phase("head spread (reference forward)")
        self.batch = tr["batch"]
        self.pool_pts, self.pool_msk = cloud_pool(
            tr["pool"] * self.batch, n, pc, sub_seed(seed, 1),
            tr["nsweeps"])
        self._phase("cloud pool")
        self.model, infer = program.build(
            cfg, self.weights, device,
            self.calib if is_quant(mc) else None)
        self.issue = []  # host (start, end) of every call of the entry

        def timed_infer(points, points_mask):
            with _rf("infer"):
                t = time.perf_counter()
                out = infer(points, points_mask)
                self.issue.append((t, time.perf_counter()))
            return out

        self.infer = timed_infer
        self._phase("system built" + (", calibrated" if is_quant(mc)
                                      else ""))

    def _phase(self, name):
        _sync(self.device)
        self.phases.append((name, time.perf_counter()))

    def request(self, i):
        """Request i's clouds, copied to the device as the timed path
        does."""
        k = (i % self.cell["traffic"]["pool"]) * self.batch
        nb = self.device.type == "cuda"
        return (self.pool_pts[k:k + self.batch].to(self.device,
                                                   non_blocking=nb),
                self.pool_msk[k:k + self.batch].to(self.device,
                                                   non_blocking=nb))


def report_phases(phases, t_start):
    print("set-up: imports %.3f s; " % (phases[0][1] - t_start) + "; ".join(
        f"{n} {b - a:.3f} s" for (_, a), (n, b) in zip(phases, phases[1:])),
        file=sys.stderr)


def device_info(device, memory_peak):
    cuda = device.type == "cuda"
    return {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": memory_peak}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rf(name):
    return torch.profiler.record_function(f"bench.{name}")


# ---- the traffic driver -------------------------------------------------

def drive_stream(s, seconds):
    """Open loop: frame k due at t0 + k / rate. Returns per frame
    (due, submit, issued, done) host times and the host detections."""
    tr = s.cell["traffic"]
    period = 1.0 / tr["rate_hz"]
    count = max(1, int(np.ceil(seconds * tr["rate_hz"] - 1e-9)))
    deadline = seconds + 60.0
    recs, dets = [], []
    t0 = time.perf_counter() + 0.01
    for k in range(count):
        due = t0 + k * period
        with _rf("wait"):
            # sleep to 5 ms before the due time, then spin: a sleep's wake
            # can come late by a millisecond or more on a busy host
            left = due - time.perf_counter()
            if left > 5e-3:
                time.sleep(left - 5e-3)
            while time.perf_counter() < due:
                pass
        submit = time.perf_counter()
        if submit - t0 > deadline:
            recs.append((due, submit, submit, float("inf")))
            dets.append(None)
            continue
        with _rf("frame"):
            with _rf("h2d"):
                pts, msk = s.request(k)
            det = s.infer(pts, msk)
            issued = time.perf_counter()
            with _rf("to_host"):
                host = program.to_host(det)
        done = time.perf_counter()
        recs.append((due, submit, issued, done))
        dets.append(host)
    return t0, recs, dets


def drive_closed(s, seconds):
    """Closed loop through the serving pipeline for `seconds`. Returns
    per request (submit, issued, done) host times, and the host
    detections in submission order."""
    tr = s.cell["traffic"]
    pipe = program.pipeline(s.infer, tr["depth"])
    recs, dets = [], []
    t0 = time.perf_counter()
    k = 0

    def take(out):
        recs[len(dets)][2] = time.perf_counter()
        dets.append(out)

    while time.perf_counter() - t0 < seconds:
        submit = time.perf_counter()
        with _rf("h2d"):
            args = s.request(k)
        recs.append([submit, None, None])
        with _rf("pipeline"):
            out = pipe.submit(*args)
        recs[-1][1] = time.perf_counter()
        if out is not None:
            take(out)
        k += 1
    with _rf("pipeline"):
        for out in pipe.drain():
            take(out)
    return t0, recs, dets


def warm_up(s):
    """Run the cell's own shapes until nothing is left to build."""
    tr = s.cell["traffic"]
    if tr["kind"] == "stream":
        for k in range(3):
            program.to_host(s.infer(*s.request(k)))
    else:
        pipe = program.pipeline(s.infer, tr["depth"])
        for _ in pipe.map(s.request(k) for k in range(2 * tr["depth"] + 1)):
            pass
    _sync(s.device)


# ---- the run ------------------------------------------------------------

def percentile(values, q):
    v = np.asarray(values, dtype=np.float64)
    return float(np.percentile(v, q)) if len(v) else float("nan")


def run(cell, seed, seconds, trace, device, t_start=None, fault=None):
    """One run of `cell`. -> (result dict, check lines). `fault`, for the
    tests: a callable that breaks the timed path of the set-up object
    before the window."""
    t_start = time.perf_counter() if t_start is None else t_start
    tr = cell["traffic"]
    if tr["kind"] == "train":
        from .training import run_train

        return run_train(cell, seed, seconds, trace, device, t_start, fault)
    cuda = device.type == "cuda"
    s = Setup(cell, seed, device)
    if fault is not None:
        fault(s)
    warm_up(s)
    s._phase("warm-up")
    setup_s = time.perf_counter() - t_start
    report_phases(s.phases, t_start)
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    hooks = (spans.Spans(s.model, program.layers(s.model), device)
             if trace else None)
    s.issue.clear()
    ctx = types.SimpleNamespace(tag=tr["tag"], layer_ms={}, trace=None)
    if tr["kind"] == "stream":
        t0, recs, dets = drive_stream(s, seconds)
        lat = [(done - due) * 1e3 for due, _, _, done in recs]
        attempted = len(recs)
        done_idx = [k for k, d in enumerate(dets) if d is not None]
        failed = attempted - len(done_idx)
        e2e = {"latency_p95_ms": (percentile(lat, 95), "ms")}
        ctx.queue_wait_ms = [(sub - due) * 1e3 for due, sub, _, _ in recs]
        ctx.service_s = sum(done - sub for _, sub, _, done in recs
                            if done != float("inf"))
        frames_done = answered = [(k, 0) for k in done_idx]
        service = [(done - sub) * 1e3 for _, sub, _, done in recs]
        print(f"latency parts: due to submission p50 "
              f"{percentile(ctx.queue_wait_ms, 50):.3f} p95 "
              f"{percentile(ctx.queue_wait_ms, 95):.3f} ms; service p50 "
              f"{percentile(service, 50):.3f} p95 "
              f"{percentile(service, 95):.3f} ms", file=sys.stderr)
    else:
        t0, recs, dets = drive_closed(s, seconds)
        in_window = [k for k, r in enumerate(recs) if r[2] - t0 <= seconds]
        attempted = len(recs) * s.batch
        failed = 0
        e2e = {"frames_per_s": (len(in_window) * s.batch / seconds,
                                "frames/s")}
        ctx.service_s = seconds
        frames_done = [(k, b) for k in in_window for b in range(s.batch)]
        # every request the window submitted is answered (the drain waits
        # for the last); the comparison draws from all of them
        answered = [(k, b) for k in range(len(dets)) for b in range(s.batch)]
    ctx.host_issue_ms = [(b - a) * 1e3 for a, b in s.issue]
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx.peak_window_bytes = window_peak
    memory_peak = max(peak_setup, window_peak)
    result = {"correct": False, "attempted": attempted, "failed": failed}
    dev_info = device_info(device, memory_peak)
    if trace:
        _sync(device)
        for name in hooks.marks:
            ctx.layer_ms[name] = hooks.ms(name)
        ctx.min_s_done = _min_seconds(s, frames_done)
        if cuda:
            ctx.trace = _traced_stretch(s)
            dev_info["busy_s"] = ctx.trace["busy_s"]
            dev_info["window_s"] = ctx.trace["window_s"]
        hooks.detach()
    # the reference, once the window has closed and the program is freed
    sample = _sample(s, answered, dets)
    del s.model, s.infer, hooks
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    values = _compare(s, sample)
    return assemble(cell, values, len(sample), "frames_compared", result,
                    ctx, trace, e2e, setup_s, dev_info)


def assemble(cell, values, compared, compared_name, result, ctx, trace,
             e2e, setup_s, dev_info):
    """The result line and the check lines of a run: the compared numbers
    against the cell's limits, the end-to-end metrics (or, traced, the
    per-layer metrics the readers find and the breakdown)."""
    limits = cell["limits"]
    failed = result["failed"]
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in values.items()}
    result["correct"] = bool(failed == 0 and compared and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values()))
    if trace:
        metrics = {}
        for name, mod in metric_readers().items():
            v = mod.read(ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": mod.UNIT}
        result["metrics"] = metrics
    else:
        e2e["setup_s"] = (setup_s, "s")
        result["metrics"] = {k: {"value": v, "unit": u}
                             for k, (v, u) in e2e.items()}
    result["device"] = dev_info
    if trace and ctx.trace is not None:
        result["breakdown"] = {
            "device_ops": [[g, v] for g, v in ctx.trace["groups"][:10]],
            "idle_gaps": [[g, v] for g, v in ctx.trace["gaps"][:10]]}
    result["checks"] = checks
    lines = [f"{k} {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    lines.append(f"{compared_name} {compared} limit >= 1")
    lines.append(f"failed {failed} limit 0")
    return result, lines


def _min_seconds(s, frames_done):
    """The least time of the frames done in the window (`counts`), each
    pool cloud counted once and looked up."""
    mc = s.cell["config"]["model"]
    per = {}
    total = 0.0
    for k, b in frames_done:
        i = (k % s.cell["traffic"]["pool"]) * s.batch + b
        if i not in per:
            pts = s.pool_pts[i:i + 1].to(s.device)
            msk = s.pool_msk[i:i + 1].to(s.device)
            per[i] = float(counts.min_seconds(counts.frame_ops(mc, pts,
                                                               msk))[0])
        total += per[i]
    return total


def _traced_stretch(s):
    """A short steady stretch under the profiler: a stream's next
    `STRETCH_FRAMES` frames at its rate, or `STRETCH_REQUESTS` requests
    through the pipeline. -> `spans.reduce_trace` of it, with the K4
    bound and kernel time of the stretch."""
    tr = s.cell["traffic"]
    mc = s.cell["config"]["model"]
    if tr["kind"] == "stream":
        seconds = STRETCH_FRAMES / tr["rate_hz"]
        kernels, ranges, lost = spans.profiled(
            lambda: drive_stream(s, seconds))
        windows = [(a, b) for n, a, b in ranges if n == "frame"]
        requests = [k % tr["pool"] for k in range(len(windows))]
    else:
        def stretch():
            pipe = program.pipeline(s.infer, tr["depth"])
            with _rf("stretch"), _rf("pipeline"):
                for _ in pipe.map(s.request(k)
                                  for k in range(STRETCH_REQUESTS)):
                    pass
        kernels, ranges, lost = spans.profiled(stretch)
        windows = [(a, b) for n, a, b in ranges if n == "stretch"]
        requests = [k % tr["pool"] for k in range(STRETCH_REQUESTS)]
    out = spans.reduce_trace(kernels, ranges, windows)
    out["lost"] = lost
    out["requests"] = len(requests)
    out["k4_kernel_s"] = dict(out["groups"]).get("K4 int8_conv", 0.0)
    bound = 0.0
    if is_quant(mc):
        for i in requests:
            k = i * s.batch
            pts = s.pool_pts[k:k + s.batch].to(s.device)
            msk = s.pool_msk[k:k + s.batch].to(s.device)
            bound += sum(t for _, t, _ in counts.k4_calls(mc, pts, msk))
    out["k4_bound_s"] = bound
    return out


def _sample(s, frames_done, dets):
    """The frames whose detections are compared: `sample_frames` drawn
    from the seed among the frames done, in request order. -> [(pool
    index, host detections of the frame)]."""
    tr = s.cell["traffic"]
    rng = np.random.default_rng(sub_seed(s.seed, 3))
    want = min(tr["sample_frames"], len(frames_done))
    if tr["kind"] == "stream":
        picks = sorted(rng.choice(len(frames_done), want, replace=False))
        chosen = [frames_done[i] for i in picks]
    else:
        # whole requests, so that every slot of a batch is compared
        reqs = sorted({k for k, _ in frames_done})
        n_req = max(1, want // s.batch)
        picks = sorted(rng.choice(len(reqs), min(n_req, len(reqs)),
                                  replace=False))
        chosen = [(reqs[i], b) for i in picks for b in range(s.batch)]
    out = []
    for k, b in chosen:
        frames = check.split_frames(dets[k])
        out.append(((k % tr["pool"]) * s.batch + b, frames[b]))
    return out


def reference_for(s, qmax=127):
    """The configuration's reference over the run's weights; an int8
    configuration calibrates its own scales on the calibration clouds."""
    cfg = s.cell["config"]
    mc = cfg["model"]
    quant = Quant(qmax) if is_quant(mc) else None
    ref = Reference(mc, cfg["test_cfg"], s.weights, quant)
    if quant is not None:
        ref.calibrate(s.calib)
    return ref


def reference_frames(s, ref, pool_idx):
    """The reference's detections of pool frames `pool_idx`, a request's
    batch of frames at a time."""
    out = []
    for i in range(0, len(pool_idx), s.batch):
        idx = torch.tensor(pool_idx[i:i + s.batch])
        pts = s.pool_pts[idx].to(s.device)
        msk = s.pool_msk[idx].to(s.device)
        out.extend(ref.detect(pts, msk))
    return out


def _compare(s, sample):
    program.set_tf32(False)
    t = time.perf_counter()
    ref = reference_for(s)
    ref_frames = reference_frames(s, ref, [i for i, _ in sample])
    out = check.readings([d for _, d in sample], ref_frames,
                         class_offsets(s.cell["config"]["model"]))
    print(f"reference: {len(sample)} frames in "
          f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def listing():
    """What the harness finds by name: cells (with their configuration
    and traffic), configurations, traffic mixes and per-layer metrics."""
    names = {}
    for kind in ("configs", "traffic"):
        names[kind] = sorted(os.path.basename(p)[:-5] for p in glob.glob(
            os.path.join(ROOT, kind, "*.json")))
    names["workloads"] = {c: {k: _load("workloads", c)[k]
                              for k in ("config", "traffic", "chips")}
                          for c in cell_names()}
    names["metrics"] = sorted(os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(ROOT, "metrics", "*.py")))
    return names
