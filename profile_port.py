#!/usr/bin/env python3
"""Where the time goes in the PyTorch port, flagship configs, one CUDA card.

Run from the repository root on a machine with the card:

    python3 profile_port.py [--config CONFIG] [--fused] [--out record.json]

Builds a config (default `configs/pillarnet/pillarnet34_nusc.py`) with
seeded random weights (head outputs spread as in `chip_smoke.py`; an int8
config is then calibrated on 4 synthetic clouds, with `--fused` running its
stride-1 stage on the fused kernel), serves 262,144-point synthetic clouds
and reports, after 3 warm-up requests:

  - FLOPs of one bs=1 request (`torch.utils.flop_counter`; it does not see
    the port's own kernels, so an int8 config's count is its bf16 ops only);
  - per-stage device time (CUDA events around each module; median of 10):
    reader, backbone and its conv1..conv5, neck, head, predict;
  - kernel time by kernel over 5 requests (`torch.profiler`), grouped into
    the port's kernels, convolutions, elementwise, layout transposes and the
    rest, with the device's busy share of the window;
  - serial frames/s at pipeline depth 1 and 3, and per-request latency at
    bs=2 and bs=4.

The summary names the card's `nvidia-smi` name and power limit; `--out`
takes the full record as JSON.
"""

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict

import torch

from chip_smoke import FLAGSHIP, ROOT, card_line

GROUPS = (("K1 pillar_scatter_max", ("scatter_max", "decode_ordered")),
          ("K2 rotated_overlap", ("rotated_overlap",)),
          ("K4 int8_conv", ("int8_conv_kernel",)),
          ("K5 int8_stage", ("int8_stage_kernel",)),
          ("conv", ("conv", "xmma", "implicit_gemm", "cudnn", "winograd")),
          ("transpose", ("nchwToNhwc", "nhwcToNchw", "transpose")),
          ("elementwise", ("elementwise", "vectorized", "reduce")))


class StageTimer:
    """CUDA events around the top-level stage modules of a PillarNet."""

    def __init__(self, model):
        self.events, self.open = [], []
        mods = [("reader", model.reader_net), ("backbone", model.backbone_net)]
        for name, mod in model.backbone_net.named_children():
            mods.append((name.split("_")[0], mod))  # conv1_block0 -> conv1
        mods += [("neck", model.neck_net), ("head", model.head_net)]
        self.handles = []
        for stage, mod in mods:
            self.handles += [mod.register_forward_pre_hook(self._pre(stage)),
                             mod.register_forward_hook(self._post)]

    def _pre(self, stage):
        def hook(mod, args):
            ev = [stage, torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)]
            ev[1].record()
            self.events.append(ev)
            self.open.append(ev)
        return hook

    def _post(self, mod, args, out):
        self.open.pop()[2].record()  # the backbone nests its stages

    def remove(self):
        for h in self.handles:
            h.remove()

    def take(self):
        torch.cuda.synchronize()
        ms = defaultdict(float)
        for stage, start, end in self.events:
            ms[stage] += start.elapsed_time(end)
        self.events = []
        return ms


def kernel_table(prof):
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, us / 1e3, e.count))
    return sorted(rows, key=lambda r: -r[1])


def group_of(kernel):
    low = kernel.lower()
    for g, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return g
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=FLAGSHIP)
    ap.add_argument("--fused", action="store_true",
                    help="int8: the stride-1 stage on the fused kernel")
    ap.add_argument("--out", help="write the full record here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from __graft_entry__ import _synth_points_realistic
    from torch.utils.flop_counter import FlopCounterMode

    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.runtime.quantize import calibrate, observers
    from pillarnet_lts_torch.runtime.serving import ServingPipeline

    card = card_line()
    dev = torch.device("cuda", 0)
    cfg = load_config(args.config)
    cfg["model"]["backbone"]["s2d_pallas"] = args.fused
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    model = build_model_from_cfg(cfg, device=dev, seed=0)

    def cloud(batch, seed):
        pts, msk = _synth_points_realistic(batch, n, pc_range, seed=seed)
        return torch.from_numpy(pts).to(dev), torch.from_numpy(msk).to(dev)

    spread_head_outputs(model, *cloud(1, 99))
    if observers(model):
        calibrate(model, [cloud(1, s) for s in (90, 91, 92, 93)])
    infer = make_infer_fn(model)
    clouds = [cloud(1, s) for s in range(10)]
    for c in clouds[:3]:
        infer(*c)
    torch.cuda.synchronize()
    rec = {"card": card, "config": args.config, "fused": args.fused}

    with FlopCounterMode(display=False) as fc:
        infer(*clouds[0])
    rec["gflop_per_frame"] = fc.get_total_flops() / 1e9

    timer = StageTimer(model)
    per_stage = defaultdict(list)
    for c in clouds:
        with torch.inference_mode():
            preds = model(*c)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            model.predict({}, preds)
            end.record()
        for s, v in timer.take().items():
            per_stage[s].append(v)
        per_stage["predict"].append(start.elapsed_time(end))
    rec["stage_ms"] = {s: statistics.median(v) for s, v in per_stage.items()}
    timer.remove()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in clouds[:5]:
            infer(*c)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    rows = kernel_table(prof)
    groups = defaultdict(float)
    for k, ms, _ in rows:
        groups[group_of(k)] += ms
    busy = sum(groups.values())
    rec["profile_5_requests"] = {
        "window_ms": window, "kernel_ms": busy,
        "groups_ms": dict(groups),
        "top_kernels": [dict(name=k, ms=ms, count=c) for k, ms, c in rows[:20]]}

    fps = {}
    for depth in (1, 3):
        pipe = ServingPipeline(infer, depth=depth)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        list(pipe.map(clouds))
        fps[depth] = len(clouds) / (time.perf_counter() - t0)
    rec["serial_fps_by_depth"] = fps
    lat = {}
    for bs in (2, 4):
        batch = cloud(bs, 20 + bs)
        infer(*batch)
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            infer(*batch)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        lat[bs] = statistics.median(ts)
    rec["request_ms_by_batch"] = lat
    rec["peak_allocated_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30

    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(f"card: {card}; {args.config}, fused stage {args.fused}")
    print(f"GFLOP per bs=1 frame: {rec['gflop_per_frame']:.1f}")
    print("stage ms (median of 10): " + ", ".join(
        f"{s} {v:.2f}" for s, v in rec["stage_ms"].items()))
    print(f"5 requests: kernel time {busy:.1f} ms in a {window:.1f} ms "
          f"window (busy {100 * busy / window:.1f}%); by group: " + ", ".join(
              f"{g} {v:.2f} ms" for g, v in sorted(groups.items(),
                                                   key=lambda x: -x[1])))
    for k, ms, c in rows[:8]:
        print(f"  {ms:9.2f} ms  x{c:<5d} {k[:110]}")
    print(f"serial frames/s: depth 1 {fps[1]:.2f}, depth 3 {fps[3]:.2f}; "
          f"request ms: bs=2 {lat[2]:.2f}, bs=4 {lat[4]:.2f}; peak "
          f"allocated {rec['peak_allocated_gib']:.3f} GiB; card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
