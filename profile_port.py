#!/usr/bin/env python3
"""Where the time goes in the PyTorch port, flagship configs, one CUDA card.

Run from the repository root on a machine with the card:

    python3 profile_port.py [--config CONFIG] [--fused] [--tiled]
                            [--mask-kernel] [--train] [--out record.json]

Builds a config (default `configs/pillarnet/pillarnet34_nusc.py`) with
seeded random weights (head outputs spread as in `chip_smoke.py`; an int8
config is then calibrated on 4 synthetic clouds, with `--fused` running its
stride-1 stage on the fused kernel), serves synthetic clouds of the
config's `max_points` and `nsweeps` (nuScenes 262,144 points in 10 sweeps,
Waymo 196,608 in one) and reports, after 3 warm-up requests:

  - FLOPs of one bs=1 request (`torch.utils.flop_counter`; it does not see
    the port's own kernels, so an int8 config's count is its bf16 ops only);
  - per-stage device ms, median of 10 requests, from the port's tracer at
    its `device` level (`pillarnet_lts_torch/runtime/tracing.py`: CUDA
    events at the ends of each span): the request (`serving.request`),
    reader, backbone and its `backbone.conv1`..`backbone.conv5`, neck,
    head, predict; for a two-stage config
    (`configs/pillarrcnn/pillarrcnn18_waymo.py`) those of its first stage
    and the second stage's `roi_pool`, `point_head`, `roi_head`; and each
    span's host ms (the host's issue);
  - kernel time by kernel over 5 requests (`torch.profiler`), grouped into
    the port's kernels, convolutions, GEMMs, the second stage's
    `index_select` gathers, elementwise, layout transposes and the rest,
    with the device's busy share of the window;
  - serial frames/s at pipeline depth 1 and 3, and per-request latency at
    bs=2 and bs=4.

`--tiled` serves with `ops.scatter.set_backend("tiled")` (the sorted-run
scatter-max), `--mask-kernel` with `test_cfg.nms.use_mask_kernel` (the
suppression-mask kernel).

`--train` profiles a training step of the config instead (a two-stage
config too: `--config configs/pillarrcnn/pillarrcnn18_waymo.py`, each
step with its own generator for the RoI sampler and dropout), at its
`samples_per_gpu`, on seeded synthetic scenes with every class
(`datasets.SynthDataset`): after 2 warm-up steps, the forward with the
losses, the backward and the optimizer step (the tracer's `train.*`
spans at the `device` level, median of 3),
kernel time by group over 2 steps (`torch.profiler`) with the busy share
of their window, samples/s and peak memory; then the same with the
backbone's `remat` off, for what remat costs and saves.

The summary names the card's `nvidia-smi` name and power limit; `--out`
takes the full record as JSON.
"""

import argparse
import json
import statistics
import sys
import time

import torch

from chip_smoke import FLAGSHIP, ROOT, card_line, group_table, profiled


def traced(kind, fn, times):
    """Run fn() `times` times at the tracer's `device` level, each run
    synced; -> the median host and device ms of each span name in the
    `kind` requests they made (`runtime/tracing.py::summary`)."""
    from pillarnet_lts_torch.runtime import tracing

    prev = tracing.configure("device")
    t0 = time.perf_counter_ns()
    try:
        for _ in range(times):
            fn()
            torch.cuda.synchronize()
        return tracing.summary(kind, since_ns=t0)
    finally:
        tracing.configure(prev)

def train_profile(cfg, dev, remat):
    """Step phases, kernel groups, samples/s and peak memory of training
    `cfg` with the backbone's `remat` set as given."""
    from pillarnet_lts_torch.apis import build_model_from_cfg, optimizer_from_cfg
    from pillarnet_lts_torch.datasets import SynthDataset, collate_batch
    from pillarnet_lts_torch.runtime.train_step import (
        batch_to_device, step_generator, train_step)

    det = cfg["model"].get("first_stage_cfg", cfg["model"])
    det["backbone"] = dict(det["backbone"], remat=remat)
    bs = cfg["data"]["samples_per_gpu"]
    ds = SynthDataset(cfg, bs, cfg["data"]["max_points"], seed=200,
                      num_boxes=(10, 21))
    batch = batch_to_device(collate_batch([ds[i] for i in range(bs)],
                                          cfg["data"]["max_points"]), dev)
    model = build_model_from_cfg(cfg, device=dev, seed=0)
    opt = optimizer_from_cfg(model, cfg, 100)
    steps = iter(range(1000))

    def gen():
        return step_generator(0, next(steps), dev)

    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):
        train_step(model, opt, batch, cfg["train_cfg"], gen())
    spans = traced("train.step", lambda: train_step(
        model, opt, batch, cfg["train_cfg"], gen()), 3)

    def phase_ms(clock):
        ms = {k: v[clock] for k, v in spans.items()}
        return {"step": ms["train.step"],
                "forward": ms["train.forward"] + ms["train.loss"],
                "backward": ms["train.backward"],
                "optimizer": ms["train.optimizer"]}

    phases = phase_ms("device_ms")

    def two_steps():
        t0 = time.perf_counter()
        for _ in range(2):
            train_step(model, opt, batch, cfg["train_cfg"], gen())
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    rows, window, lost = profiled(two_steps)
    groups = group_table(rows)
    return {"remat": remat, "batch": bs, "phase_ms": phases,
            "phase_host_ms": phase_ms("host_ms"),
            "samples_per_s": bs / phases["step"] * 1e3,
            "peak_allocated_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "profile_2_steps": {
                "window_ms": window, "kernel_ms": sum(groups.values()),
                "lost_events": lost, "groups_ms": groups,
                "top_kernels": [dict(name=k, ms=ms, count=c)
                                for k, ms, c in rows[:25]]}}


def profile_training(args):
    from pillarnet_lts_torch.apis import load_config

    card = card_line()
    dev = torch.device("cuda", 0)
    rec = {"card": card, "config": args.config, "train": []}
    for remat in (True, False):
        try:
            r = train_profile(load_config(args.config), dev, remat)
        except torch.cuda.OutOfMemoryError as e:
            r = {"remat": remat, "error": f"out of memory: {e}"}
        rec["train"].append(r)
        torch.cuda.empty_cache()
        if "error" in r:
            print(f"remat {remat}: {r['error'][:200]}")
            continue
        p, h, prof = r["phase_ms"], r["phase_host_ms"], r["profile_2_steps"]
        print(f"remat {remat}, bs={r['batch']}: step {p['step']:.1f} ms "
              f"(forward + losses {p['forward']:.1f}, backward "
              f"{p['backward']:.1f}, optimizer {p['optimizer']:.1f}; device "
              f"ms, medians of 3; host ms in each: step {h['step']:.1f}, "
              f"forward + losses {h['forward']:.1f}, backward "
              f"{h['backward']:.1f}, optimizer {h['optimizer']:.1f}), "
              f"{r['samples_per_s']:.3f} samples/s, peak allocated "
              f"{r['peak_allocated_gib']:.3f} GiB; 2 steps: kernel time "
              f"{prof['kernel_ms']:.1f} ms in a {prof['window_ms']:.1f} ms "
              f"window (busy {100 * prof['kernel_ms'] / prof['window_ms']:.1f}"
              f"%); by group: " + ", ".join(
                  f"{g} {v:.1f} ms" for g, v in sorted(
                      prof["groups_ms"].items(), key=lambda x: -x[1])))
        for k in prof["top_kernels"][:8]:
            print(f"  {k['ms']:9.2f} ms  x{k['count']:<5d} {k['name'][:110]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(f"card: {card}")
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=FLAGSHIP)
    ap.add_argument("--fused", action="store_true",
                    help="int8: the stride-1 stage on the fused kernel")
    ap.add_argument("--tiled", action="store_true",
                    help="the sorted-run scatter-max (set_backend('tiled'))")
    ap.add_argument("--mask-kernel", action="store_true",
                    help="NMS masks from the suppression-mask kernel")
    ap.add_argument("--train", action="store_true",
                    help="profile a training step instead of serving")
    ap.add_argument("--out", help="write the full record here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if args.train:
        return profile_training(args)
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from torch.utils.flop_counter import FlopCounterMode

    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.ops import scatter
    from pillarnet_lts_torch.runtime.quantize import calibrate, observers
    from pillarnet_lts_torch.runtime.serving import ServingPipeline

    card = card_line()
    dev = torch.device("cuda", 0)
    cfg = load_config(args.config)
    first = cfg["model"].get("first_stage_cfg", cfg["model"])
    first["backbone"]["s2d_pallas"] = args.fused
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    nsweeps = cfg.get("nsweeps", 10)
    model = build_model_from_cfg(cfg, device=dev, seed=0)

    def cloud(batch, seed):
        pts, msk = synth_points_realistic(batch, n, pc_range, seed=seed,
                                           nsweeps=nsweeps)
        return torch.from_numpy(pts).to(dev), torch.from_numpy(msk).to(dev)

    spread_head_outputs(model, *cloud(1, 99))
    if observers(model):
        calibrate(model, [cloud(1, s) for s in (90, 91, 92, 93)])
    test_cfg = model.processed_test_cfg()
    if args.mask_kernel:
        test_cfg["nms"] = dict(test_cfg["nms"], use_mask_kernel=True)
    scatter.set_backend("tiled" if args.tiled else "auto")
    infer = make_infer_fn(model, test_cfg)
    clouds = [cloud(1, s) for s in range(10)]
    for c in clouds[:3]:
        infer(*c)
    torch.cuda.synchronize()
    rec = {"card": card, "config": args.config, "fused": args.fused,
           "tiled": args.tiled, "mask_kernel": args.mask_kernel}

    with FlopCounterMode(display=False) as fc:
        infer(*clouds[0])
    rec["gflop_per_frame"] = fc.get_total_flops() / 1e9

    frames = iter(clouds)
    spans = traced("serving.request", lambda: infer(*next(frames)),
                   len(clouds))
    rec["stage_ms"] = {s: v["device_ms"] for s, v in spans.items()}
    rec["stage_host_ms"] = {s: v["host_ms"] for s, v in spans.items()}

    def five_requests():
        t0 = time.perf_counter()
        for c in clouds[:5]:
            infer(*c)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    rows, window, lost = profiled(five_requests)
    groups = group_table(rows)
    busy = sum(groups.values())
    rec["profile_5_requests"] = {
        "window_ms": window, "kernel_ms": busy, "lost_events": lost,
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
    print(f"card: {card}; {args.config}, fused stage {args.fused}, tiled "
          f"scatter {args.tiled}, mask kernel {args.mask_kernel}")
    print(f"GFLOP per bs=1 frame: {rec['gflop_per_frame']:.1f}")
    print("stage ms, device (host), medians of 10 requests: " + ", ".join(
        f"{s} {v:.2f} ({rec['stage_host_ms'][s]:.2f})"
        for s, v in rec["stage_ms"].items()))
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
