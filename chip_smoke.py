#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`pillarnet_lts_torch`) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each of which raises on failure:
  0. card name and power limit, torch and CUDA versions;
  1. build every CUDA kernel from `pillarnet_lts_torch/csrc/` (nvcc, sm_90a,
     one nvcc per source, all at once);
  2. the pillar scatter-max kernel (K1) against its plain version at the
     flagship shape (1 x 262,144 points x 32 channels -> 1440 x 1440), f32
     signed, f32 nonneg and int8 codes, and with every point in one pillar,
     bit-equal; each case timed with its wrapper, its kernels alone
     (`torch.profiler`), the plain version and `scatter_reduce_`;
  3. the rotated-overlap kernel against its plain version at (6, 1000, 1000)
     pairs, within 1e-4 m^2;
  4. the committed golden fixture (`tests/fixtures/golden_e2e_r3.npz`)
     replayed through the port with the fixture's own weights, within the
     tolerances of `tests/test_golden_e2e.py`;
  5. the flagship config `configs/pillarnet/pillarnet34_nusc.py` with seeded
     random weights, serving 3 warm-up + 10 timed requests at batch 1 and 2
     requests at batch 2 through `ServingPipeline(make_infer_fn(model))`,
     with both kernels' launch counters rising on every request;
  6. the int8 deploy config `configs/pillarnet/pillarnet34_nusc_int8.py`,
     seeded random weights, calibrated on 4 synthetic clouds (its heatmaps'
     distance from the bf16 forward is printed); one request served with
     the fused stage off, the arguments of its 51 int8 conv (K4) calls
     captured and each replayed through K4 and its plain version,
     bit-equal; per distinct shape the wrapper time, kernels alone
     (`torch.profiler`), plain, bound, the share of 8 x 16 tiles with an
     active site, and the cuDNN bf16 conv of that shape (a yardstick, not
     the same function); per-frame sums;
  7. the fused int8 stage kernel (K5, n = 7) on that request's stride-1
     stage (its input, mask and the model's stacked params), bit-equal to
     its plain version and to the per-conv route's output, timed beside the
     per-conv route over the same 7 convs;
  8. the int8 canary of tests/test_quant_int8.py:88-106 (its demo model at
     the int8 kernels' 32-channel widths: int8 head outputs within 0.2 of
     the bf16 ones); the int8 flagship serving 3 warm-up + 10 timed
     requests at batch 1 with the fused stage on (`s2d_pallas`) and off,
     every request raising the counters of the kernels of its path, and
     the two routes' detections identical on every cloud;
  9. the suppression-mask kernel against its plain version, bit-equal, at
     (6, 1000, 1000) pairs (threshold 0.2) and the Waymo grouped shape
     (3, 2048, 2048) (thresholds 0.8 / 0.55 / 0.55); its masks and keep
     sets against the default overlap-kernel route on the same candidates
     (`rotated_nms(use_mask_kernel=True)` vs `rotated_nms`,
     `_greedy_suppress_mask` vs `rotated_nms_dynamic`): a decision may
     differ only on a pair whose IoU lies within MASK_EPS of its threshold
     (each such pair is printed);
 10. the sorted-run scatter-max kernel (K1') against its plain version, the
     atomic one and `scatter_reduce_`, equal by value with identical
     occupancy, at the Waymo (1 x 196,608 x 32 -> 1504^2) and nuScenes
     shapes, in bf16 and int8 at the Waymo shape, and with every point in
     one pillar; timed as in phase 2;
 11. the Waymo config `configs/pillarnet/pillarnet34_waymo.py` (full width
     and depth, f32, per-class NMS), seeded random weights, serving 3
     warm-up + 10 timed requests at batch 1 on 196,608-point single-sweep
     clouds; every class fills NMS slots;
 12. the same model with `ops.scatter.set_backend("tiled")`: detections
     identical to phase 11's on the same clouds; then also with
     `test_cfg.nms.use_mask_kernel`: detections equal to phase 11's except
     where the mask kernel decided a pair within MASK_EPS of its threshold
     otherwise (checked on the request's own candidates).

Every kernel's record carries its bound: the least time the card could
take for the same work on this run's inputs, the larger of the bytes it
must move (each input read once, each output written once; of the int8
convs' x and residual, only what the active output sites need) at 3.35 TB/s
and the operations it must do at the peak rate of their type (f32 67
TFLOP/s, int8 1,979 TOP/s), and the time of one PyTorch call that computes
the same function where there is one (`library_ms`, else null).

The second-to-last line of stdout is the kernels' JSON record, the line
before it the card's `nvidia-smi` name and power limit, and the last line
`{"ok": true, "device": {...}}`. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result. No JAX is imported.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "configs", "pillarnet", "pillarnet34_nusc.py")
FLAGSHIP_INT8 = FLAGSHIP.replace(".py", "_int8.py")
DEMO = os.path.join(ROOT, "configs", "demo", "pillarnet18_demo.py")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_e2e_r3.npz")
WAYMO = os.path.join(ROOT, "configs", "pillarnet", "pillarnet34_waymo.py")

N_POINTS = 262144
NMS_TASKS, NMS_K = 6, 1000
AREA_ATOL = 1e-4  # m^2, as tests/test_pallas_iou.py holds the TPU kernel
TIMING_ITERS = 20
PLAIN_ITERS = 3  # the int8 plain versions sum in float64: slow
F32_PATH = {"pillar_scatter_max", "rotated_overlap"}  # kernels of phase 5
HM_REL_BOUND = 0.2  # int8 vs bf16 heads, tests/test_quant_int8.py:88-106
WAYMO_K, WAYMO_THRESH = 2048, (0.8, 0.55, 0.55)  # the grouped per-class NMS
# the mask kernel's IoU (shoelace areas) and the default route's (w * l
# areas) may decide a pair differently only this close to its threshold
MASK_EPS = 1e-4
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, f32 (no tensor
# cores) and int8 (tensor cores, dense) operations/s
HBM_BPS, F32_OPS, INT8_OPS = 3.35e12, 67e12, 1979e12
# f32 operations of one box pair: the overlap kernel (two one-sided clips,
# the B+ scaling, two shoelaces) and the mask kernel (eight clipped edges
# of 71 ops, the IoU), counted from the sources
OVERLAP_PAIR_OPS, MASK_PAIR_OPS = 610, 575


def golden_model_cfg():
    """Copy of `tools/make_golden_fixture_e2e.py::model_cfg` (that module
    imports JAX); `tests/test_torch_port_e2e.py` pins the two equal."""
    tasks = [
        dict(stride=4, class_names=["car"]),
        dict(stride=4, class_names=["pedestrian", "cyclist"]),
    ]
    pc_range = [-16.0, -16.0, -4.0, 16.0, 16.0, 2.0]
    pillar = 0.25  # 128 x 128 grid
    return dict(
        type="PillarNet",
        reader=dict(
            type="DynamicPFE", in_channels=5, num_filters=(8,),
            pillar_size=pillar, pc_range=pc_range,
        ),
        backbone=dict(type="PillarResNet18S", in_channels=8),
        neck=dict(
            type="RPNV2", layer_nums=[2, 2], num_filters=32,
            in_channels=[32, 64],
        ),
        bbox_head=dict(
            type="CenterHead",
            tasks=tasks,
            in_channels=[32],
            code_weights=[1.0] * 8 + [0.2, 0.2],
            common_heads={
                "reg": (2, 2), "height": (1, 2), "dim": (3, 2),
                "rot": (2, 2), "iou": (1, 2),
            },
            reg_iou="GIoU",
            pillar_size=pillar,
            point_cloud_range=pc_range,
        ),
    ), dict(
        nms=dict(
            use_rotate_nms=True, nms_pre_max_size=256,
            nms_post_max_size=64, nms_iou_threshold=0.2,
        ),
        rectifier=0.5,
        score_threshold=0.05,
        post_center_limit_range=[-20.0, -20.0, -6.0, 20.0, 20.0, 4.0],
    )


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=TIMING_ITERS, warmup=3):
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, ops, peak):
    """(bound_ms, bound_by): the larger of `n_bytes` at the HBM rate and
    `ops` at `peak` operations/s."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scatter_library(torch, x, ids, valid, hw):
    """The one-call yardstick of a scatter-max: `scatter_reduce_(amax,
    include_self=False)` into a zeroed grid with a spare row for dropped
    points; returns a callable of no arguments and the index it uses."""
    B, N, C = x.shape
    idx = torch.where(valid, ids, hw).long()[..., None].expand(B, N, C)

    def call():
        grid = torch.zeros((B, hw + 1, C), dtype=x.dtype, device=x.device)
        return grid.scatter_reduce_(1, idx, x, reduce="amax",
                                    include_self=False)
    return call


def device_ms(fn, iters=10):
    """Mean device time of the kernels and memsets that one fn() call
    launches (`torch.profiler`'s sums over `iters` calls): the call's
    kernels alone, without the host's launch gaps. Returns it and the
    per-kernel means, longest first."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if t is None else t
            per.append((us / 1e3 / iters, e.key))
    total = sum(ms for ms, _ in per)
    if total <= 0:
        raise AssertionError("torch.profiler saw no device time")
    return total, sorted(per, reverse=True)


def check_scatter_equal(torch, tag, got, want, by_value=False):
    """Identical occupancy; the grid bit-equal, or equal by value (-0.0 and
    +0.0 may trade places). Returns the grid's max |got - want|."""
    (grid, occ), (g2, o2) = got, want
    err = (grid.float() - g2.float()).abs().max().item()
    same = bool((grid == g2).all()) if by_value else torch.equal(grid, g2)
    if not (same and grid.dtype == g2.dtype and torch.equal(occ, o2)):
        raise AssertionError(f"{tag}: max |d| {err}, occupancy mismatches "
                             f"{int((occ != o2).sum())}")
    return err


def scatter_times(torch, tag, call, plain, x, ids, valid, out, peak,
                  iters=TIMING_ITERS):
    """Phase 2 and 10 timings of one scatter-max case: the wrapper (CUDA
    events), its kernels alone (profiler), the plain version, the one-call
    `scatter_reduce_` yardstick and the bound; printed and returned."""
    library = scatter_library(torch, x, ids, valid, out[1][0].numel())
    alone, per_kernel = device_ms(call, iters=min(iters, 10))
    r = {"ms": cuda_ms(call, iters=iters), "alone_ms": alone,
         "plain_ms": cuda_ms(plain, iters=iters),
         "library_ms": cuda_ms(library, iters=iters)}
    r["bound_ms"], r["bound_by"] = bound(
        nbytes(x, ids, valid, *out), int(valid.sum()) * x.shape[-1], peak)
    print(f"{tag}: wrapper {r['ms']:.4f} ms, kernels alone "
          f"{r['alone_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"scatter_reduce_ {r['library_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}); mean of {iters} "
          f"calls; kernels: " + "; ".join(
              f"{k.replace('(anonymous namespace)::', '').split('(')[0][-60:]}"
              f" {ms * 1e3:.1f} us"
              for ms, k in per_kernel[:6]))
    return r


def one_pillar(torch, ids, width, height):
    """The same points, every id moved to the centre pillar."""
    return torch.full_like(ids, (height // 2) * width + width // 2)


def check_scatter(torch, dev, pc_range, pillar_size):
    """Phase 2: the pillar scatter-max kernel (K1) vs its plain version at
    the flagship shape in its three modes, and with every point in one
    pillar; returns the per-mode records."""
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.ops.scatter import pillar_scatter_max
    from pillarnet_lts_torch.ops.voxelize import (
        PillarSpec, scatter_max_to_grid, voxelize_points)

    spec = PillarSpec(pillar_size, tuple(pc_range))
    H, W = spec.height, spec.width
    pts, msk = synth_points_realistic(1, N_POINTS, pc_range, seed=100)
    pts = torch.from_numpy(pts).to(dev)
    msk = torch.from_numpy(msk).to(dev)
    feats, ids, valid = voxelize_points(pts, msk, spec)
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(32, feats.shape[-1], generator=g) * 0.5).to(dev)
    signed = torch.nn.functional.linear(feats, w).contiguous()
    relu = torch.relu(signed)
    codes = torch.round(relu * (127.0 / relu.max())).clamp_(0, 127) \
        .to(torch.int8)
    cases = (("f32_signed", signed, False, F32_OPS),
             ("f32_nonneg", relu, True, F32_OPS),
             ("int8", codes, True, INT8_OPS))
    modes, err = {}, 0.0
    for tag, x, nonneg, peak in cases:
        args = (x, ids, valid, H, W)
        out = pillar_scatter_max(*args, nonneg=nonneg)
        err = max(err, check_scatter_equal(torch, f"pillar_scatter_max {tag}",
                                           out, scatter_max_to_grid(*args)))
        modes[tag] = scatter_times(
            torch, f"[2] K1 {tag} {tuple(x.shape)} -> {H}x{W}, bit-equal, "
            f"{int(out[1].sum())} of {H * W} pillars occupied",
            lambda: pillar_scatter_max(*args, nonneg=nonneg),
            lambda: scatter_max_to_grid(*args), x, ids, valid, out, peak)

    # the longest run: every point in one pillar (atomics on one row)
    args = (signed, one_pillar(torch, ids, W, H), valid, H, W)
    out = pillar_scatter_max(*args)
    err = max(err, check_scatter_equal(torch, "pillar_scatter_max one pillar",
                                       out, scatter_max_to_grid(*args)))
    modes["one_pillar_f32"] = scatter_times(
        torch, f"[2] K1 f32 signed, all {int(valid.sum())} points in one "
        f"pillar, bit-equal", lambda: pillar_scatter_max(*args),
        lambda: scatter_max_to_grid(*args), signed, args[1], valid, out,
        F32_OPS, iters=5)
    return {"max_abs_err": err, "modes": modes}


def nms_like_boxes(torch, seed, T=NMS_TASKS, K=NMS_K):
    """(T, K, 5) pcdet BEV boxes in +-54 m, dims 0.3-12 m, with clustered,
    identical and edge-touching pairs."""
    rng = np.random.RandomState(seed)
    b = np.zeros((T, K, 5), np.float32)
    b[..., 0:2] = rng.uniform(-54, 54, (T, K, 2))
    b[..., 2:4] = rng.uniform(0.3, 12, (T, K, 2))
    b[..., 4] = rng.uniform(-np.pi, np.pi, (T, K))
    # clusters: a third of the boxes around 10 centres per task
    nc = K // 3
    centres = rng.uniform(-50, 50, (T, 10, 2))
    pick = rng.randint(0, 10, (T, nc))
    b[:, :nc, 0:2] = (np.take_along_axis(centres, pick[..., None], 1)
                      + rng.randn(T, nc, 2) * 1.5)
    # identical pairs: K/20 boxes copied from the next K/20
    d = K // 20
    b[:, nc:nc + d] = b[:, nc + d:nc + 2 * d]
    # edge-touching axis-aligned pairs: box j+1 starts where box j ends
    s, e = nc + 2 * d, nc + 2 * d + 2 * (K // 20)
    b[:, s:e:2, 4] = 0.0
    b[:, s + 1:e:2] = b[:, s:e:2]
    b[:, s + 1:e:2, 0] += b[:, s:e:2, 2]
    return torch.from_numpy(b)


def check_overlap(torch, dev):
    """Phase 3: rotated-overlap kernel vs plain at (6, 1000, 1000)."""
    from pillarnet_lts_torch.ops.iou3d import (
        _pairwise_area_plain, box_corners_bev, convex_intersection_area)

    corners = box_corners_bev(nms_like_boxes(torch, 1).to(dev)).contiguous()
    got = convex_intersection_area(corners, corners)
    want = _pairwise_area_plain(corners, corners)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("rotated_overlap produced non-finite areas")
    diff = (got - want).abs()
    err = diff.max().item()
    n_over = int((diff > 1e-6).sum().item())
    n_pos = int((want > 0).sum().item())
    if err > AREA_ATOL:
        raise AssertionError(f"rotated_overlap max |d| {err} > {AREA_ATOL}")
    k_ms = cuda_ms(lambda: convex_intersection_area(corners, corners))
    p_ms = cuda_ms(lambda: _pairwise_area_plain(corners, corners), iters=5)
    b = bound(nbytes(corners, corners, got), got.numel() * OVERLAP_PAIR_OPS,
              F32_OPS)
    print(f"[3] rotated overlap {tuple(got.shape)}: max |d| {err:.3e} m^2 "
          f"(<= {AREA_ATOL}); pairs with |d| > 1e-6: {n_over} of "
          f"{got.numel()} ({n_pos} overlapping); kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound": b}


def check_golden(torch, dev):
    """Phase 4: golden fixture replay on the card."""
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.models import build_detector
    from pillarnet_lts_torch.runtime.convert import (
        load_jax_variables, variables_from_keystr)

    data = np.load(FIXTURE)
    mcfg, tcfg = golden_model_cfg()
    model = build_detector(mcfg, test_cfg=tcfg, device=dev)
    load_jax_variables(model, variables_from_keystr(data))
    det = make_infer_fn(model)(
        torch.from_numpy(data["points"]).to(dev),
        torch.from_numpy(data["points_mask"]).to(dev))
    det = {k: v.cpu().numpy() for k, v in det.items()}
    np.testing.assert_array_equal(det["mask"], data["det_mask"],
                                  err_msg="NMS keep-set changed")
    m = data["det_mask"].astype(bool)
    np.testing.assert_array_equal(det["label_preds"][m],
                                  data["label_preds"][m])
    np.testing.assert_allclose(det["scores"][m], data["scores"][m], atol=1e-4)
    np.testing.assert_allclose(det["box3d_lidar"][m], data["box3d_lidar"][m],
                               atol=1e-3)
    print(f"[4] golden replay: {int(m.sum())} detections match the fixture "
          f"(max |d| score "
          f"{np.abs(det['scores'][m] - data['scores'][m]).max():.2e}, box "
          f"{np.abs(det['box3d_lidar'][m] - data['box3d_lidar'][m]).max():.2e})")


def serve_flagship(torch, dev, card):
    """Phase 5: the f32 flagship config as a server."""
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime.serving import ServingPipeline

    cfg = load_config(FLAGSHIP)
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    model = build_model_from_cfg(cfg, device=dev, seed=0)
    post = cfg["test_cfg"]["nms"]["nms_post_max_size"] * len(cfg["tasks"])
    clouds = [synth_points_realistic(1, n, pc_range, seed=s)
              for s in range(13)]
    clouds += [synth_points_realistic(2, n, pc_range, seed=s)
               for s in (13, 14)]
    # random weights: spread the head outputs so that NMS sees valid boxes
    calib = synth_points_realistic(1, n, pc_range, seed=99)
    spread_head_outputs(model, torch.from_numpy(calib[0]).to(dev),
                        torch.from_numpy(calib[1]).to(dev))
    pipe = ServingPipeline(make_infer_fn(model), depth=1)

    def request(pts, msk):
        before = dict(_kernels.LAUNCHES)
        outs = list(pipe.map([(torch.from_numpy(pts).to(dev),
                               torch.from_numpy(msk).to(dev))]))
        for name, count in _kernels.LAUNCHES.items():
            if (count > before[name]) != (name in F32_PATH):
                raise AssertionError(f"f32 request: {name} launched="
                                     f"{count > before[name]}")
        return outs[0]

    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    lat, kept = [], []
    for i, (pts, msk) in enumerate(clouds):
        t0 = time.perf_counter()
        det = request(pts, msk)
        dt = (time.perf_counter() - t0) * 1e3
        B = pts.shape[0]
        for key, shape in (("box3d_lidar", (B, post, 9)), ("scores", (B, post)),
                           ("label_preds", (B, post)), ("mask", (B, post))):
            if det[key].shape != shape:
                raise AssertionError(f"{key} shape {det[key].shape} != {shape}")
        if not (np.isfinite(det["box3d_lidar"]).all()
                and np.isfinite(det["scores"]).all()):
            raise AssertionError(f"request {i}: non-finite detections")
        if 3 <= i < 13:
            lat.append(dt)
            kept.append(int(det["mask"].sum()))
        elif i >= 13:
            print(f"[5] bs=2 request {i - 12}: {dt:.2f} ms, kept "
                  f"{det['mask'].sum(axis=1).tolist()} boxes")
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    for mod in ("jax", "pillarnet_lts_tpu", "__graft_entry__"):
        if mod in sys.modules:
            raise AssertionError(f"the port imported {mod}")
    q = statistics.quantiles(lat, n=10)
    print(f"[5] flagship pillarnet34_nusc bs=1, {len(lat)} timed requests "
          f"(after 3 warm-up), host-synced latency: p50 "
          f"{statistics.median(lat):.2f} ms, p90 {q[8]:.2f} ms; peak "
          f"allocated {peak / 2**30:.3f} GiB; mean kept boxes "
          f"{statistics.mean(kept):.1f} of {post}; card: {card}")
    print(f"[5] launches over {len(clouds)} requests: {launches}")


def rel_errors(ref, got, heads=None):
    """max |got - ref| / max |ref| per task over the named head outputs."""
    return [max(((a[k].float() - b[k].float()).abs().max()
                 / (a[k].float().abs().max() + 1e-6)).item()
                for k in (heads or a)) for a, b in zip(ref, got)]


def demo_canary(torch, dev):
    """The int8 accuracy canary of tests/test_quant_int8.py:88-106 (its
    model, input, protocol and 0.2 bound) on the card: the demo config at
    the int8 kernels' widths (32-channel stage 1), seeded weights,
    calibrated on the input it is then run on, every head output within
    0.2 of its max of the same model's bf16 forward."""
    from pillarnet_lts_torch.apis import build_model_from_cfg, load_config
    from pillarnet_lts_torch.runtime.quantize import (
        calibrate, enable_backbone_quant)

    cfg = load_config(DEMO)
    enable_backbone_quant(cfg["model"])
    cfg["model"]["dtype"] = "bfloat16"
    cfg["model"]["reader"]["num_filters"] = (32,)
    cfg["model"]["backbone"]["in_channels"] = 32
    model = build_model_from_cfg(cfg, device=dev, seed=0)
    rng = np.random.RandomState(1)
    pts = torch.from_numpy(rng.uniform(-15, 15, (1, 512, 5))
                           .astype(np.float32)).to(dev)
    msk = torch.ones((1, 512), dtype=torch.bool, device=dev)
    with torch.no_grad():
        ref = model(pts, msk)
        calibrate(model, [(pts, msk)])
        got = model(pts, msk)
    errs = rel_errors(ref, got)
    print(f"[8] int8 canary (demo model at 32-channel widths): max |int8 - "
          f"bf16| / max|bf16| over head outputs per task "
          f"{[round(e, 4) for e in errs]} (bound {HM_REL_BOUND})")
    if max(errs) > HM_REL_BOUND:
        raise AssertionError(f"int8 canary {max(errs)} > {HM_REL_BOUND}")


def int8_flagship(torch, dev):
    """The int8 deploy config with seeded random weights and spread head
    outputs, calibrated on 4 synthetic clouds (its heatmaps' distance from
    the bf16 forward is printed). Returns the model, a cloud maker and the
    number of NMS slots."""
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.runtime.quantize import calibrate

    cfg = load_config(FLAGSHIP_INT8)
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    post = cfg["test_cfg"]["nms"]["nms_post_max_size"] * len(cfg["tasks"])

    def cloud(seed):  # in host memory, as a request arrives
        return synth_points_realistic(1, n, pc_range, seed=seed)

    model = build_model_from_cfg(cfg, device=dev, seed=0)
    calib = [on_card(torch, dev, cloud(s)) for s in (90, 91, 92, 93)]
    with torch.no_grad():
        # uncalibrated: the bf16 path
        spread_head_outputs(model, *on_card(torch, dev, cloud(99)))
        ref = model(*calib[0])
        t0 = time.perf_counter()
        calibrate(model, calib)
        torch.cuda.synchronize()
        t_cal = time.perf_counter() - t0
        got = model(*calib[0])
    print(f"[6] int8 flagship calibrated on 4 clouds in {t_cal:.2f} s; "
          f"heatmap |int8 - bf16| / max|bf16| per task on a calibration "
          f"cloud (random weights, reported): "
          f"{[round(e, 4) for e in rel_errors(ref, got, ('hm',))]}")
    return model, cloud, post


def on_card(torch, dev, cloud):
    return tuple(torch.from_numpy(a).to(dev) for a in cloud)


def capture_int8_convs(torch, model, request):
    """Serve one request with the fused stage off and record (args, kwargs,
    output) of every K4 call in it: `MaskedConv.int8` reaches the wrapper
    through `models/backbones/base.py`, so the masks and residuals are the
    served ones."""
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.models.backbones import base
    from pillarnet_lts_torch.runtime.serving import ServingPipeline

    calls, real = [], base.int8_conv_bn_act

    def recording(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out

    model.backbone_net.s2d_pallas = False
    base.int8_conv_bn_act = recording
    try:
        list(ServingPipeline(make_infer_fn(model), depth=1).map([request]))
    finally:
        base.int8_conv_bn_act = real
    torch.cuda.synchronize()
    return calls


def plain_kwargs(kw):
    """The keyword arguments that the plain version takes."""
    return {k: v for k, v in kw.items() if k in ("mask", "residual", "act")}


def input_sites(torch, mask, H, W, stride):
    """Input sites that a 3x3 conv (padding 1) at `stride` reads for the
    active sites of its (B, Ho, Wo) output `mask`: the mask dilated by the
    conv window, counted on the (B, H, W) input."""
    import torch.nn.functional as F

    m = (mask != 0).float()[:, None]
    if stride == 2:
        up = m.new_zeros((m.shape[0], 1, 2 * m.shape[2], 2 * m.shape[3]))
        up[..., ::2, ::2] = m
        m = up
    return int(F.max_pool2d(m, 3, 1, 1)[..., :H, :W].sum())


def live_tiles(torch, mask, th=8, tw=16):
    """Share of K4's th x tw output tiles with an active site: the tiles
    that read their haloed input patch and residual."""
    import torch.nn.functional as F

    m = F.max_pool2d((mask != 0).float()[:, None], (th, tw), (th, tw),
                     ceil_mode=True)
    return float(m.mean())


def int8_conv_bound(torch, args, kw, out):
    """K4's bound for one call, from what the function needs: the packed
    kernel, the scales and the mask once, x at the input sites that the
    active output sites' 3x3 windows cover, the residual at the active
    sites, and the whole output (inactive sites are written as 0); 2 * 9 *
    Cin * Cout operations per active output site (every site when there is
    no mask). Returns the bound and the active output sites."""
    x, w_q, stride = args[0], args[1], args[5]
    B, H, W, cin = x.shape
    cout = w_q.shape[3]
    mask, res = kw.get("mask"), kw.get("residual")
    sites = out.shape[0] * out.shape[1] * out.shape[2]
    sites_in = B * H * W
    if mask is not None:
        sites = int((mask != 0).sum())
        sites_in = input_sites(torch, mask, H, W, stride)
    n_bytes = (nbytes(kw.get("w_pack", w_q), *args[2:5], mask, out)
               + sites_in * cin * x.element_size()
               + (0 if res is None else sites * cout * res.element_size()))
    return bound(n_bytes, 2 * 9 * cin * cout * sites, INT8_OPS), sites


def check_int8_conv(torch, calls):
    """Phase 6: every K4 call of one served int8 request replayed through
    the kernel and its plain version, bit-equal; each call timed with its
    wrapper and its plain version, each distinct shape with its kernels
    alone (`torch.profiler`), its bound and the cuDNN bf16 conv of the same
    shape (a yardstick, not the same function); per-frame sums."""
    import torch.nn.functional as F
    from pillarnet_lts_torch.ops.quant import (
        int8_conv_bn_act, int8_conv_bn_act_plain)

    shapes, err = {}, 0.0
    for i, (args, kw, out) in enumerate(calls):
        got = int8_conv_bn_act(*args, **kw)
        want = int8_conv_bn_act_plain(*args, **plain_kwargs(kw))
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs().max().item()
        err = max(err, d)
        if not (torch.equal(got, want) and torch.equal(got, out)):
            raise AssertionError(
                f"int8_conv call {i} {tuple(args[0].shape)} -> "
                f"{tuple(got.shape)} differs from plain: max |d| {d}, "
                f"{int((got != want).sum())} elements")
        (b_ms, b_by), sites = int8_conv_bound(torch, args, kw, out)
        x, w_q, stride = args[0], args[1], args[5]
        key = (tuple(x.shape), w_q.shape[3], stride,
               kw.get("mask") is not None, kw.get("residual") is not None)
        s = shapes.setdefault(key, {"calls": [], "ms": [], "plain_ms": [],
                                    "bound_ms": [], "sites": [], "live": []})
        s["calls"].append((args, kw))
        s["ms"].append(cuda_ms(lambda: int8_conv_bn_act(*args, **kw)))
        s["plain_ms"].append(cuda_ms(
            lambda: int8_conv_bn_act_plain(*args, **plain_kwargs(kw)),
            iters=PLAIN_ITERS, warmup=1))
        s["bound_ms"].append(b_ms)
        s["bound_by"] = b_by
        s["sites"].append(sites)
        s["live"].append(1.0 if kw.get("mask") is None
                         else live_tiles(torch, kw["mask"]))

    rows, frame = [], {k: 0.0 for k in ("ms", "alone_ms", "plain_ms",
                                        "bound_ms", "bf16_conv_ms")}
    for (xs, cout, stride, has_mask, has_res), s in shapes.items():
        n = len(s["calls"])
        alone, _ = device_ms(lambda: [int8_conv_bn_act(*a, **k)
                                      for a, k in s["calls"]], iters=5)
        x, w_q = s["calls"][0][0][0], s["calls"][0][0][1]
        xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC: channels_last
        wc = w_q.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bf16 = cuda_ms(lambda: F.conv2d(xc, wc, stride=stride, padding=1))
        r = {"shape": f"{xs[0]}x{xs[1]}x{xs[2]}x{xs[3]} -> {cout}, stride "
                      f"{stride}" + (", mask" if has_mask else ", dense")
                      + (", residual" if has_res else ""),
             "launches": n, "ms": statistics.mean(s["ms"]),
             "alone_ms": alone / n, "plain_ms": statistics.mean(s["plain_ms"]),
             "bound_ms": statistics.mean(s["bound_ms"]),
             "bound_by": s["bound_by"], "bf16_conv_ms": bf16,
             "active_sites": statistics.mean(s["sites"]),
             "live_tiles": statistics.mean(s["live"]),
             "key": (has_res, xs[1] * xs[2])}
        rows.append(r)
        for k in frame:
            frame[k] += n * r[k]
        print(f"[6] K4 {r['shape']}: {n} launches, bit-equal; wrapper "
              f"{r['ms']:.4f} ms, kernels alone {r['alone_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; {r['bound_ms'] / r['alone_ms']:.0%} of it "
              f"alone), cuDNN bf16 conv of the shape (not the same function) "
              f"{bf16:.4f} ms; {r['active_sites']:.0f} active output sites, "
              f"{r['live_tiles']:.1%} of its 8 x 16 tiles live")
    print(f"[6] K4 per int8 frame ({len(calls)} calls, fused stage off): "
          f"wrapper {frame['ms']:.4f} ms, kernels alone "
          f"{frame['alone_ms']:.4f} ms, plain {frame['plain_ms']:.4f} ms, "
          f"bound {frame['bound_ms']:.4f} ms, cuDNN bf16 convs "
          f"{frame['bf16_conv_ms']:.4f} ms")
    # the row's own numbers: the stage-1 residual conv (the largest map)
    main = max(rows, key=lambda r: r["key"])
    for r in rows:
        del r["key"]
    return {"max_abs_err": err, "ms": main["ms"], "alone_ms":
            main["alone_ms"], "plain_ms": main["plain_ms"],
            "bound": (main["bound_ms"], main["bound_by"]), "main_shape":
            main["shape"], "shapes": rows, "frame": frame}


def check_int8_stage(torch, model, calls):
    """Phase 7: the fused int8 stage kernel (K5) on the served request's
    stride-1 stage (its input and mask from the first captured K4 call, the
    model's stacked int8 params) vs its plain version and vs the per-conv
    route over the same convs, all bit-equal."""
    from pillarnet_lts_torch.ops.int8_stage import int8_stage, int8_stage_plain
    from pillarnet_lts_torch.ops.quant import int8_conv_bn_act

    bb = model.backbone_net
    bb.s2d_pallas = True
    params = bb.fused_stage1_params()
    n = params[0].shape[0]
    (x, *_), kw0, _ = calls[0]
    args = (x, *params[:4], kw0["mask"])
    pack = {"w_pack": params[4]}
    got = int8_stage(*args, **pack)
    want = int8_stage_plain(*args)
    per_conv = calls[n - 1][2]
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not (torch.equal(got, want) and torch.equal(got, per_conv)):
        raise AssertionError(f"int8_stage differs from plain or the per-conv "
                             f"route: max |d| {err}, "
                             f"{int((got != want).sum())} elements")
    route = [(a, k) for a, k, _ in calls[:n]]
    r = {"max_abs_err": err, "ms": cuda_ms(lambda: int8_stage(*args, **pack)),
         "alone_ms": device_ms(lambda: int8_stage(*args, **pack),
                               iters=5)[0],
         "plain_ms": cuda_ms(lambda: int8_stage_plain(*args),
                             iters=PLAIN_ITERS, warmup=1),
         "per_conv_ms": cuda_ms(lambda: [int8_conv_bn_act(*a, **k)
                                         for a, k in route]),
         "per_conv_alone_ms": device_ms(lambda: [int8_conv_bn_act(*a, **k)
                                                 for a, k in route],
                                        iters=5)[0]}
    # bytes as for K4: x where the active sites' windows reach it (later
    # convs read only the stage's own intermediates), the whole output
    sites = int((kw0["mask"] != 0).sum())
    sites_in = input_sites(torch, kw0["mask"], x.shape[1], x.shape[2], 1)
    r["bound"] = bound(nbytes(*args[2:], params[4], got)
                       + sites_in * 32 * x.element_size(),
                       n * 2 * 9 * 32 * 32 * sites, INT8_OPS)
    print(f"[7] fused int8 stage, n = {n}, {tuple(x.shape)} (the served "
          f"request's stage 1, {sites} active sites): bit-equal to plain and "
          f"to the per-conv route; wrapper {r['ms']:.4f} ms, kernels alone "
          f"{r['alone_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
          f"{r['bound'][0]:.4f} ms ({r['bound'][1]}); the per-conv route "
          f"over the same {n} convs: wrapper {r['per_conv_ms']:.4f} ms, "
          f"kernels alone {r['per_conv_alone_ms']:.4f} ms")
    return r


def serve_int8_flagship(torch, dev, card, model, cloud, post):
    """Phase 8: the int8 deploy config as a server, fused stage on and off,
    on the same clouds: both routes are bit-equal to the same plain chain,
    so they must serve identical detections. Returns the launch counts of
    the fused-stage run."""
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime.serving import ServingPipeline

    demo_canary(torch, dev)
    clouds = [cloud(s) for s in range(13)]
    path = {"pillar_scatter_max", "rotated_overlap", "int8_conv"}
    launches, served = None, {}
    for fused in (True, False):
        model.backbone_net.s2d_pallas = fused
        kernels = path | {"int8_stage"} if fused else path
        pipe = ServingPipeline(make_infer_fn(model), depth=1)
        torch.cuda.reset_peak_memory_stats(dev)
        _kernels.reset_launches()
        lat, kept, dets = [], [], []
        for i, (pts, msk) in enumerate(clouds):
            before = dict(_kernels.LAUNCHES)
            t0 = time.perf_counter()
            det = list(pipe.map([(torch.from_numpy(pts).to(dev),
                                  torch.from_numpy(msk).to(dev))]))[0]
            dt = (time.perf_counter() - t0) * 1e3
            for name, count in _kernels.LAUNCHES.items():
                rose = count > before[name]
                if rose != (name in kernels):
                    raise AssertionError(f"int8 request {i} (fused={fused}):"
                                         f" {name} launched={rose}")
            if det["box3d_lidar"].shape != (1, post, 9) or not (
                    np.isfinite(det["box3d_lidar"]).all()
                    and np.isfinite(det["scores"]).all()):
                raise AssertionError(f"int8 request {i}: bad detections")
            dets.append(det)
            if i >= 3:
                lat.append(dt)
                kept.append(int(det["mask"].sum()))
        counts = dict(_kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        q = statistics.quantiles(lat, n=10)
        print(f"[8] int8 flagship pillarnet34_nusc_int8 bs=1, fused stage "
              f"{'on' if fused else 'off'}: {len(lat)} timed requests (after "
              f"3 warm-up), host-synced latency p50 "
              f"{statistics.median(lat):.2f} ms, p90 {q[8]:.2f} ms; peak "
              f"allocated {peak / 2**30:.3f} GiB; mean kept boxes "
              f"{statistics.mean(kept):.1f} of {post}; launches over "
              f"{len(clouds)} requests {counts}; card: {card}")
        served[fused] = dets
        if fused:
            launches = counts
    for i, (a, b) in enumerate(zip(served[True], served[False])):
        for key in a:
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"int8 request {i}: {key} differs "
                                     f"between the fused and per-conv routes")
    print(f"[8] the fused and per-conv int8 routes served identical "
          f"detections on all {len(clouds)} clouds")
    return launches


def det3d_from_bev(torch, bev):
    """pcdet BEV (..., 5) -> det3d (..., 7) boxes (z 0, height 1.5): the
    inverse of `ops.iou3d.to_pcdet_bev`."""
    x, y, dx, dy, heading = bev.unbind(-1)
    return torch.stack([x, y, torch.zeros_like(x), dy, dx,
                        torch.full_like(x, 1.5), -heading - math.pi / 2], -1)


def mask_flips(torch, boxes, thresh, m_kernel, tag):
    """Pairs the mask kernel decides unlike the default route (overlap
    kernel IoU > threshold); each must lie within MASK_EPS of its row's
    threshold. Prints them; returns their count."""
    from pillarnet_lts_torch.ops.iou3d import rotated_iou_bev, to_pcdet_bev

    bev = to_pcdet_bev(boxes)
    iou = rotated_iou_bev(bev, bev)
    k = boxes.shape[1]
    upper = torch.ones((k, k), dtype=torch.bool, device=boxes.device).triu(1)
    th = thresh.reshape(-1, 1, 1)
    flips = (m_kernel > 0) != (upper & (iou > th))
    bad = flips & ((iou - th).abs() >= MASK_EPS)
    for r, j, i in flips.nonzero().tolist():
        print(f"[9] {tag}: pair (row {r}, {j}, {i}) decided otherwise than "
              f"the default route: IoU {iou[r, j, i].item():.9f}, threshold "
              f"{th[r, 0, 0].item()}")
    if bool(bad.any()):
        raise AssertionError(f"{tag}: {int(bad.sum())} mask decisions differ "
                             f"from the default route off the threshold")
    return int(flips.sum())


def check_mask(torch, dev):
    """Phase 9: the suppression-mask kernel vs its plain version, and vs the
    default (overlap-kernel) route, at the nuScenes and Waymo shapes."""
    from pillarnet_lts_torch.ops import nms

    shapes = (("nuScenes", NMS_TASKS, NMS_K, (0.2,) * NMS_TASKS, 1),
              ("Waymo grouped", 3, WAYMO_K, WAYMO_THRESH, 2))
    res = {}
    for tag, R, K, ths, seed in shapes:
        boxes = det3d_from_bev(torch, nms_like_boxes(torch, seed, R, K)
                               .to(dev)).contiguous()
        thresh = torch.tensor(ths, dtype=torch.float32, device=dev)
        got = nms.suppression_matrix(boxes, thresh)
        ca, cb = nms.mask_kernel_corners(boxes)
        want = nms._suppression_matrix_plain(ca, cb, thresh)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"suppression_mask ({tag}) differs from "
                                 f"plain at {int((got != want).sum())} pairs")
        n_flips = mask_flips(torch, boxes, thresh, got, tag)
        valid = torch.rand((R, K), generator=torch.Generator(device=dev)
                           .manual_seed(seed), device=dev) > 0.05
        scores = torch.zeros((R, K), device=dev)
        if tag == "nuScenes":  # the static-threshold route
            mine = nms.rotated_nms(boxes, scores, valid, ths[0], K,
                                   use_mask_kernel=True)
            ref = nms.rotated_nms(boxes, scores, valid, ths[0], K)
        else:  # the per-row-threshold route, mask given
            mine = nms._select_topk_sorted(
                nms._greedy_suppress_mask(got, valid), K)
            ref = nms.rotated_nms_dynamic(boxes, scores, valid, thresh, K)
        same = all(torch.equal(x, y) for x, y in zip(mine, ref))
        if not same and n_flips == 0:
            raise AssertionError(f"{tag}: keep sets differ with equal masks")
        ms = cuda_ms(lambda: nms.suppression_matrix(boxes, thresh))
        p_ms = cuda_ms(lambda: nms._suppression_matrix_plain(ca, cb, thresh),
                       iters=PLAIN_ITERS, warmup=1)
        pairs = R * K * (K - 1) // 2
        b = bound(nbytes(boxes, thresh, got), pairs * MASK_PAIR_OPS, F32_OPS)
        print(f"[9] suppression mask {tag} {tuple(got.shape)}: bit-equal to "
              f"plain ({int(got.sum())} suppressing pairs); vs the default "
              f"route {n_flips} pairs decided otherwise (within {MASK_EPS}), "
              f"keep sets {'equal' if same else 'differ'} "
              f"({int(ref[1].sum())} kept); kernel {ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
        res[tag] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": p_ms,
                    "bound": b}
    return res["Waymo grouped"]


def check_scatter_tiled(torch, dev):
    """Phase 10: the sorted-run scatter-max kernel (K1') vs its plain
    version, the atomic kernel and `scatter_reduce_` at the Waymo and
    nuScenes shapes (signed f32), in bf16 and int8 at the Waymo shape, and
    with every point in one pillar."""
    from pillarnet_lts_torch.apis import load_config
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.ops.scatter import (
        pillar_scatter_max, pillar_scatter_max_tiled, scatter_max_tiled_plain)
    from pillarnet_lts_torch.ops.voxelize import PillarSpec, voxelize_points

    modes, err = {}, 0.0
    for tag, path in (("waymo", WAYMO), ("nuscenes", FLAGSHIP)):
        cfg = load_config(path)
        pc_range = cfg["point_cloud_range"]
        spec = PillarSpec(cfg["pillar_size"], tuple(pc_range))
        H, W = spec.height, spec.width
        pts, msk = synth_points_realistic(
            1, int(cfg["data"]["max_points"]), pc_range, seed=101,
            nsweeps=cfg.get("nsweeps", 10))
        feats, ids, valid = voxelize_points(
            torch.from_numpy(pts).to(dev), torch.from_numpy(msk).to(dev), spec)
        g = torch.Generator().manual_seed(1)
        w = (torch.randn(32, feats.shape[-1], generator=g) * 0.5).to(dev)
        x = torch.nn.functional.linear(feats, w).contiguous()  # signed
        args = (x, ids, valid, H, W)
        out = pillar_scatter_max_tiled(*args)
        library = scatter_library(torch, x, ids, valid, H * W)
        lib = (library()[:, :H * W].reshape(out[0].shape), out[1])
        for name, want in (("plain", scatter_max_tiled_plain(*args)),
                           ("the atomic kernel",
                            pillar_scatter_max(*args, nonneg=False)),
                           ("scatter_reduce_", lib)):
            err = max(err, check_scatter_equal(
                torch, f"pillar_scatter_max_tiled ({tag}) vs {name}", out,
                want, by_value=True))
        modes[tag] = scatter_times(
            torch, f"[10] K1' {tag} {tuple(x.shape)} -> {H}x{W}, equal by "
            f"value to plain, K1 and scatter_reduce_, {int(out[1].sum())} "
            f"pillars occupied", lambda: pillar_scatter_max_tiled(*args),
            lambda: scatter_max_tiled_plain(*args), x, ids, valid, out,
            F32_OPS)
        if tag != "waymo":
            continue
        for dtype in (torch.bfloat16, torch.int8):
            xd = (x.relu() * 20).round().clamp(0, 127).to(dtype) \
                if dtype == torch.int8 else x.to(dtype)
            a2 = (xd, ids, valid, H, W)
            got = pillar_scatter_max_tiled(*a2)
            err = max(err, check_scatter_equal(
                torch, f"pillar_scatter_max_tiled ({tag}, {dtype})", got,
                scatter_max_tiled_plain(*a2), by_value=True))
            modes[f"waymo_{str(dtype)[6:]}"] = scatter_times(
                torch, f"[10] K1' {tag} {dtype}, equal by value to plain",
                lambda: pillar_scatter_max_tiled(*a2),
                lambda: scatter_max_tiled_plain(*a2), xd, ids, valid, got,
                F32_OPS)
        # the longest run: every point in one pillar, walked by one group
        a1 = (x, one_pillar(torch, ids, W, H), valid, H, W)
        got = pillar_scatter_max_tiled(*a1)
        err = max(err, check_scatter_equal(
            torch, "pillar_scatter_max_tiled one pillar", got,
            scatter_max_tiled_plain(*a1), by_value=True))
        modes["one_pillar_waymo"] = scatter_times(
            torch, f"[10] K1' {tag}, all {int(valid.sum())} points in one "
            f"pillar, equal by value to plain",
            lambda: pillar_scatter_max_tiled(*a1),
            lambda: scatter_max_tiled_plain(*a1), x, a1[1], valid, got,
            F32_OPS, iters=3)
    return {"max_abs_err": err, "modes": modes}


def serve_waymo(torch, dev, card):
    """Phases 11-12: the Waymo config as a server on the default route,
    then with the sorted-run scatter-max, then also with the mask kernel.
    Returns the launch counts of phase 12."""
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.ops import _kernels, nms, scatter
    from pillarnet_lts_torch.runtime.serving import ServingPipeline

    cfg = load_config(WAYMO)
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    posts = cfg["test_cfg"]["nms"]["nms_post_max_size"]
    post = sum(posts)
    model = build_model_from_cfg(cfg, device=dev, seed=0)
    clouds = [synth_points_realistic(1, n, pc_range, seed=200 + s,
                                      nsweeps=cfg["nsweeps"])
              for s in range(13)]
    calib = synth_points_realistic(1, n, pc_range, seed=99, nsweeps=1)
    spread_head_outputs(model, torch.from_numpy(calib[0]).to(dev),
                        torch.from_numpy(calib[1]).to(dev))
    test_cfg = model.processed_test_cfg()
    if test_cfg["nms"]["nms_iou_threshold"] != [list(WAYMO_THRESH)]:
        raise AssertionError(f"per-class params not regrouped: {test_cfg}")

    def serve(pipe, cloud, kernels, tag):
        before = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        det = list(pipe.map([(torch.from_numpy(cloud[0]).to(dev),
                              torch.from_numpy(cloud[1]).to(dev))]))[0]
        dt = (time.perf_counter() - t0) * 1e3
        for name, count in _kernels.LAUNCHES.items():
            if (count > before[name]) != (name in kernels):
                raise AssertionError(f"{tag}: {name} launched="
                                     f"{count > before[name]}")
        if det["box3d_lidar"].shape != (1, post, 7) or not (
                np.isfinite(det["box3d_lidar"]).all()
                and np.isfinite(det["scores"]).all()):
            raise AssertionError(f"{tag}: bad detections")
        return det, dt

    # phase 11: default route (atomic scatter-max, overlap kernel)
    pipe = ServingPipeline(make_infer_fn(model, test_cfg), depth=1)
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    lat, dets = [], []
    for i, cloud in enumerate(clouds):
        det, dt = serve(pipe, cloud, {"pillar_scatter_max", "rotated_overlap"},
                        f"waymo request {i}")
        dets.append(det)
        if i >= 3:
            lat.append(dt)
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    starts = np.cumsum([0] + posts)
    per_class = [[int(d["mask"][0, starts[k]:starts[k + 1]].sum())
                  for k in range(3)] for d in dets]
    for k in range(3):
        if min(c[k] for c in per_class) == 0:
            raise AssertionError(f"class {k} kept no box on some request")
        labels = np.concatenate([d["label_preds"][0, starts[k]:starts[k + 1]]
                                 [d["mask"][0, starts[k]:starts[k + 1]]]
                                 for d in dets])
        if not (labels == k).all():
            raise AssertionError(f"class {k} slots hold other labels")
    q = statistics.quantiles(lat, n=10)
    print(f"[11] waymo pillarnet34_waymo bs=1, {len(lat)} timed requests "
          f"(after 3 warm-up), host-synced latency: p50 "
          f"{statistics.median(lat):.2f} ms, p90 {q[8]:.2f} ms; peak "
          f"allocated {peak / 2**30:.3f} GiB; kept per class (of {posts}) "
          f"first requests {per_class[:3]}, mean "
          f"{np.mean(per_class, axis=0).round(1).tolist()}; launches over "
          f"{len(clouds)} requests {launches}; card: {card}")

    # phase 12: the switches, on three of the same clouds
    mask_cfg = dict(test_cfg, nms=dict(test_cfg["nms"], use_mask_kernel=True))
    seen = []
    real = nms.suppression_matrix

    def recording(boxes, thresh):  # the candidates the mask kernel sees
        out = real(boxes, thresh)
        seen.append((boxes, thresh, out))
        return out

    _kernels.reset_launches()
    try:
        scatter.set_backend("tiled")
        tiled = ServingPipeline(make_infer_fn(model, test_cfg), depth=1)
        masked = ServingPipeline(make_infer_fn(model, mask_cfg), depth=1)
        nms.suppression_matrix = recording
        for i in (3, 7, 11):
            det, dt = serve(tiled, clouds[i], {"pillar_scatter_max_tiled",
                                               "rotated_overlap"},
                            f"tiled request {i}")
            for key in det:
                if not np.array_equal(det[key], dets[i][key]):
                    raise AssertionError(f"tiled request {i}: {key} differs "
                                         f"from the default route's")
            seen.clear()
            det, dt_m = serve(masked, clouds[i], {"pillar_scatter_max_tiled",
                                                  "suppression_mask"},
                              f"mask-kernel request {i}")
            (boxes, thresh, m_kernel), = seen
            flips = mask_flips(torch, boxes, thresh, m_kernel,
                               f"waymo request {i}")
            same = all(np.array_equal(det[k], dets[i][k]) for k in det)
            if not same and flips == 0:
                raise AssertionError(f"mask-kernel request {i}: detections "
                                     f"differ with equal masks")
            print(f"[12] request {i}: tiled scatter {dt:.2f} ms, detections "
                  f"identical; + mask kernel {dt_m:.2f} ms, {flips} pairs "
                  f"decided otherwise (within {MASK_EPS}), detections "
                  f"{'identical' if same else 'differ'}")
    finally:
        nms.suppression_matrix = real
        scatter.set_backend("auto")
    launches = dict(_kernels.LAUNCHES)
    print(f"[12] launches over 3 + 3 requests: {launches}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from pillarnet_lts_torch.apis import load_config
    from pillarnet_lts_torch.ops import _kernels

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[0] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _kernels.build_all()
    print(f"[1] built {sorted(_kernels.KERNELS)} in "
          f"{time.perf_counter() - t0:.2f} s")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(FLAGSHIP)
    scatter = check_scatter(torch, dev, cfg["point_cloud_range"],
                            cfg["pillar_size"])
    overlap = check_overlap(torch, dev)
    check_golden(torch, dev)
    serve_flagship(torch, dev, card)
    model, cloud, post = int8_flagship(torch, dev)
    calls = capture_int8_convs(torch, model, on_card(torch, dev, cloud(50)))
    conv = check_int8_conv(torch, calls)
    stage = check_int8_stage(torch, model, calls)
    del calls
    launches = serve_int8_flagship(torch, dev, card, model, cloud, post)
    mask = check_mask(torch, dev)
    tiled = check_scatter_tiled(torch, dev)
    switched = serve_waymo(torch, dev, card)

    # launches: K1, K2, K4, K5 from the int8 flagship's run with the fused
    # stage on (phase 8), K1' and K3 from the Waymo run with the switches
    # on (phase 12); times, errors and bounds: phases 2-3, 6-7, 9-10. K1's
    # and K1''s rows carry the mode of their launches' path (int8 codes,
    # the Waymo shape) and every mode's times under "modes"
    def row(name, source, replaces, count, res, ms, plain_ms, b, lib=None):
        return {"name": name, "route": "cuda",
                "source": f"pillarnet_lts_torch/csrc/{source}",
                "replaces": f"pillarnet_lts_tpu/ops/pallas/{replaces}",
                "launches": count, "max_abs_err": res["max_abs_err"],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
                "bound_by": b[1], "library_ms": lib}

    def scatter_row(name, source, replaces, count, res, main):
        m = res["modes"][main]
        return dict(row(name, source, replaces, count, res, m["ms"],
                        m["plain_ms"], (m["bound_ms"], m["bound_by"]),
                        m["library_ms"]), main_mode=main, modes=res["modes"])

    record = {"kernels": [
        scatter_row("pillar_scatter_max", "pillar_scatter_max.cu",
                    "voxelize_kernel.py:411", launches["pillar_scatter_max"],
                    scatter, "int8"),
        scatter_row("pillar_scatter_max_tiled", "pillar_scatter_max_tiled.cu",
                    "voxelize_kernel.py:78",
                    switched["pillar_scatter_max_tiled"], tiled, "waymo"),
        row("rotated_overlap", "rotated_overlap.cu", "iou_kernel.py:105",
            launches["rotated_overlap"], overlap, overlap["ms"],
            overlap["plain_ms"], overlap["bound"]),
        row("suppression_mask", "suppression_mask.cu", "nms_kernel.py:221",
            switched["suppression_mask"], mask, mask["ms"], mask["plain_ms"],
            mask["bound"]),
        dict(row("int8_conv", "int8_conv.cu", "s2d_conv_kernel.py:137",
                 launches["int8_conv"], conv, conv["ms"], conv["plain_ms"],
                 conv["bound"]), alone_ms=conv["alone_ms"],
             main_shape=conv["main_shape"], shapes=conv["shapes"],
             frame=conv["frame"]),
        dict(row("int8_stage", "int8_stage.cu", "s2d_conv_kernel.py:385",
                 launches["int8_stage"], stage, stage["ms"],
                 stage["plain_ms"], stage["bound"]),
             alone_ms=stage["alone_ms"], per_conv_ms=stage["per_conv_ms"],
             per_conv_alone_ms=stage["per_conv_alone_ms"]),
    ]}
    for k in record["kernels"]:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on the path")
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
