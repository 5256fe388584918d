#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`pillarnet_lts_torch`) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each of which raises on failure:
  0. card name and power limit, torch and CUDA versions;
  1. build every CUDA kernel from `pillarnet_lts_torch/csrc/` (nvcc, sm_90a,
     one nvcc per source, all at once);
  2. the pillar scatter-max kernel against its plain version at the
     flagship shape (1 x 262,144 points x 32 channels -> 1440 x 1440), both
     `nonneg` modes and the int8 code mode, bit-equal;
  3. the rotated-overlap kernel against its plain version at (6, 1000, 1000)
     pairs, within 1e-4 m^2;
  4. the committed golden fixture (`tests/fixtures/golden_e2e_r3.npz`)
     replayed through the port with the fixture's own weights, within the
     tolerances of `tests/test_golden_e2e.py`;
  5. the flagship config `configs/pillarnet/pillarnet34_nusc.py` with seeded
     random weights, serving 3 warm-up + 10 timed requests at batch 1 and 2
     requests at batch 2 through `ServingPipeline(make_infer_fn(model))`,
     with both kernels' launch counters rising on every request;
  6. the int8 conv kernel against its plain version at flagship shapes: a
     stride-1 stage conv (1 x 1440^2 x 32, residual and mask), the 32 -> 64
     stride-2 down conv, a 256-channel neck conv at 180^2; bit-equal;
  7. the fused int8 stage kernel against its plain version at
     1 x 1440^2 x 32, n = 7 convs; bit-equal;
  8. the int8 canary of tests/test_quant_int8.py:88-106 (its demo model at
     the int8 kernels' 32-channel widths: int8 head outputs within 0.2 of
     the bf16 ones); the int8 deploy config
     `configs/pillarnet/pillarnet34_nusc_int8.py`, seeded random weights,
     calibrated on 4 synthetic clouds (its heatmaps' distance from the bf16
     forward is printed), then serving 3 warm-up + 10 timed requests at
     batch 1 with the fused stage on (`s2d_pallas`) and off, every request
     raising the counters of the kernels of its path.

The second-to-last line of stdout is the kernels' JSON record, the line
before it the card's `nvidia-smi` name and power limit, and the last line
`{"ok": true, "device": {...}}`. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result. No JAX is imported.
"""

import json
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

N_POINTS = 262144
NMS_TASKS, NMS_K = 6, 1000
AREA_ATOL = 1e-4  # m^2, as tests/test_pallas_iou.py holds the TPU kernel
TIMING_ITERS = 20
PLAIN_ITERS = 3  # the int8 plain versions sum in float64: slow
F32_PATH = {"pillar_scatter_max", "rotated_overlap"}  # kernels of phase 5
HM_REL_BOUND = 0.2  # int8 vs bf16 heads, tests/test_quant_int8.py:88-106


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


def check_scatter(torch, dev, pc_range, pillar_size):
    """Phase 2: pillar scatter-max kernel vs plain, flagship shape; returns
    the timings and the cloud's (1, H, W) occupancy."""
    from __graft_entry__ import _synth_points_realistic
    from pillarnet_lts_torch.ops.scatter import pillar_scatter_max
    from pillarnet_lts_torch.ops.voxelize import (
        PillarSpec, scatter_max_to_grid, voxelize_points)

    spec = PillarSpec(pillar_size, tuple(pc_range))
    H, W = spec.height, spec.width
    pts, msk = _synth_points_realistic(1, N_POINTS, pc_range, seed=100)
    pts = torch.from_numpy(pts).to(dev)
    msk = torch.from_numpy(msk).to(dev)
    feats, ids, valid = voxelize_points(pts, msk, spec)
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(32, feats.shape[-1], generator=g) * 0.5).to(dev)
    signed = torch.nn.functional.linear(feats, w).contiguous()
    inputs = {True: torch.relu(signed), False: signed}

    res = {"max_abs_err": 0.0}
    for nonneg, x in inputs.items():
        grid_k, occ_k = pillar_scatter_max(x, ids, valid, H, W, nonneg=nonneg)
        grid_p, occ_p = scatter_max_to_grid(x, ids, valid, H, W)
        torch.cuda.synchronize()
        if not (torch.equal(grid_k, grid_p) and torch.equal(occ_k, occ_p)):
            raise AssertionError(
                f"pillar_scatter_max(nonneg={nonneg}) differs from plain: "
                f"max |d| {(grid_k - grid_p).abs().max().item()}, occupancy "
                f"mismatches {(occ_k != occ_p).sum().item()}")
        err = (grid_k - grid_p).abs().max().item()
        res["max_abs_err"] = max(res["max_abs_err"], err)
        k_ms = cuda_ms(lambda: pillar_scatter_max(x, ids, valid, H, W,
                                                  nonneg=nonneg))
        p_ms = cuda_ms(lambda: scatter_max_to_grid(x, ids, valid, H, W))
        tag = "nonneg" if nonneg else "signed"
        res[f"{tag}_ms"], res[f"{tag}_plain_ms"] = k_ms, p_ms
        print(f"[2] scatter-max {tag}: bit-equal; occupied pillars "
              f"{occ_k.sum().item()} of {H * W}; kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms (mean of {TIMING_ITERS}, incl. the "
              f"zero-filled grid allocation)")
    res["occ"] = occ_k

    # int8 code mode: the int8 deploy's payload
    x = inputs[True]
    codes = torch.round(x * (127.0 / x.max())).clamp_(0, 127).to(torch.int8)
    grid_k, occ_k = pillar_scatter_max(codes, ids, valid, H, W, nonneg=True)
    grid_p, occ_p = scatter_max_to_grid(codes, ids, valid, H, W)
    torch.cuda.synchronize()
    if not (torch.equal(grid_k, grid_p) and torch.equal(occ_k, occ_p)):
        raise AssertionError("pillar_scatter_max(int8 codes) differs from "
                             "plain")
    res["int8_ms"] = cuda_ms(lambda: pillar_scatter_max(
        codes, ids, valid, H, W, nonneg=True))
    res["int8_plain_ms"] = cuda_ms(lambda: scatter_max_to_grid(
        codes, ids, valid, H, W))
    print(f"[2] scatter-max int8 codes: bit-equal; kernel "
          f"{res['int8_ms']:.4f} ms, plain {res['int8_plain_ms']:.4f} ms")
    return res


def nms_like_boxes(torch, seed):
    """(T, K, 5) pcdet BEV boxes in +-54 m, dims 0.3-12 m, with clustered,
    identical and edge-touching pairs."""
    rng = np.random.RandomState(seed)
    T, K = NMS_TASKS, NMS_K
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
    print(f"[3] rotated overlap {tuple(got.shape)}: max |d| {err:.3e} m^2 "
          f"(<= {AREA_ATOL}); pairs with |d| > 1e-6: {n_over} of "
          f"{got.numel()} ({n_pos} overlapping); kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}


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
    from __graft_entry__ import _synth_points_realistic
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime.serving import ServingPipeline

    cfg = load_config(FLAGSHIP)
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    model = build_model_from_cfg(cfg, device=dev, seed=0)
    post = cfg["test_cfg"]["nms"]["nms_post_max_size"] * len(cfg["tasks"])
    clouds = [_synth_points_realistic(1, n, pc_range, seed=s)
              for s in range(13)]
    clouds += [_synth_points_realistic(2, n, pc_range, seed=s)
               for s in (13, 14)]
    # random weights: spread the head outputs so that NMS sees valid boxes
    calib = _synth_points_realistic(1, n, pc_range, seed=99)
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
    for mod in ("jax", "pillarnet_lts_tpu"):
        if mod in sys.modules:
            raise AssertionError(f"the port imported {mod}")
    q = statistics.quantiles(lat, n=10)
    print(f"[5] flagship pillarnet34_nusc bs=1, {len(lat)} timed requests "
          f"(after 3 warm-up), host-synced latency: p50 "
          f"{statistics.median(lat):.2f} ms, p90 {q[8]:.2f} ms; peak "
          f"allocated {peak / 2**30:.3f} GiB; mean kept boxes "
          f"{statistics.mean(kept):.1f} of {post}; card: {card}")
    print(f"[5] launches over {len(clouds)} requests: {launches}")


def _int8_conv_case(torch, gen, dev, occ, cin, cout, stride, residual):
    """Random bf16 activations zero off `occ` (B, H, W), a random int8
    kernel, scales that keep the outputs O(1), the output-site mask."""
    import torch.nn.functional as F

    bf = torch.bfloat16
    B, H, W = occ.shape
    x = torch.randn((B, H, W, cin), generator=gen, device=dev)
    x = (x * occ[..., None]).to(bf)
    w_q = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen,
                        device=dev, dtype=torch.int32).to(torch.int8)
    inv_s = (127.0 / x.float().abs().amax()).reshape(())
    dq = (torch.rand(cout, generator=gen, device=dev) + 0.5) \
        / (127.0 * 127.0 * (9 * cin) ** 0.5) * 4
    shift = torch.randn(cout, generator=gen, device=dev) * 0.1
    out_occ = occ
    if stride == 2:
        out_occ = F.max_pool2d(occ[:, None].float(), 3, 2, 1)[:, 0] > 0.5
    mask = out_occ.to(bf)
    res = None
    if residual:
        res = (torch.randn((*out_occ.shape, cout), generator=gen, device=dev)
               * out_occ[..., None]).to(bf)
    return (x, w_q, inv_s, dq, shift, stride), dict(mask=mask, residual=res)


def check_int8_conv(torch, dev, occ):
    """Phase 6: the int8 conv kernel vs plain at three flagship shapes."""
    from pillarnet_lts_torch.ops.quant import (
        int8_conv_bn_act, int8_conv_bn_act_plain)

    gen = torch.Generator(device=dev).manual_seed(6)
    dense = torch.ones((1, 180, 180), dtype=torch.bool, device=dev)
    cases = [
        ("stage-1 conv 1x1440^2x32, residual + mask", occ, 32, 32, 1, True),
        ("down conv 32->64 stride 2, 1440^2 -> 720^2", occ, 32, 64, 2, False),
        ("neck conv 1x180^2x256 -> 256, dense", dense, 256, 256, 1, False),
    ]
    res = {"max_abs_err": 0.0}
    for i, (tag, o, cin, cout, stride, residual) in enumerate(cases):
        args, kw = _int8_conv_case(torch, gen, dev, o, cin, cout, stride,
                                   residual)
        if o is dense:
            kw["mask"] = None
        got = int8_conv_bn_act(*args, **kw)
        want = int8_conv_bn_act_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"int8_conv ({tag}) differs from plain: "
                                 f"max |d| {err}, {int((got != want).sum())}"
                                 f" elements")
        k_ms = cuda_ms(lambda: int8_conv_bn_act(*args, **kw))
        p_ms = cuda_ms(lambda: int8_conv_bn_act_plain(*args, **kw),
                       iters=PLAIN_ITERS, warmup=1)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if i == 0:
            res["ms"], res["plain_ms"] = k_ms, p_ms
        print(f"[6] int8 conv, {tag}: bit-equal (max |out| "
              f"{got.float().abs().max().item():.3f}); kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms")
    return res


def check_int8_stage(torch, dev, occ, n_convs=7):
    """Phase 7: the fused int8 stage kernel vs plain, 1 x 1440^2 x 32."""
    from pillarnet_lts_torch.ops.int8_stage import int8_stage, int8_stage_plain

    gen = torch.Generator(device=dev).manual_seed(7)
    convs = [_int8_conv_case(torch, gen, dev, occ, 32, 32, 1, False)[0]
             for _ in range(n_convs)]
    x = convs[0][0]
    w_q, inv_s, dq, shift = (torch.stack([c[k] for c in convs])
                             for k in (1, 2, 3, 4))
    args = (x, w_q, inv_s, dq, shift, occ.to(torch.bfloat16))
    got = int8_stage(*args)
    want = int8_stage_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"int8_stage differs from plain: max |d| {err}, "
                             f"{int((got != want).sum())} elements")
    k_ms = cuda_ms(lambda: int8_stage(*args))
    p_ms = cuda_ms(lambda: int8_stage_plain(*args), iters=PLAIN_ITERS,
                   warmup=1)
    print(f"[7] fused int8 stage, n = {n_convs}, 1x1440^2x32: bit-equal (max "
          f"|out| {got.float().abs().max().item():.3f}); kernel {k_ms:.4f} "
          f"ms, plain {p_ms:.4f} ms")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}


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


def serve_int8_flagship(torch, dev, card):
    """Phase 8: the int8 deploy config as a server, fused stage on and off;
    returns the launch counts of the fused-stage run."""
    from __graft_entry__ import _synth_points_realistic
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime.quantize import calibrate
    from pillarnet_lts_torch.runtime.serving import ServingPipeline

    cfg = load_config(FLAGSHIP_INT8)
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    post = cfg["test_cfg"]["nms"]["nms_post_max_size"] * len(cfg["tasks"])

    def cloud(seed, batch=1):
        p, m = _synth_points_realistic(batch, n, pc_range, seed=seed)
        return torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev)

    model = build_model_from_cfg(cfg, device=dev, seed=0)
    calib = [cloud(s) for s in (90, 91, 92, 93)]
    with torch.no_grad():
        spread_head_outputs(model, *cloud(99))  # uncalibrated: bf16 path
        ref = model(*calib[0])
        t0 = time.perf_counter()
        calibrate(model, calib)
        torch.cuda.synchronize()
        t_cal = time.perf_counter() - t0
        got = model(*calib[0])
    print(f"[8] int8 flagship calibrated on 4 clouds in {t_cal:.2f} s; "
          f"heatmap |int8 - bf16| / max|bf16| per task on a calibration "
          f"cloud (random weights, reported): "
          f"{[round(e, 4) for e in rel_errors(ref, got, ('hm',))]}")
    demo_canary(torch, dev)

    clouds = [_synth_points_realistic(1, n, pc_range, seed=s)
              for s in range(13)]
    path = {"pillar_scatter_max", "rotated_overlap", "int8_conv"}
    launches = None
    for fused in (True, False):
        model.backbone_net.s2d_pallas = fused
        kernels = path | {"int8_stage"} if fused else path
        pipe = ServingPipeline(make_infer_fn(model), depth=1)
        torch.cuda.reset_peak_memory_stats(dev)
        _kernels.reset_launches()
        lat, kept = [], []
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
        if fused:
            launches = counts
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
    conv = check_int8_conv(torch, dev, scatter["occ"])
    stage = check_int8_stage(torch, dev, scatter["occ"])
    launches = serve_int8_flagship(torch, dev, card)

    # launches: the int8 flagship's run with the fused stage on, the path
    # this slice adds (all four kernels); times and errors: phases 2-3, 6-7
    record = {"kernels": [
        {"name": "pillar_scatter_max", "route": "cuda",
         "source": "pillarnet_lts_torch/csrc/pillar_scatter_max.cu",
         "replaces": "pillarnet_lts_tpu/ops/pallas/voxelize_kernel.py:411",
         "launches": launches["pillar_scatter_max"],
         "max_abs_err": scatter["max_abs_err"], "ms": scatter["int8_ms"],
         "plain_ms": scatter["int8_plain_ms"]},
        {"name": "rotated_overlap", "route": "cuda",
         "source": "pillarnet_lts_torch/csrc/rotated_overlap.cu",
         "replaces": "pillarnet_lts_tpu/ops/pallas/iou_kernel.py:105",
         "launches": launches["rotated_overlap"],
         "max_abs_err": overlap["max_abs_err"], "ms": overlap["ms"],
         "plain_ms": overlap["plain_ms"]},
        {"name": "int8_conv", "route": "cuda",
         "source": "pillarnet_lts_torch/csrc/int8_conv.cu",
         "replaces": "pillarnet_lts_tpu/ops/pallas/s2d_conv_kernel.py:137",
         "launches": launches["int8_conv"],
         "max_abs_err": conv["max_abs_err"], "ms": conv["ms"],
         "plain_ms": conv["plain_ms"]},
        {"name": "int8_stage", "route": "cuda",
         "source": "pillarnet_lts_torch/csrc/int8_stage.cu",
         "replaces": "pillarnet_lts_tpu/ops/pallas/s2d_conv_kernel.py:385",
         "launches": launches["int8_stage"],
         "max_abs_err": stage["max_abs_err"], "ms": stage["ms"],
         "plain_ms": stage["plain_ms"]},
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
