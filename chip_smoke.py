#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`pillarnet_lts_torch`) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each of which raises on failure:
  0. card name and power limit, torch and CUDA versions;
  1. build both CUDA kernels from `pillarnet_lts_torch/csrc/` (nvcc, sm_90a);
  2. the pillar scatter-max kernel against its plain version at the
     flagship shape (1 x 262,144 points x 32 channels -> 1440 x 1440), both
     `nonneg` modes, bit-equal;
  3. the rotated-overlap kernel against its plain version at (6, 1000, 1000)
     pairs, within 1e-4 m^2;
  4. the committed golden fixture (`tests/fixtures/golden_e2e_r3.npz`)
     replayed through the port with the fixture's own weights, within the
     tolerances of `tests/test_golden_e2e.py`;
  5. the flagship config `configs/pillarnet/pillarnet34_nusc.py` with seeded
     random weights, serving 3 warm-up + 10 timed requests at batch 1 and 2
     requests at batch 2 through `ServingPipeline(make_infer_fn(model))`,
     with both kernels' launch counters rising on every request.

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
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_e2e_r3.npz")

N_POINTS = 262144
NMS_TASKS, NMS_K = 6, 1000
AREA_ATOL = 1e-4  # m^2, as tests/test_pallas_iou.py holds the TPU kernel
TIMING_ITERS = 20


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
    """Phase 2: pillar scatter-max kernel vs plain, flagship shape."""
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
    """Phase 5: the flagship config as a server; returns launch counts."""
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
            if count <= before[name]:
                raise AssertionError(f"request did not launch {name}")
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
    launches = serve_flagship(torch, dev, card)

    record = {"kernels": [
        {"name": "pillar_scatter_max", "route": "cuda",
         "source": "pillarnet_lts_torch/csrc/pillar_scatter_max.cu",
         "replaces": "pillarnet_lts_tpu/ops/pallas/voxelize_kernel.py:411",
         "launches": launches["pillar_scatter_max"],
         "max_abs_err": scatter["max_abs_err"], "ms": scatter["nonneg_ms"],
         "plain_ms": scatter["nonneg_plain_ms"]},
        {"name": "rotated_overlap", "route": "cuda",
         "source": "pillarnet_lts_torch/csrc/rotated_overlap.cu",
         "replaces": "pillarnet_lts_tpu/ops/pallas/iou_kernel.py:105",
         "launches": launches["rotated_overlap"],
         "max_abs_err": overlap["max_abs_err"], "ms": overlap["ms"],
         "plain_ms": overlap["plain_ms"]},
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
