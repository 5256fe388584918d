"""PyTorch port, the legacy detectors and circular NMS against the JAX
package on the same numpy inputs and weights: `box_center_points`,
`BEVFeatureExtractor`, `BEVFeature`, `VoxelNet` and `TwoStageDetector`
(`models/detectors/legacy.py`), `ops/nms.py::circle_nms` and the
circular route of CenterHead's predict.

Tolerances:
- box-centre points: the centres equal; the edge midpoints within
  4.8e-7 m (one ulp at the +-6.4 m extent: XLA and torch sin/cos differ by
  an ulp on some angles, and XLA contracts the turn into FMAs);
- the extractor's cell coordinates: bit-equal to jitted JAX (both multiply
  by the f32 reciprocal of the cell size), checked on points within 10
  ulps of every cell edge; its bilinear features bit-equal to JAX
  compiled without fusion;
- `BEVFeature` (convolutions): rtol = atol = 1e-4, as the other module
  tests;
- VoxelNet: head maps 1e-4, detections as the single-stage slice tests;
- the `twostage18_demo` eval at num_point 5 and 1 (as
  `test_torch_port_rcnn.py`'s Pillar R-CNN eval): RoI labels and the
  final mask equal, RoI scores within 1e-5, boxes within 1e-4 m + 1e-5
  relative (random-weight boxes reach 10 m sizes: f32 sums in other
  orders), scores within 1e-5, after the score and IoU margins are
  asserted;
- circular NMS: keep sets bit-equal (squared distances of the same f32
  centres, one rounding each; the candidates' distances are asserted off
  the radius by more than an ulp), detections of the predict path equal
  (boxes and scores within 1e-6: the same f32 decode).
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillarnet_lts_tpu.models import build_detector as build_jax_detector
from pillarnet_lts_tpu.models.bbox_heads.center_head import (
    CenterHeadMath as JCenterHeadMath,
)
from pillarnet_lts_tpu.models.detectors.legacy import (
    box_center_points as jbox_center_points,
)
from pillarnet_lts_tpu.models.second_stage.bev_feature import (
    BEVFeature as JBEVFeature,
)
from pillarnet_lts_tpu.models.second_stage.bev_feature import (
    BEVFeatureExtractor as JBEVFeatureExtractor,
)
from pillarnet_lts_tpu.ops.nms import circle_nms as jcircle_nms
from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                      spread_head_outputs)
from pillarnet_lts_torch.core.bbox import box_np_ops
from pillarnet_lts_torch.eval_utils import make_infer_fn
from pillarnet_lts_torch.models.bbox_heads.center_head import CenterHeadMath
from pillarnet_lts_torch.models.detectors import (PillarNet,
                                                  TwoStageDetector,
                                                  VoxelNet,
                                                  box_center_points)
from pillarnet_lts_torch.models.second_stage import (BEVFeature,
                                                     BEVFeatureExtractor)
from pillarnet_lts_torch.ops.iou3d import rotated_iou_bev, to_pcdet_bev
from pillarnet_lts_torch.ops.nms import circle_nms
from pillarnet_lts_torch.runtime.convert import load_jax_variables
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_torch_port_int8 import jit_nofma
from test_torch_port_modules import (TOL, jit_apply, random_variables,
                                     sparse_grid)
from test_torch_port_rcnn import random_rois, spread_rcnn_heads

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DEMO = os.path.join(ROOT, "configs", "demo")
PC_START = [-6.4, -6.4]
VOXEL = [0.4, 0.4]  # out_stride 4 -> 1.6 m cells (1 / 1.6 inexact)


def _cloud(cfg, seed, n=4096):
    from __graft_entry__ import _synth_points_realistic

    return _synth_points_realistic(1, n, cfg["point_cloud_range"], seed=seed,
                                   nsweeps=1)


# ---- box-centre pooling ----------------------------------------------------


@pytest.mark.parametrize("num_point", [1, 5])
def test_box_center_points_match_jax(num_point):
    rois = random_rois(41, 2, 300)
    want = np.asarray(jax.jit(lambda r: jbox_center_points(r, num_point))(
        rois))
    got = box_center_points(torch.from_numpy(rois), num_point).numpy()
    assert got.shape == want.shape == (2, num_point * 300, 2)
    np.testing.assert_array_equal(got[:, :300], rois[..., :2])
    assert np.abs(got - want).max() <= np.spacing(np.float32(6.4))
    if num_point == 5:
        # the reference's corner midpoints ((c0+c1)/2, (c2+c3)/2,
        # (c0+c3)/2, (c1+c2)/2), as `tests/test_legacy_detectors.py`
        r = rois[0]
        c = box_np_ops.center_to_corner_box2d(r[:, :2], r[:, 3:5], r[:, 6])
        mids = np.concatenate([r[:, :2], (c[:, 0] + c[:, 1]) / 2,
                               (c[:, 2] + c[:, 3]) / 2,
                               (c[:, 0] + c[:, 3]) / 2,
                               (c[:, 1] + c[:, 2]) / 2])
        np.testing.assert_allclose(got[0], mids, atol=1e-5)
    with pytest.raises(NotImplementedError, match="num_point"):
        box_center_points(torch.from_numpy(rois), 3)


def _edge_points(B=2, cells=16, ulps=10):
    """Points within `ulps` f32 ulps of every cell edge of a 16 x 16 map
    of 1.6 m cells (on x, and in reverse order on y); the rest random,
    off the map too."""
    edges = np.float32(PC_START[0]) + np.arange(cells + 1,
                                                dtype=np.float32) * 1.6
    near = []
    for e in edges.astype(np.float32):
        x = e
        for _ in range(ulps):
            x = np.nextafter(x, np.float32(-np.inf))
        for _ in range(2 * ulps + 1):
            near.append(x)
            x = np.nextafter(x, np.float32(np.inf))
    near = np.asarray(near, np.float32)
    pts = np.random.RandomState(42).uniform(-8.0, 8.0, (B, 400, 2)).astype(
        np.float32)
    pts[:, :len(near), 0] = near
    pts[:, :len(near), 1] = near[::-1]
    return pts


def test_bev_feature_extractor_matches_jax():
    rng = np.random.RandomState(43)
    B, H, W, C = 2, 16, 16, 8
    bev = rng.randn(B, H, W, C).astype(np.float32)
    pts = _edge_points(B)
    kw = dict(pc_start=PC_START, voxel_size=VOXEL, out_stride=4,
              num_point=5)
    jm = JBEVFeatureExtractor(**kw)

    # the cell coordinates: the module's expression, jitted
    def jcells(c):
        return ((c[..., 0] - PC_START[0]) / (VOXEL[0] * 4),
                (c[..., 1] - PC_START[1]) / (VOXEL[0] * 4))

    tm = BEVFeatureExtractor(**kw)
    from pillarnet_lts_torch.models.second_stage import bev_cells

    got_cells = bev_cells(torch.from_numpy(pts), PC_START, tm.inv_cell)
    for g, w in zip(got_cells, jax.jit(jcells)(pts)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a true division would put some of these points in other cells
    # (two, 1 and 2 ulps below the edge at 14.4 m)
    exact = (pts[..., 0] - np.float32(PC_START[0])) / np.float32(1.6)
    assert (np.floor(exact) != np.floor(got_cells[0].numpy())).any()

    want = jit_nofma(lambda b, c: jm.apply({}, b, c, train=False),
                     jnp.asarray(bev), jnp.asarray(pts))
    got = tm(torch.from_numpy(bev).permute(0, 3, 1, 2),
             torch.from_numpy(pts)).numpy()
    assert got.shape == want.shape == (B, 80, 5 * C)
    np.testing.assert_array_equal(got, np.asarray(want))
    jitted = np.asarray(jit_apply(jm, {}, jnp.asarray(bev), jnp.asarray(pts)))
    np.testing.assert_allclose(got, jitted, rtol=0, atol=1e-6)


_BEV_FEATURE_VARIANTS = {
    # out_stride, feature_sources: at 8 the conv4 map takes the up path
    # (1 x 1, no bias) and conv3 the strided down path; at 4 the top-down
    # map and conv4 are transposed convs and conv3 (ratio 1) the down path
    # with k = 1 (bias, masked BN over its occupancy)
    "s8": (8, ["conv3", "conv4"]),
    "s4": (4, ["conv2", "conv3", "conv4"]),
}


@pytest.mark.parametrize("variant", sorted(_BEV_FEATURE_VARIANTS))
def test_bev_feature_matches_flax(variant):
    out_stride, sources = _BEV_FEATURE_VARIANTS[variant]
    B, R, n = 2, 16, 32
    chans = {"conv1": 8, "conv2": 12, "conv3": 16, "conv4": 20}
    strides = {"conv1": 1, "conv2": 2, "conv3": 4, "conv4": 8}
    feats = {k: sparse_grid(50 + i, B, n // strides[k], n // strides[k], c,
                            occupancy=0.4)
             for i, (k, c) in enumerate(chans.items())}
    bev = np.random.RandomState(51).randn(B, n // 8, n // 8, 24).astype(
        np.float32)
    rois = random_rois(52, B, R, extent=6.0)
    kw = dict(feature_sources=sources, pillar_size=0.4,
              pc_range=[-6.4, -6.4, -2.0, 6.4, 6.4, 4.0],
              out_stride=out_stride, grid_size=7, in_channels=24,
              share_channels=16, backbone_channels=chans,
              backbone_strides=strides)
    jm = JBEVFeature(**kw)
    jfeats = {k: (jnp.asarray(g), jnp.asarray(m)) for k, (g, m) in
              feats.items()}
    args = (jnp.asarray(bev), jfeats, jnp.asarray(rois))
    variables = random_variables(jm, 53, *args, train=False)
    want = jit_apply(jm, variables, *args)

    tm = load_jax_variables(BEVFeature(**kw).eval(), variables)
    tfeats = {k: (torch.from_numpy(g).permute(0, 3, 1, 2),
                  torch.from_numpy(m)) for k, (g, m) in feats.items()}
    with torch.inference_mode():
        got = tm(torch.from_numpy(bev).permute(0, 3, 1, 2), tfeats,
                 torch.from_numpy(rois))
    assert tuple(got[1].shape) == (B, R, 49, 16)
    for g, w, name in zip(got, want, ("roi", "point", "coords")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    assert np.abs(got[1].numpy()).max() > 0.1


# ---- the detectors -----------------------------------------------------------


def _guards(port, out, first, test_cfg):
    """No first-stage candidate within 1e-4 of the score threshold, no
    pair of kept same-class proposals within 1e-4 of its IoU threshold:
    the two packages then keep the same set."""
    scores = torch.cat([torch.sigmoid(p["hm"]).amax(-1).flatten()
                        for p in out])
    assert (scores - test_cfg["score_threshold"]).abs().min() > 1e-4
    th = test_cfg["nms"]["nms_iou_threshold"]
    if isinstance(th, (list, tuple)):  # per class, grouped per task
        th = [t for task in th for t in task]
    for k in range(int(first["label_preds"].max()) + 1):
        cls = first["mask"][0] & (first["label_preds"][0] == k)
        if int(cls.sum()) > 1:
            b = to_pcdet_bev(first["box3d_lidar"][0][cls])
            iou = rotated_iou_bev(b, b)
            off = ~torch.eye(len(b), dtype=torch.bool)
            t = th[k] if isinstance(th, list) else th
            assert (iou[off] - t).abs().min() > 1e-4


def test_voxelnet_matches_jax():
    """`VoxelNet` is `PillarNet` (registered alias) and serves
    `voxelnet18_demo` as the JAX package does."""
    cfg = load_config(os.path.join(DEMO, "voxelnet18_demo.py"))
    pts, msk = _cloud(cfg, 3)
    jm = build_jax_detector(copy.deepcopy(cfg["model"]),
                            test_cfg=cfg["test_cfg"])
    variables = jax.tree_util.tree_map(np.array, random_variables(
        jm, 17, jnp.asarray(pts), jnp.asarray(msk), train=False))
    port = build_model_from_cfg(cfg, device="cpu")
    assert type(port) is VoxelNet and isinstance(port, PillarNet)
    load_jax_variables(port, variables)
    tpts, tmsk = torch.from_numpy(pts), torch.from_numpy(msk)
    for (k, h), (scale, bias) in spread_head_outputs(port, tpts,
                                                     tmsk).items():
        p = variables["params"]["head_net"][f"task{k}"][f"{h}_out"]
        p["kernel"] *= scale
        p["bias"][:] = bias
    tcfg = port.processed_test_cfg()

    def jfwd(v, p, m):
        preds = jm.apply(v, p, m, train=False)
        return preds, jm.predict({}, preds, tcfg)

    jpreds, jdet = jax.jit(jfwd)(variables, jnp.asarray(pts),
                                 jnp.asarray(msk))
    with torch.inference_mode():
        preds = port(tpts, tmsk)
    det = make_infer_fn(port)(tpts, tmsk)
    for p, q in zip(preds, jpreds):
        for h in p:
            np.testing.assert_allclose(p[h].numpy(), np.asarray(q[h]),
                                       err_msg=h, **TOL)
    first = {k: v for k, v in det.items()}
    _guards(port, preds, first, tcfg)
    np.testing.assert_array_equal(det["mask"].numpy(), np.asarray(jdet["mask"]))
    m = det["mask"].numpy()
    assert m.sum() > 10
    np.testing.assert_array_equal(det["label_preds"].numpy()[m],
                                  np.asarray(jdet["label_preds"])[m])
    np.testing.assert_allclose(det["box3d_lidar"].numpy()[m],
                               np.asarray(jdet["box3d_lidar"])[m], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(det["scores"].numpy()[m],
                               np.asarray(jdet["scores"])[m], rtol=0,
                               atol=1e-5)


def twostage_cfg(num_point):
    """`twostage18_demo`, at num_point 5 as written or 1 (the extractor's
    and the RoI head's widths follow)."""
    cfg = load_config(os.path.join(DEMO, "twostage18_demo.py"))
    if num_point == 1:
        model = cfg["model"]
        model["num_point"] = 1
        model["second_stage_modules"][0]["num_point"] = 1
        model["roi_head"]["input_channels"] = 64
    return cfg


@pytest.mark.parametrize("num_point", [5, 1])
def test_two_stage_detector_eval_matches_jax(num_point):
    cfg = twostage_cfg(num_point)
    pts, msk = _cloud(cfg, 3)
    jm = build_jax_detector(copy.deepcopy(cfg["model"]),
                            test_cfg=cfg["test_cfg"])
    variables = jax.tree_util.tree_map(np.array, random_variables(
        jm, 19, jnp.asarray(pts), jnp.asarray(msk), train=False))
    assert sorted(variables["params"]) == ["roi_head_net", "single_det"]
    port = build_model_from_cfg(cfg, device="cpu")
    assert type(port) is TwoStageDetector and port.point_head_net is None
    tpts, tmsk = torch.from_numpy(pts), torch.from_numpy(msk)
    spread_rcnn_heads(port, variables, tpts, tmsk)

    jout = jax.jit(lambda v, p, m: jm.apply(v, p, m, train=False))(
        variables, jnp.asarray(pts), jnp.asarray(msk))
    jdet = {k: np.asarray(v) for k, v in jax.jit(jm.post_process)(jout)
            .items()}
    with torch.inference_mode():
        out = port(tpts, tmsk)
    det = {k: v.numpy() for k, v in port.post_process(out).items()}
    via_infer = make_infer_fn(port)(tpts, tmsk)
    for k in det:
        np.testing.assert_array_equal(via_infer[k].numpy(), det[k])
    first, *_ = port.first_stage(tpts, tmsk)
    _guards(port, out["one_stage_preds"], first, port.processed_test_cfg())
    assert out["point_coords"] is None

    np.testing.assert_array_equal(out["roi_labels"].numpy(),
                                  np.asarray(jout["roi_labels"]))
    assert len(set(np.unique(out["roi_labels"].numpy()).tolist())) >= 3
    np.testing.assert_allclose(out["roi_scores"].numpy(),
                               np.asarray(jout["roi_scores"]), rtol=0,
                               atol=1e-5)
    assert det["box3d_lidar"].shape == (1, 64, 7)
    np.testing.assert_array_equal(det["mask"], jdet["mask"])
    m = det["mask"]
    assert m.sum() > 5
    np.testing.assert_array_equal(det["label_preds"], jdet["label_preds"])
    np.testing.assert_allclose(det["box3d_lidar"][m], jdet["box3d_lidar"][m],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(det["scores"][m], jdet["scores"][m], rtol=0,
                               atol=1e-5)


def test_two_stage_detector_raises_where_jax_raises():
    cfg = twostage_cfg(5)
    model = dict(cfg["model"], use_final_feature=True)
    with pytest.raises(NotImplementedError, match="use_final_feature"):
        build_model_from_cfg(dict(cfg, model=model), device="cpu")
    rcnn = load_config(os.path.join(DEMO, "pillarrcnn18_demo.py"))
    model = dict(cfg["model"], point_head=rcnn["model"]["point_head"])
    with pytest.raises(NotImplementedError, match="point_head"):
        build_model_from_cfg(dict(cfg, model=model), device="cpu")


# ---- circular NMS ----------------------------------------------------------


@pytest.mark.parametrize("radius", [0.175, 1.0, 4.0])
def test_circle_nms_keep_sets_equal_jax(radius):
    rng = np.random.RandomState(int(radius * 100))
    K, post = 256, 64
    centers = rng.uniform(-10, 10, (3, K, 2)).astype(np.float32)
    valid = rng.rand(3, K) > 0.2
    d2 = ((centers[:, :, None] - centers[:, None]) ** 2).sum(-1)
    assert np.abs(d2 - np.float32(radius)).min() > 1e-5
    got_idx, got_mask = circle_nms(torch.from_numpy(centers),
                                   torch.from_numpy(valid), radius, post)
    for r in range(3):
        want_idx, want_mask = jax.jit(
            lambda c, v: jcircle_nms(c, v, radius, post))(centers[r],
                                                          valid[r])
        np.testing.assert_array_equal(got_mask[r].numpy(),
                                      np.asarray(want_mask))
        m = got_mask[r].numpy()
        np.testing.assert_array_equal(got_idx[r].numpy()[m],
                                      np.asarray(want_idx)[m])
    kept = centers[0][got_idx[0].numpy()[got_mask[0].numpy()]]
    dk = ((kept[:, None] - kept[None]) ** 2).sum(-1)
    np.fill_diagonal(dk, np.inf)
    assert dk.min() > radius and got_mask.sum() > 10


def _circle_preds(seed, B, tasks, H=16, W=16):
    rng = np.random.RandomState(seed)
    return [{
        "hm": rng.randn(B, H, W, len(t["class_names"])).astype(np.float32),
        "reg": rng.rand(B, H, W, 2).astype(np.float32),
        "height": rng.randn(B, H, W, 1).astype(np.float32),
        "dim": rng.randn(B, H, W, 3).astype(np.float32) * 0.1,
        "rot": rng.randn(B, H, W, 2).astype(np.float32),
    } for t in tasks]


@pytest.mark.parametrize("case", ["one_task", "grouped", "per_task"])
def test_circular_nms_predict_matches_jax(case):
    """The predict path of `tests/test_circular_nms_predict.py`, and with
    tasks: two of equal settings (batched as one group) and two with their
    own pre / post sizes and radii (per-task routing)."""
    tasks = [dict(stride=8, class_names=["car"])]
    nms = dict(nms_pre_max_size=32, nms_post_max_size=8)
    radius = [4.0]
    if case != "one_task":
        tasks = tasks + [dict(stride=8, class_names=["ped", "cyc"])]
        radius = [4.0, 4.0]
    if case == "per_task":
        nms = dict(nms_pre_max_size=[64, 32], nms_post_max_size=[16, 8])
        radius = [4.0, 0.175]
    test_cfg = dict(circular_nms=True, min_radius=radius, nms=nms,
                    score_threshold=0.1,
                    post_center_limit_range=[-20, -20, -10, 20, 20, 10])
    kw = dict(tasks=tasks, pillar_size=0.25,
              point_cloud_range=[-16, -16, -5, 16, 16, 3])
    jmath = JCenterHeadMath(code_weights=[1.0] * 10, reg_iou=None,
                            common_heads={"reg": (2, 2), "height": (1, 2),
                                          "dim": (3, 2), "rot": (2, 2)},
                            **kw)
    tmath = CenterHeadMath(**kw)
    preds = _circle_preds(7, 2, tasks)
    want = jax.jit(lambda p: jmath.predict({}, p, test_cfg))(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in preds])
    got = tmath.predict({}, [{k: torch.from_numpy(v) for k, v in p.items()}
                             for p in preds], test_cfg)
    post = sum(nms["nms_post_max_size"]) if case == "per_task" \
        else nms["nms_post_max_size"] * len(tasks)
    assert got["box3d_lidar"].shape == (2, post, 7)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    m = got["mask"].numpy()
    assert m.sum() > 4
    np.testing.assert_array_equal(got["label_preds"].numpy()[m],
                                  np.asarray(want["label_preds"])[m])
    np.testing.assert_allclose(got["box3d_lidar"].numpy()[m],
                               np.asarray(want["box3d_lidar"])[m], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-6)
    # kept detections of a task are farther apart than its radius
    offsets = np.cumsum([0] + ([nms["nms_post_max_size"]] * len(tasks)
                               if case != "per_task"
                               else nms["nms_post_max_size"]))
    for t in range(len(tasks)):
        for b in range(2):
            sl = slice(offsets[t], offsets[t + 1])
            pts = got["box3d_lidar"][b, sl][got["mask"][b, sl]][:, :2]
            d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1).numpy()
            np.fill_diagonal(d2, np.inf)
            assert d2.min() > radius[t]


# ---- the config zoo and no JAX -------------------------------------------------


def test_legacy_and_circular_paths_run_without_importing_jax():
    code = (
        "import sys, torch\n"
        "from pillarnet_lts_torch.apis import build_model_from_cfg, "
        "load_config, spread_head_outputs\n"
        "from pillarnet_lts_torch.eval_utils import make_infer_fn\n"
        "from pillarnet_lts_torch.datasets import synth_points_realistic\n"
        "from pillarnet_lts_torch.runtime.quantize import calibrate, "
        "enable_backbone_quant\n"
        "def serve(name, edit=None, int8=False):\n"
        "    cfg = load_config(f'configs/demo/{name}.py')\n"
        "    if edit: edit(cfg)\n"
        "    if int8: enable_backbone_quant(cfg['model'])\n"
        "    m = build_model_from_cfg(cfg, device='cpu')\n"
        "    p, k = (torch.from_numpy(a) for a in synth_points_realistic(\n"
        "        1, 2048, cfg['point_cloud_range'], seed=1, nsweeps=1))\n"
        "    spread_head_outputs(m, p, k)\n"
        "    if int8: calibrate(m, [(p, k)])\n"
        "    det = make_infer_fn(m)(p, k)\n"
        "    assert bool(det['mask'].any()), name\n"
        "def circular(cfg):\n"
        "    cfg['test_cfg'].update(circular_nms=True, min_radius=[4.0, 0.175])\n"
        "def bf16(cfg):\n"
        "    cfg['model']['dtype'] = 'bfloat16'\n"
        "serve('twostage18_demo')\n"
        "serve('pillarnet18_demo', circular)\n"
        "serve('pillarrcnn18_demo', int8=True)\n"
        "serve('pillarrcnn18_demo', bf16)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'pillarnet_lts_tpu' not in sys.modules\n"
        "print('no-jax ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "no-jax ok" in res.stdout
