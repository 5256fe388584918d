"""PyTorch port, two-stage Pillar R-CNN serving: the RPNG necks, the BEV
RoI-grid pooling, the RoI and point heads, the box decoding and the whole
`pillarrcnn18_demo` eval, against the JAX package on the same numpy inputs
and weights (`runtime/convert.py::load_jax_variables`).

Tolerances:
- modules with convolutions or matmuls (necks, `BEVStrideFeature`, the
  heads): rtol = atol = 1e-4 (f32 sums in different orders in XLA and
  ATen), as `test_torch_port_modules.py`;
- the RoI grid against jitted JAX: not bit-equal. XLA contracts the
  grid's multiply-adds into FMAs and its CPU sin/cos differ from torch's
  by an ulp on ~5% of angles, so a point may differ by one ulp of the
  largest operand (7.6e-6 m below 128 m; 3% of the coordinates differ);
  with JAX compiled without fusion and at angles where the two sin/cos
  agree, bit-equal. The cell coordinates (the division by
  out_stride * pillar_size = 0.4 m) from the same points are bit-equal to
  jitted JAX: both multiply by the f32 reciprocal;
- bilinear interpolation: bit-equal to JAX compiled without fusion (the
  same products and sums in the same order), within 1e-6 of jitted JAX;
- box decoding on the same inputs: class scores equal, boxes within
  1e-5 m (centres up to 75 m, where an ulp is 7.6e-6; sin/cos of the RoI
  yaw); post_process: mask, labels and boxes equal, scores within 1e-7;
- the whole demo eval: RoI set (labels) and the final mask equal, RoI
  scores within 1e-5, final labels equal, boxes within 1e-4 m and scores
  within 1e-5, after the score-threshold and IoU-threshold margins of the
  single-stage slice tests are asserted (random weights).
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
from pillarnet_lts_tpu.models.necks.rpn import RPNG as JRPNG
from pillarnet_lts_tpu.models.necks.rpn import RPNGV2 as JRPNGV2
from pillarnet_lts_tpu.models.point_heads.point_head import (
    PointHead as JPointHead,
)
from pillarnet_lts_tpu.models.roi_heads import roi_head_template as jtpl
from pillarnet_lts_tpu.models.roi_heads.roi_heads import RoIHead as JRoIHead
from pillarnet_lts_tpu.models.roi_heads.roi_heads import (
    RoIMIXHead as JRoIMIXHead,
)
from pillarnet_lts_tpu.models.second_stage.bev_feature import (
    BEVStrideFeature as JBEVStrideFeature,
)
from pillarnet_lts_tpu.models.second_stage.bev_feature import (
    roi_grid_points as jroi_grid_points,
)
from pillarnet_lts_tpu.ops.bilinear import (
    bilinear_interpolate as jbilinear_interpolate,
)
from pillarnet_lts_torch.apis import (
    build_model_from_cfg,
    load_config,
    spread_head_outputs,
)
from pillarnet_lts_torch.eval_utils import make_infer_fn
from pillarnet_lts_torch.models.detectors.pillar_rcnn import PillarRCNN
from pillarnet_lts_torch.models.necks.rpn import RPNG, RPNGV2
from pillarnet_lts_torch.models.point_heads import PointHead
from pillarnet_lts_torch.models.roi_heads import RoIHead, RoIMIXHead
from pillarnet_lts_torch.models.roi_heads import roi_head_template as tpl
from pillarnet_lts_torch.models.second_stage import (
    BEVStrideFeature,
    bev_cells,
    roi_grid_points,
)
from pillarnet_lts_torch.ops.bilinear import bilinear_interpolate
from pillarnet_lts_torch.ops.iou3d import rotated_iou_bev, to_pcdet_bev
from pillarnet_lts_torch.runtime.convert import load_jax_variables
from pillarnet_lts_torch.runtime.serving import ServingPipeline
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_torch_port_int8 import jit_nofma
from test_torch_port_modules import (
    TOL,
    jit_apply,
    nhwc,
    random_variables,
    sparse_grid,
)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DEMO = os.path.join(ROOT, "configs", "demo", "pillarrcnn18_demo.py")
FPN = ["pillarnet18_fpn_waymo", "pillarnet34_fpn_waymo",
       "pillarnet18_fpn_iou_waymo"]
PC_RANGE = [-6.4, -6.4, -2.0, 6.4, 6.4, 4.0]
PILLAR = 0.4  # 32 x 32 grid; out_stride 4 -> 1.6 m cells (1 / 1.6 inexact)
HEAD_CFG = dict(
    CLASS_AGNOSTIC=True, SHARED_FC=[32, 24], CLS_FC=[24, 16],
    REG_FC=[16], DP_RATIO=0.3)


def random_rois(seed, B, R, extent=6.4, yaw=4.0):
    rng = np.random.RandomState(seed)
    rois = np.zeros((B, R, 7), np.float32)
    rois[..., :2] = rng.uniform(-extent, extent, (B, R, 2))
    rois[..., 2] = rng.uniform(-2, 2, (B, R))
    rois[..., 3:6] = rng.uniform(0.3, 6.0, (B, R, 3))
    rois[..., 6] = rng.uniform(-yaw, yaw, (B, R))
    return rois


# ---- necks ---------------------------------------------------------------


@pytest.mark.parametrize("neck", ["RPNG", "RPNGV2"])
def test_rpng_matches_flax(neck):
    rng = np.random.RandomState(21)
    B = 2
    shapes = {"conv3": (B, 16, 16, 24), "conv4": (B, 8, 8, 40),
              "conv5": (B, 4, 4, 40)}
    feats = {k: np.abs(rng.randn(*s)).astype(np.float32)
             for k, s in shapes.items()}
    kw = dict(layer_nums=[1, 2], num_filters=[32, 16], in_channels=[48, 24, 8])
    jm = (JRPNG if neck == "RPNG" else JRPNGV2)(**kw)
    jfeats = {k: (jnp.asarray(v), None) for k, v in feats.items()}
    variables = random_variables(jm, 22, jfeats, train=False)
    want = jit_apply(jm, variables, jfeats)

    tcls = RPNG if neck == "RPNG" else RPNGV2
    tm = load_jax_variables(
        tcls(**kw, backbone_channels={k: s[-1] for k, s in shapes.items()})
        .eval(), variables)
    assert tm.out_channels == (32, 16)
    tfeats = {k: (torch.from_numpy(v).permute(0, 3, 1, 2), None)
              for k, v in feats.items()}
    with torch.inference_mode():
        got = tm(tfeats)
    assert len(got) == len(want) == 2
    assert tuple(got[0].shape) == (B, 32, 8, 8)
    assert tuple(got[1].shape) == (B, 16, 16, 16)
    for g, w, name in zip(got, want, ("x4b", "x3b")):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), err_msg=name,
                                   **TOL)


# ---- RoI grid and bilinear pooling ---------------------------------------


def test_roi_grid_points_match_jax():
    rois = random_rois(23, 2, 3000, extent=75.0)
    want = np.asarray(jax.jit(lambda r: jroi_grid_points(r, 7))(rois))
    got = roi_grid_points(torch.from_numpy(rois), 7).numpy()
    assert got.shape == want.shape == (2, 3000, 49, 2)
    # jitted: within one ulp of the largest operand (centres and grid
    # points below 128 m: 7.6e-6 m), from FMA contraction and sin/cos
    assert np.abs(got - want).max() <= np.spacing(np.float32(80.0))
    # unfused, where the two libraries' sin and cos agree: bit-equal
    a = rois[..., 6]
    same = ((np.asarray(jax.jit(jnp.cos)(a))
             == torch.cos(torch.from_numpy(a)).numpy())
            & (np.asarray(jax.jit(jnp.sin)(a))
               == torch.sin(torch.from_numpy(a)).numpy()))
    assert same.mean() > 0.5
    unfused = np.asarray(jit_nofma(lambda r: jroi_grid_points(r, 7),
                                   jnp.asarray(rois)))
    np.testing.assert_array_equal(got[same], unfused[same])
    # the grid order: (x_idx, y_idx) pairs, row-major over x_idx
    box = np.zeros((1, 1, 7), np.float32)
    box[..., 3:5] = (7.0, 14.0)
    g = roi_grid_points(torch.from_numpy(box), 7)[0, 0].numpy()
    np.testing.assert_allclose(g[:2], [[-3.0, -6.0], [-3.0, -4.0]],
                               atol=1e-6)
    np.testing.assert_allclose(g[7], [-2.0, -6.0], atol=1e-6)


def test_cell_coordinates_bit_equal_to_jax():
    """The division by out_stride * pillar_size (0.4 m) on the same grid
    points: a multiply by its f32 reciprocal on both sides."""
    pts = np.array(jax.jit(lambda r: jroi_grid_points(r, 7))(
        random_rois(24, 2, 2000, extent=75.0)))
    pc = (-75.2, -75.2)

    def jcells(p):
        return ((p[..., 0] - pc[0]) / (4 * 0.1),
                (p[..., 1] - pc[1]) / (4 * 0.1))

    want = jax.jit(jcells)(pts)
    got = bev_cells(torch.from_numpy(pts), pc,
                    float(np.float32(1) / np.float32(0.4)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _bilinear_case(seed):
    rng = np.random.RandomState(seed)
    B, H, W, C = 2, 12, 17, 8
    im = rng.randn(B, H, W, C).astype(np.float32)
    n = 400
    x = rng.uniform(-2.5, W + 1.5, (B, n)).astype(np.float32)
    y = rng.uniform(-2.5, H + 1.5, (B, n)).astype(np.float32)
    # integer edges, the last row and column, and points off the map
    x[:, :40] = rng.randint(-1, W + 1, (B, 40))
    y[:, 20:60] = rng.randint(-1, H + 1, (B, 40))
    x[:, 60:64] = W - 1
    y[:, 64:68] = H - 1
    x[:, 68] = -7.25
    y[:, 69] = H + 5.5
    return im, x, y


def _jax_bilinear(im, x, y):
    return jax.vmap(jbilinear_interpolate)(im, x, y)


def test_bilinear_interpolate_matches_jax():
    im, x, y = _bilinear_case(25)
    got = bilinear_interpolate(torch.from_numpy(im), torch.from_numpy(x),
                               torch.from_numpy(y)).numpy()
    unfused = np.asarray(jit_nofma(_jax_bilinear, jnp.asarray(im),
                                   jnp.asarray(x), jnp.asarray(y)))
    assert got.shape == unfused.shape == (2, 400, 8)
    np.testing.assert_array_equal(got, unfused)
    jitted = np.asarray(jax.jit(_jax_bilinear)(im, x, y))
    np.testing.assert_allclose(got, jitted, rtol=0, atol=1e-6)
    # at an interior integer point the value is the pixel's
    pix = bilinear_interpolate(torch.from_numpy(im),
                               torch.tensor([[3.0]] * 2),
                               torch.tensor([[5.0]] * 2)).numpy()
    np.testing.assert_array_equal(pix[:, 0], im[:, 5, 3])


_BEV_VARIANTS = {
    # out_stride, feature_sources: the config's 1x1 paths; the strided
    # down-paths (k = 4, 2) with max-pooled masks; the transposed-conv
    # up-paths (k = 2, 4); the stride-1 map
    "config": (4, ["conv3"]),
    "down": (4, ["conv1", "conv2", "conv3", "conv5"]),
    "up": (2, ["conv2", "conv3", "conv4"]),
    "stride1": (1, ["conv1"]),
}


@pytest.mark.parametrize("variant", sorted(_BEV_VARIANTS))
def test_bev_stride_feature_matches_flax(variant):
    out_stride, sources = _BEV_VARIANTS[variant]
    B, R, n = 2, 24, 32
    chans = {"conv1": 8, "conv2": 12, "conv3": 16, "conv4": 20}
    strides = {"conv1": 1, "conv2": 2, "conv3": 4, "conv4": 8, "conv5": 16}
    feats = {}
    for i, (k, c) in enumerate(chans.items()):
        s = n // strides[k]
        grid, occ = sparse_grid(30 + i, B, s, s, c, occupancy=0.4)
        feats[k] = (grid, occ)
    rng = np.random.RandomState(26)
    bev = rng.randn(B, n // 4, n // 4, 24).astype(np.float32)
    rois = random_rois(27, B, R, extent=7.5)
    kw = dict(feature_sources=sources, pillar_size=PILLAR, pc_range=PC_RANGE,
              out_stride=out_stride, grid_size=7, in_channels=24,
              share_channels=16, backbone_channels=chans,
              backbone_strides=strides)
    jm = JBEVStrideFeature(**kw)
    jfeats = {k: (jnp.asarray(g), jnp.asarray(m)) for k, (g, m) in
              feats.items()}
    args = (jnp.asarray(bev), jfeats, jnp.asarray(rois))
    variables = random_variables(jm, 28, *args, train=False)
    want = jit_apply(jm, variables, *args)

    tm = load_jax_variables(BEVStrideFeature(**kw).eval(), variables)
    tfeats = {k: (torch.from_numpy(g).permute(0, 3, 1, 2),
                  torch.from_numpy(m)) for k, (g, m) in feats.items()}
    with torch.inference_mode():
        got = tm(torch.from_numpy(bev).permute(0, 3, 1, 2), tfeats,
                 torch.from_numpy(rois))
    assert tuple(got[0].shape) == (B, R, 49 * 16)
    assert tuple(got[1].shape) == (B, R, 49, 16)
    for g, w, name in zip(got, want, ("roi", "point", "coords")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    assert np.abs(got[1].numpy()).max() > 0.1


# ---- heads ------------------------------------------------------------------


@pytest.mark.parametrize("head,add_box", [
    ("RoIMIXHead", False), ("RoIMIXHead", True), ("RoIHead", False)])
def test_roi_head_matches_flax(head, add_box):
    B, R, C = 2, 40, 8
    rng = np.random.RandomState(31)
    feats = np.abs(rng.randn(B, R, 49 * C)).astype(np.float32)
    rois = random_rois(32, B, R)
    scores = rng.rand(B, R).astype(np.float32)
    if head == "RoIMIXHead":
        kw = dict(in_channels=C, model_cfg=HEAD_CFG, mixer_type="",
                  num_patches=49, code_size=7, add_box_param=add_box)
        jm, tcls = JRoIMIXHead(**kw), RoIMIXHead
    else:
        kw = dict(input_channels=49 * C, model_cfg=HEAD_CFG, code_size=7)
        jm, tcls = JRoIHead(**kw), RoIHead
    args = (jnp.asarray(feats), jnp.asarray(rois), jnp.asarray(scores))
    variables = random_variables(jm, 33, *args, train=False)
    want = jit_apply(jm, variables, *args)

    tm = load_jax_variables(tcls(**kw).eval(), variables)
    with torch.inference_mode():
        got = tm(torch.from_numpy(feats), torch.from_numpy(rois),
                 torch.from_numpy(scores))
    assert tuple(got[0].shape) == (B * R, 1)
    assert tuple(got[1].shape) == (B * R, 7)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # dropout only in training mode: eval calls are identical
    with torch.inference_mode():
        again = tm(torch.from_numpy(feats), torch.from_numpy(rois),
                   torch.from_numpy(scores))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_roi_mix_head_mixer_raises():
    """Only an unknown mixer raises; "MLPMixer" and "ResMLP" build their
    mixer, which `tests/test_torch_port_rcnn_heads.py` holds against
    flax, and the head over its tokens matches flax here too."""
    with pytest.raises(ValueError, match="mixer_type"):
        RoIMIXHead(8, HEAD_CFG, mixer_type="gMLP")
    B, R, C = 2, 10, 8
    rng = np.random.RandomState(36)
    feats = np.abs(rng.randn(B, R, 49 * C)).astype(np.float32)
    kw = dict(in_channels=C, model_cfg=HEAD_CFG, mixer_type="MLPMixer",
              num_patches=49, code_size=7)
    jm = JRoIMIXHead(**kw)
    variables = random_variables(jm, 37, jnp.asarray(feats), train=False)
    want = jit_apply(jm, variables, jnp.asarray(feats))
    tm = load_jax_variables(RoIMIXHead(**kw).eval(), variables)
    assert type(tm.mixer).__name__ == "MLPMixer"
    with torch.inference_mode():
        got = tm(torch.from_numpy(feats))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_point_head_matches_flax():
    rng = np.random.RandomState(34)
    x = np.abs(rng.randn(2, 30, 49, 16)).astype(np.float32)
    kw = dict(in_channels=16, num_class=1,
              model_cfg=dict(CLASS_AGNOSTIC=True, CLS_FC=[24, 20]))
    jm = JPointHead(**kw)
    variables = random_variables(jm, 35, jnp.asarray(x), train=False)
    want = jit_apply(jm, variables, jnp.asarray(x))
    tm = load_jax_variables(PointHead(**kw).eval(), variables)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 30, 49, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_generate_predicted_boxes_matches_jax():
    B, N = 2, 300
    rois = random_rois(36, B, N, extent=75.0)
    rng = np.random.RandomState(37)
    cls = rng.randn(B * N, 1).astype(np.float32)
    reg = (rng.randn(B * N, 7) * 0.3).astype(np.float32)
    want = jax.jit(jtpl.generate_predicted_boxes)(rois, cls, reg)
    got = tpl.generate_predicted_boxes(torch.from_numpy(rois),
                                       torch.from_numpy(cls),
                                       torch.from_numpy(reg))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-5)
    # a zero residual gives the RoI back
    _, same = tpl.generate_predicted_boxes(
        torch.from_numpy(rois), torch.from_numpy(cls),
        torch.zeros(B * N, 7))
    np.testing.assert_allclose(same.numpy(), rois, rtol=0, atol=1e-5)
    v = np.linspace(-10, 10, 101).astype(np.float32)
    np.testing.assert_allclose(
        tpl.limit_period(torch.from_numpy(v), 0.5, 2 * np.pi).numpy(),
        np.asarray(jtpl.limit_period(v, 0.5, 2 * np.pi)), atol=1e-6)


def test_post_process_matches_jax():
    jm = build_jax_detector(copy.deepcopy(load_config(DEMO)["model"]))
    B, N = 2, 64
    rng = np.random.RandomState(38)
    valid = rng.rand(B, N) > 0.3
    boxes = random_rois(39, B, N) * valid[..., None]
    boxes[0, :5, 4] = -0.5  # a refined box with a negative dimension
    out = {"batch_box_preds": boxes,
           "batch_cls_preds": rng.randn(B, N, 1).astype(np.float32),
           "roi_labels": (rng.randint(0, 3, (B, N)) + 1) * valid,
           "roi_scores": (rng.rand(B, N) * valid).astype(np.float32)}
    out["roi_labels"] = out["roi_labels"].astype(np.int32)
    want = jax.jit(jm.post_process)(out)
    got = PillarRCNN.post_process({k: torch.from_numpy(v)
                                   for k, v in out.items()})
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    assert 0 < got["mask"].sum() < valid.sum()
    np.testing.assert_array_equal(got["label_preds"].numpy(),
                                  np.asarray(want["label_preds"]))
    np.testing.assert_array_equal(got["box3d_lidar"].numpy(),
                                  np.asarray(want["box3d_lidar"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-7)


# ---- the detector -----------------------------------------------------------


def spread_rcnn_heads(port, variables, pts, msk):
    """`spread_both_heads` for a two-stage model: load, spread the first
    stage's head projections and give the numpy tree the same change."""
    load_jax_variables(port, variables)
    head = variables["params"]["single_det"]["head_net"]
    for (k, h), (scale, bias) in spread_head_outputs(port, pts, msk).items():
        p = head[f"task{k}"][f"{h}_out"]
        p["kernel"] *= scale
        p["bias"][:] = bias


def test_demo_two_stage_eval_matches_jax():
    from __graft_entry__ import _synth_points_realistic

    cfg = load_config(DEMO)
    pts, msk = _synth_points_realistic(1, 4096, cfg["point_cloud_range"],
                                       seed=3, nsweeps=1)
    jm = build_jax_detector(copy.deepcopy(cfg["model"]),
                            test_cfg=cfg["test_cfg"])
    variables = random_variables(jm, 13, jnp.asarray(pts), jnp.asarray(msk),
                                 train=False)
    variables = jax.tree_util.tree_map(np.array, variables)
    port = build_model_from_cfg(cfg, device="cpu")
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

    # guards: no first-stage candidate on the score threshold, no pair of
    # kept same-class proposals with its IoU on that class's threshold
    test_cfg = port.processed_test_cfg()
    scores = torch.cat([torch.sigmoid(p["hm"]).amax(-1).flatten()
                        for p in out["one_stage_preds"]])
    assert (scores - test_cfg["score_threshold"]).abs().min() > 1e-4
    first, *_ = port.first_stage(tpts, tmsk)
    threshs = sum(test_cfg["nms"]["nms_iou_threshold"], [])
    for k, th in enumerate(threshs):
        cls = first["mask"][0] & (first["label_preds"][0] == k)
        if int(cls.sum()) > 1:
            b = to_pcdet_bev(first["box3d_lidar"][0][cls])
            iou = rotated_iou_bev(b, b)
            off = ~torch.eye(len(b), dtype=torch.bool)
            assert (iou[off] - th).abs().min() > 1e-4

    # the RoI set: labels equal (0 = padded slot), scores, grid points
    np.testing.assert_array_equal(out["roi_labels"].numpy(),
                                  np.asarray(jout["roi_labels"]))
    labels = set(np.unique(out["roi_labels"].numpy()).tolist())
    assert labels <= {0, 1, 2, 3} and len(labels) >= 3
    np.testing.assert_allclose(out["roi_scores"].numpy(),
                               np.asarray(jout["roi_scores"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(out["point_coords"].numpy(),
                               np.asarray(jout["point_coords"]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out["point_logits"].numpy(),
                               np.asarray(jout["point_logits"]), **TOL)

    assert det["box3d_lidar"].shape == (1, 128, 7)
    np.testing.assert_array_equal(det["mask"], jdet["mask"])
    m = det["mask"]
    assert m.sum() > 20
    np.testing.assert_array_equal(det["label_preds"], jdet["label_preds"])
    np.testing.assert_allclose(det["box3d_lidar"][m], jdet["box3d_lidar"][m],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(det["scores"][m], jdet["scores"][m], rtol=0,
                               atol=1e-5)


def _load_full_width(path):
    cfg = load_config(path)
    jm = build_jax_detector(copy.deepcopy(cfg["model"]),
                            test_cfg=cfg["test_cfg"])
    pts = jnp.zeros((1, 64, 5), jnp.float32)
    variables = random_variables(jm, 1, pts, jnp.ones((1, 64), bool),
                                 train=False)
    variables = jax.tree_util.tree_map(np.array, variables)
    port = build_model_from_cfg(cfg, device="cpu")
    return port, variables, load_jax_variables(port, variables)


@pytest.mark.parametrize("name", ["pillarrcnn/pillarrcnn18_waymo",
                                  "pillarrcnn/pillarrcnn18_waymo_bf16"]
                         + ["pillarnet/" + n for n in FPN])
def test_load_jax_variables_full_width(name):
    """The flax tree of the full-width config (abstract init: shapes only)
    loads strictly: every leaf used once, every tensor filled."""
    port, variables, _ = _load_full_width(
        os.path.join(ROOT, "configs", name + ".py"))
    if "pillarrcnn" in name:
        assert sorted(variables["params"]) == [
            "point_head_net", "roi_head_net", "second_stage_0", "single_det"]
        k = variables["params"]["roi_head_net"]["shared_fc"]["fc0"]["kernel"]
        assert k.shape == (49 * 64, 256)
        np.testing.assert_array_equal(
            port.roi_head_net.shared_fc.fc0.weight.detach().numpy(), k.T)
        ss = port.second_stage_0
        assert tuple(ss.top_down_conv.weight.shape) == (128, 128, 1, 1)
        assert tuple(ss.fusion_conv.weight.shape) == (64, 256, 3, 3)
        assert port.single_det.neck_net.out_channels == (256, 128)
    else:
        assert port.neck_net.out_channels == (256, 128)


@pytest.mark.parametrize("name", FPN)
def test_fpn_waymo_config_serves_on_cpu(name):
    """Each RPNG single-stage Waymo config, as written but cut to a 128^2
    grid and narrow widths, serves a request: the stride-8 vehicle task
    reads the neck's first map, the stride-4 pedestrian/cyclist task the
    second, and each decodes at its own stride."""
    from __graft_entry__ import _synth_points_realistic

    cfg = load_config(os.path.join(ROOT, "configs", "pillarnet",
                                   name + ".py"))
    pc = cfg["point_cloud_range"]
    pillar = (pc[3] - pc[0]) / 128
    model = cfg["model"]
    model["reader"].update(num_filters=(8,), pillar_size=pillar)
    model["backbone"]["in_channels"] = 8
    model["neck"].update(layer_nums=[1, 1], num_filters=[32, 16],
                         in_channels=[32, 32, 16])
    model["bbox_head"].update(pillar_size=pillar, in_channels=[32, 16])
    net = build_model_from_cfg(cfg, device="cpu", seed=2)
    pts, msk = _synth_points_realistic(1, 4096, pc, seed=3, nsweeps=1)
    pts, msk = torch.from_numpy(pts), torch.from_numpy(msk)
    spread_head_outputs(net, pts, msk)
    with torch.inference_mode():
        preds = net(pts, msk)
    assert tuple(preds[0]["hm"].shape) == (1, 16, 16, 1)
    assert tuple(preds[1]["hm"].shape) == (1, 32, 32, 2)
    det = make_infer_fn(net)(pts, msk)
    posts = cfg["test_cfg"]["nms"]["nms_post_max_size"]
    assert det["box3d_lidar"].shape == (1, sum(posts), 7)
    m = det["mask"][0]
    starts = np.cumsum([0] + posts)
    for k in range(3):
        lo, hi = starts[k], starts[k + 1]
        assert bool(m[lo:hi].any())
        assert bool((det["label_preds"][0, lo:hi][m[lo:hi]] == k).all())
    # centres within the range of their own task's decode
    assert float(det["box3d_lidar"][0][m][:, :2].abs().max()) < 80.0


def test_two_stage_serves_through_the_pipeline():
    """`make_infer_fn` + `ServingPipeline` serve the demo two-stage model
    unchanged: padded (B, 128) detections, labels in {0, 1, 2}, scores in
    [0, 1], in submission order."""
    from __graft_entry__ import _synth_points_realistic

    cfg = load_config(DEMO)
    port = build_model_from_cfg(cfg, device="cpu", seed=4)
    clouds = [tuple(torch.from_numpy(a) for a in _synth_points_realistic(
        b, 2048, cfg["point_cloud_range"], seed=s, nsweeps=1))
        for s, b in ((5, 1), (6, 2), (7, 1))]
    spread_head_outputs(port, *clouds[0])
    infer = make_infer_fn(port)
    outs = list(ServingPipeline(infer, depth=2).map(clouds))
    for (pts, _), det in zip(clouds, outs):
        B = pts.shape[0]
        assert det["box3d_lidar"].shape == (B, 128, 7)
        m = det["mask"]
        assert m.any() and np.isfinite(det["box3d_lidar"]).all()
        assert ((det["scores"] >= 0) & (det["scores"] <= 1)).all()
        assert set(np.unique(det["label_preds"][m])) <= {0, 1, 2}
        assert (det["box3d_lidar"][m][:, 3:6] > 0).all()
    again = infer(*clouds[1])
    for k in again:
        np.testing.assert_array_equal(again[k].numpy(), outs[1][k])


def test_two_stage_training_raises():
    """Training mode needs the GT and a generator (the RoI sampler's and
    dropout's draws). The bf16 twin trains (its step against the JAX
    package's: `tests/test_torch_port_bf16_train.py`): one step's losses
    are finite and its parameters stay f32. Two-stage training itself:
    `tests/test_torch_port_rcnn_train.py`."""
    port = build_model_from_cfg(load_config(DEMO), device="cpu")
    pts = torch.zeros((1, 64, 5))
    msk = torch.ones((1, 64), dtype=torch.bool)
    port.train()
    with pytest.raises(ValueError, match="gt_boxes_and_cls"):
        port(pts, msk)
    with pytest.raises(ValueError, match="Generator"):
        port(pts, msk, gt_boxes_and_cls=torch.zeros((1, 100, 10)))
    from pillarnet_lts_torch.datasets import SynthDataset, collate_batch
    from pillarnet_lts_torch.runtime.train_step import (batch_to_device,
                                                        step_losses)

    cfg = load_config(DEMO)
    cfg["model"]["dtype"] = "bfloat16"
    model = build_model_from_cfg(cfg, device="cpu", seed=3)
    assert model.dtype == torch.bfloat16
    ds = SynthDataset(cfg, 1, 4096, seed=5)
    batch = batch_to_device(collate_batch([ds[0]], 16384), "cpu")
    total, losses = step_losses(model, batch, cfg["train_cfg"],
                                torch.Generator().manual_seed(0))
    total.backward()
    assert total.dtype == torch.float32 and torch.isfinite(total)
    assert {"roi_cls_loss", "roi_reg_loss", "point_loss"} <= set(losses)
    assert all(p.dtype == torch.float32 and p.grad is not None
               and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


def test_two_stage_runs_without_importing_jax():
    code = (
        "import sys, torch\n"
        "from pillarnet_lts_torch.apis import build_model_from_cfg, "
        "load_config, spread_head_outputs\n"
        "from pillarnet_lts_torch.eval_utils import make_infer_fn\n"
        "from pillarnet_lts_torch.datasets import synth_points_realistic\n"
        "cfg = load_config(sys.argv[1])\n"
        "m = build_model_from_cfg(cfg, device='cpu')\n"
        "p, k = (torch.from_numpy(a) for a in synth_points_realistic(\n"
        "    1, 2048, cfg['point_cloud_range'], seed=1, nsweeps=1))\n"
        "spread_head_outputs(m, p, k)\n"
        "det = make_infer_fn(m)(p, k)\n"
        "assert det['mask'].shape == (1, 128) and bool(det['mask'].any())\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'pillarnet_lts_tpu' not in sys.modules\n"
        "print('no-jax ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code, DEMO], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "no-jax ok" in res.stdout
