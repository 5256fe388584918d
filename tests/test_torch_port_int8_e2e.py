"""PyTorch port, int8 deploy slice end to end: `pillarnet34_nusc_int8`'s
structure at full channel widths (PillarResNet34 32/64/128/256 + conv5,
RPNV1 256, 6-task CenterHead) on a shrunk grid, against the JAX package
with identical weights and identical calibrated scales (the JAX 'quant'
collection carried over by `load_jax_variables`); and the bf16 config.

Tolerances:
- int8 backbone and neck outputs: bit-equal (values), with `s2d_pallas`
  off (per-conv path) and on (the JAX side runs the fused Pallas stage in
  interpret mode, the port its fused-stage op), and with the fused stage
  on an f32 model (case "f32": the JAX fused stage in interpret mode at
  f32, the port's K5 f32 plain version, every int8 conv on K4 f32's plain
  version; the same calibrated scales). The JAX side compiles
  without XLA's fusion pass and draws BN variances with an exact rsqrt
  (see `tests/test_torch_port_int8.py`). The neck's bf16 transposed conv
  sums in f32 and meets its BN unrounded on both sides (`rpn.py`), so the
  int8 block after it sees equal inputs.
- head outputs (bf16 convs, rounded differently by XLA and ATen): within
  2e-2 of each map's max |value|; keep sets as `_check_detections`
  states.
- bf16 config (no int8): every map within 5e-2 of its max |value| (bf16
  rounding compounding over 60 convs).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillarnet_lts_tpu.models import build_detector as build_jax_detector
from pillarnet_lts_torch.models import build_detector
from pillarnet_lts_torch.ops.iou3d import rotated_iou_bev, to_pcdet_bev
from pillarnet_lts_torch.runtime.convert import load_jax_variables
from pillarnet_lts_torch.runtime.quantize import calibrate, observers
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_torch_port_e2e import PC_RANGE, TASKS, spread_both_heads
from test_torch_port_int8 import int8_variables, jit_nofma

N_POINTS = 8192


def shrunk_int8_cfg(grid=32, quant=True):
    """pillarnet34_nusc_int8 at full widths on a grid x grid BEV grid (the
    JAX package's plain layout; `s2d_pallas` off)."""
    pillar = 108.0 / grid
    model = dict(
        type="PillarNet", dtype="bfloat16",
        reader=dict(type="DynamicPFE", in_channels=5, num_filters=(32,),
                    pillar_size=pillar, pc_range=PC_RANGE, quant=quant),
        backbone=dict(type="PillarResNet34", in_channels=32, quant=quant,
                      s2d_stage1=False, hpack=False, chunk_nc=0),
        neck=dict(type="RPNV1", layer_nums=[5, 5], num_filters=256,
                  in_channels=[256, 256], quant=quant),
        bbox_head=dict(
            type="CenterHead", quant=False, tasks=TASKS, in_channels=[256],
            code_weights=[1.0] * 6 + [0.2, 0.2, 1.0, 1.0],
            common_heads={"reg": (2, 2), "height": (1, 2), "dim": (3, 2),
                          "rot": (2, 2), "vel": (2, 2)},
            reg_iou="GIoU", pillar_size=pillar, point_cloud_range=PC_RANGE),
    )
    test_cfg = dict(
        nms=dict(use_rotate_nms=True, nms_pre_max_size=256,
                 nms_post_max_size=32, nms_iou_threshold=0.2),
        rectifier=0, score_threshold=0.1, double_flip=False,
        post_center_limit_range=[-61.2, -61.2, -10.0, 61.2, 61.2, 10.0])
    return model, test_cfg


def _clouds(seeds):
    from __graft_entry__ import _synth_points_realistic

    return [_synth_points_realistic(1, N_POINTS, PC_RANGE, seed=s)
            for s in seeds]


def _jax_forward(jmodel, variables, pts, msk):
    """(backbone feats, neck bev, head preds) of the JAX model, unfused."""
    def fwd(v, p, m):
        def run(mod, p, m):
            bev, feats = mod.extract_feat(p, m, False)
            return feats, bev, mod.head_net(bev, False)
        return jmodel.apply(v, p, m, method=run)

    return jit_nofma(fwd, variables, jnp.asarray(pts), jnp.asarray(msk))


def _port_forward(port, pts, msk):
    with torch.inference_mode():
        feats = port.backbone_net(*port.reader_net(torch.from_numpy(pts),
                                                   torch.from_numpy(msk)))
        bev = port.neck_net(feats)
        preds = port.head_net(bev)
        det = port.predict({}, preds)
    return feats, bev, preds, det


def _nhwc(x):
    return x.permute(0, 2, 3, 1).float().numpy()


def _close_to_scale(got, want, frac, what):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) + 1e-6
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= frac * scale, f"{what}: max |d| {err} > {frac} x {scale}"


def quant_collection(model):
    """The port's calibrated absmax buffers as a JAX 'quant' collection."""
    calibrated = {id(m) for m in observers(model)}
    tree = {}
    for name, m in model.named_modules():
        if id(m) in calibrated:
            node = tree
            for key in name.split("."):
                node = node.setdefault(key, {})
            node[m.absmax_name] = m.absmax().numpy().copy()
    return tree


@pytest.fixture(scope="module")
def calibrated():
    """JAX weights (exact-rsqrt BN), calibrated on two clouds (by the port:
    `tests/test_torch_port_int8.py` holds its calibration to the JAX
    package's) and carried to both frameworks as the JAX 'quant'
    collection; head projections spread on a third cloud (shared by both
    frameworks). Also the JAX predict, jitted once for both tests."""
    mcfg, tcfg = shrunk_int8_cfg()
    pts, msk = _clouds([5])[0]
    jmodel = build_jax_detector(copy.deepcopy(mcfg), test_cfg=tcfg)
    variables = int8_variables(jmodel, 12, jnp.asarray(pts),
                               jnp.asarray(msk), train=False)
    variables.pop("quant", None)
    port = load_jax_variables(build_detector(mcfg, test_cfg=tcfg), variables)
    calibrate(port, [tuple(map(torch.from_numpy, c))
                     for c in _clouds([6, 7])])
    vq = dict(variables, quant=quant_collection(port))
    spread_both_heads(port, vq, torch.from_numpy(pts), torch.from_numpy(msk))
    jpredict = jax.jit(lambda p: jmodel.predict(
        {}, p, jmodel.processed_test_cfg()))
    return mcfg, tcfg, vq, (pts, msk), jpredict


@pytest.mark.parametrize("s2d_pallas", [False, True, "f32"])
def test_int8_slice_matches_jax(calibrated, s2d_pallas):
    """s2d_pallas: the fused stage off or on (bf16), or "f32": on, in an
    f32 model."""
    mcfg, tcfg, vq, (pts, msk), jpredict = calibrated
    mcfg = copy.deepcopy(mcfg)
    dtype = torch.bfloat16
    if s2d_pallas == "f32":
        mcfg["dtype"], dtype, s2d_pallas = "float32", torch.float32, True
        jm = build_jax_detector(copy.deepcopy(mcfg), test_cfg=tcfg)
        jpredict = jax.jit(lambda p: jm.predict({}, p,
                                                jm.processed_test_cfg()))
    jcfg = copy.deepcopy(mcfg)
    jcfg["backbone"].update(s2d_pallas=s2d_pallas, s2d_stage1=s2d_pallas)
    jmodel = build_jax_detector(jcfg, test_cfg=tcfg)
    jfeats, jbev, jpreds = _jax_forward(jmodel, vq, pts, msk)
    jdet = jpredict(jpreds)

    pcfg = copy.deepcopy(mcfg)
    pcfg["backbone"]["s2d_pallas"] = s2d_pallas
    port = load_jax_variables(build_detector(pcfg, test_cfg=tcfg), vq)
    assert (port.backbone_net.fused_stage1_params() is not None) == s2d_pallas
    feats, bev, preds, det = _port_forward(port, pts, msk)

    for k in [f"conv{i}" for i in range(1, 6)]:
        x, m = feats[k]
        assert x.dtype == dtype
        if m is not None:
            np.testing.assert_array_equal(m.numpy(), np.asarray(jfeats[k][1]))
        np.testing.assert_array_equal(
            _nhwc(x), np.asarray(jfeats[k][0], np.float32), err_msg=k)
    np.testing.assert_array_equal(_nhwc(bev[0]),
                                  np.asarray(jbev[0], np.float32))
    for t, (g, w) in enumerate(zip(preds, jpreds)):
        for h in g:
            _close_to_scale(g[h].float().numpy(), w[h], 2e-2, f"task{t}/{h}")
    _check_detections(port, preds, jpreds, jdet, tcfg)


def _check_detections(port, preds, jpreds, jdet, tcfg):
    """Keep sets. (1) The port's predict on the JAX head outputs equals the
    JAX detections (mask, labels; scores 1e-4, boxes 1e-3), after the
    margin check of `test_torch_port_e2e.py` (no score within 1e-4 of the
    threshold, no kept pair's IoU within 1e-4 of the NMS threshold).
    (2) On the port's own bf16 head outputs, scores move by up to ~5e-3
    (bf16 convs), enough to reorder near-equal candidates, so the
    confident detections (score >= 0.3) are compared: same labels both
    ways; centres x, y within 0.5 m (the random-weight offsets reach 2-4,
    where a bf16 ulp is 1/64, times 13.5 m per unit at stride 8 on this
    grid: 0.21 m), the other entries within 0.05 + 2e-2 |value| (dims are
    exp() of a bf16 map)."""
    with torch.inference_mode():
        jp = [{h: torch.from_numpy(np.asarray(v, np.float32))
               for h, v in p.items()} for p in jpreds]
        det = port.predict({}, jp)
    scores = torch.cat([torch.sigmoid(p["hm"]).amax(-1).flatten()
                        for p in jp])
    assert (scores - tcfg["score_threshold"]).abs().min() > 1e-4
    m = det["mask"][0]
    kept = det["box3d_lidar"][0][m]
    assert int(m.sum()) > 0
    iou = rotated_iou_bev(to_pcdet_bev(kept), to_pcdet_bev(kept))
    off_diag = ~torch.eye(len(kept), dtype=torch.bool)
    assert (iou[off_diag] - 0.2).abs().min() > 1e-4
    jd = {k: np.asarray(v) for k, v in jdet.items()}
    np.testing.assert_array_equal(det["mask"].numpy(), jd["mask"])
    mm = jd["mask"]
    np.testing.assert_array_equal(det["label_preds"].numpy()[mm],
                                  jd["label_preds"][mm])
    np.testing.assert_allclose(det["scores"].numpy()[mm], jd["scores"][mm],
                               atol=1e-4)
    np.testing.assert_allclose(det["box3d_lidar"].numpy()[mm],
                               jd["box3d_lidar"][mm], atol=1e-3)

    with torch.inference_mode():
        own = port.predict({}, preds)

    def confident(d):
        d = {k: np.asarray(v)[0] for k, v in d.items()}
        keep = d["mask"].astype(bool) & (d["scores"] >= 0.3)
        order = np.argsort(-d["scores"][keep], kind="stable")
        return {k: d[k][keep][order] for k in ("box3d_lidar", "scores",
                                               "label_preds")}

    a, b = confident({k: v.numpy() for k, v in own.items()}), confident(jd)
    assert len(a["scores"]) == len(b["scores"]) > 0
    for x, y in ((a, b), (b, a)):
        for box, label in zip(x["box3d_lidar"], x["label_preds"]):
            tol = 0.05 + 2e-2 * np.abs(box)
            tol[:2] = 0.5
            d = (np.abs(y["box3d_lidar"] - box) / tol).max(-1)
            j = int(np.argmin(d))
            assert d[j] <= 1 and y["label_preds"][j] == label, (box, d[j])


def test_bf16_config_matches_jax(calibrated):
    """The bf16 config (no int8) with the slice's float weights."""
    variables = {k: v for k, v in calibrated[2].items() if k != "quant"}
    mcfg, tcfg = shrunk_int8_cfg(quant=False)
    pts, msk = _clouds([8])[0]
    jmodel = build_jax_detector(copy.deepcopy(mcfg), test_cfg=tcfg)
    jfeats, jbev, jpreds = _jax_forward(jmodel, variables, pts, msk)
    port = load_jax_variables(build_detector(mcfg, test_cfg=tcfg), variables)
    feats, bev, preds, _ = _port_forward(port, pts, msk)
    for k, (x, _) in feats.items():
        assert x.dtype == torch.bfloat16
        _close_to_scale(_nhwc(x), jfeats[k][0], 5e-2, k)
    _close_to_scale(_nhwc(bev[0]), jbev[0], 5e-2, "neck")
    for t, (g, w) in enumerate(zip(preds, jpreds)):
        for h in g:
            _close_to_scale(g[h].float().numpy(), w[h], 5e-2, f"task{t}/{h}")
