"""PyTorch port, Waymo single-stage path: per-class (multi-class) NMS, the
per-task regrouping of its params, and a shrunk Waymo-shaped slice, against
the JAX package on the same numpy inputs.

Tolerances: keep sets and labels equal; multi-class predict on fixed head
outputs: boxes and scores within 1e-6 (the same f32 decode on both sides);
the whole slice: the tolerances of `tests/test_golden_e2e.py` (scores 1e-4,
boxes 1e-3), after the score-threshold and IoU-threshold margins of
`test_torch_port_e2e.py::test_shrunk_flagship_slice_matches_jax` are
asserted (random weights put candidates near both thresholds).
"""

import copy
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillarnet_lts_tpu.core.utils import set_by_task_cfg as jax_set_by_task_cfg
from pillarnet_lts_tpu.models import build_detector as build_jax_detector
from pillarnet_lts_torch.apis import (
    build_model_from_cfg,
    load_config,
    spread_head_outputs,
)
from pillarnet_lts_torch.core.utils import set_by_task_cfg
from pillarnet_lts_torch.eval_utils import make_infer_fn
from pillarnet_lts_torch.models import build_detector
from pillarnet_lts_torch.models.bbox_heads.center_head import CenterHeadMath
from pillarnet_lts_torch.ops.iou3d import rotated_iou_bev, to_pcdet_bev
from pillarnet_lts_torch.runtime.convert import load_jax_variables
from test_multiclass_nms_grouping import _cfg, _head_and_preds
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_torch_port_e2e import spread_both_heads
from test_torch_port_modules import jit_apply, random_variables

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WAYMO_CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*",
                                              "*waymo*.py")))
# the single-stage Waymo configs the port serves (RPNV1 / RPNV2 necks)
SERVED = ["pillarnet18_waymo", "pillarnet34_waymo", "pillarnet18_s4_waymo",
          "pillarnet34_s4_waymo"]
PC_RANGE = [-75.2, -75.2, -2.0, 75.2, 75.2, 4.0]
PILLAR = 150.4 / 128  # 128 x 128 grid, stride-8 head maps 16 x 16
CLASSES = ["VEHICLE", "PEDESTRIAN", "CYCLIST"]


@pytest.mark.parametrize("path", WAYMO_CONFIGS, ids=os.path.basename)
def test_set_by_task_cfg_matches_jax(path):
    cfg = load_config(path)
    num_classes = [len(t["class_names"]) for t in cfg["tasks"]]
    got = set_by_task_cfg(copy.deepcopy(cfg["test_cfg"]), num_classes)
    want = jax_set_by_task_cfg(copy.deepcopy(cfg["test_cfg"]), num_classes)
    assert got == want
    assert got["nms"]["nms_iou_threshold"] != cfg["test_cfg"]["nms"][
        "nms_iou_threshold"]  # regrouped per task


def _torch_preds(preds):
    return [{k: torch.from_numpy(np.array(v)) for k, v in p.items()}
            for p in preds]


@pytest.mark.parametrize("seed,group,mask_kernel", [
    (0, True, False), (3, True, False), (0, False, False), (3, False, False),
    (0, True, True),
])
def test_multiclass_predict_matches_jax(seed, group, mask_kernel):
    jmath, preds = _head_and_preds(seed)
    cfg = _cfg(group)
    want = jax.jit(lambda p: jmath.predict({}, p, cfg))(preds)
    cfg = copy.deepcopy(cfg)
    cfg["nms"]["use_mask_kernel"] = mask_kernel
    math = CenterHeadMath(jmath.tasks, jmath.pillar_size,
                          jmath.point_cloud_range)
    got = math.predict({}, _torch_preds(preds), cfg)
    m = np.asarray(want["mask"])
    assert m.shape == (2, 16 + 8 + 8) and m.any()
    np.testing.assert_array_equal(got["mask"].numpy(), m)
    np.testing.assert_array_equal(got["label_preds"].numpy()[m],
                                  np.asarray(want["label_preds"])[m])
    for key in ("box3d_lidar", "scores"):
        np.testing.assert_allclose(got[key].numpy()[m],
                                   np.asarray(want[key])[m], rtol=0,
                                   atol=1e-6, err_msg=key)


def test_grouped_multiclass_respects_per_class_pre_limits():
    jmath, preds = _head_and_preds(1)
    cfg = _cfg(True)
    cfg["nms"]["nms_pre_max_size"] = [[64, 8, 8]]
    want = jax.jit(lambda p: jmath.predict({}, p, cfg))(preds)
    math = CenterHeadMath(jmath.tasks, jmath.pillar_size,
                          jmath.point_cloud_range)
    got = math.predict({}, _torch_preds(preds), cfg)
    loop = math.predict({}, _torch_preds(preds),
                        dict(cfg, nms=dict(cfg["nms"], group_classes=False)))
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    assert torch.equal(got["mask"], loop["mask"])
    m = got["mask"].numpy()
    np.testing.assert_allclose(got["scores"].numpy()[m],
                               np.asarray(want["scores"])[m], atol=1e-6)


def shrunk_waymo_cfg(group_classes=True):
    """pillarnet18_waymo's structure (PillarResNet18 + RPNV1 + one 3-class
    task, no vel, box dim 7, per-class NMS with flat per-class params) at
    narrow widths on a 128^2 grid."""
    model = dict(
        type="PillarNet",
        reader=dict(type="DynamicPFE", in_channels=5, num_filters=(8,),
                    pillar_size=PILLAR, pc_range=PC_RANGE),
        backbone=dict(type="PillarResNet18", in_channels=8, s2d_stage1=False,
                      hpack=False, chunk_nc=0),
        neck=dict(type="RPNV1", layer_nums=[2, 2], num_filters=32,
                  in_channels=[32, 32]),
        bbox_head=dict(
            type="CenterHead", tasks=[dict(stride=8, class_names=CLASSES)],
            in_channels=[32], code_weights=[1.0] * 8,
            common_heads={"reg": (2, 2), "height": (1, 2), "dim": (3, 2),
                          "rot": (2, 2)},
            reg_iou="GIoU", pillar_size=PILLAR, point_cloud_range=PC_RANGE),
    )
    test_cfg = dict(
        nms=dict(use_multi_class_nms=True, group_classes=group_classes,
                 nms_pre_max_size=[128, 64, 64],
                 nms_post_max_size=[40, 30, 30],
                 nms_iou_threshold=[0.8, 0.55, 0.55]),
        rectifier=[0, 0, 0], score_threshold=0.1,
        post_center_limit_range=[-80, -80, -10.0, 80, 80, 10.0])
    return model, test_cfg


@pytest.mark.parametrize("group_classes", [True, False])
def test_shrunk_waymo_slice_matches_jax(group_classes):
    from __graft_entry__ import _synth_points_realistic

    mcfg, tcfg = shrunk_waymo_cfg(group_classes)
    pts, msk = _synth_points_realistic(1, 8192, PC_RANGE, seed=6, nsweeps=1)
    jmodel = build_jax_detector(copy.deepcopy(mcfg), test_cfg=tcfg)
    variables = random_variables(jmodel, 13, jnp.asarray(pts),
                                 jnp.asarray(msk), train=False)
    variables = jax.tree_util.tree_map(np.array, variables)

    port = build_detector(mcfg, test_cfg=tcfg)
    tpts, tmsk = torch.from_numpy(pts), torch.from_numpy(msk)
    spread_both_heads(port, variables, tpts, tmsk)

    tcfg_p = port.processed_test_cfg()
    with torch.inference_mode():
        preds = port(tpts, tmsk)
        det = port.predict({}, preds, tcfg_p)
    jpreds = jit_apply(jmodel, variables, jnp.asarray(pts), jnp.asarray(msk))
    jcfg = jmodel.processed_test_cfg()
    jdet = jax.jit(lambda p: jmodel.predict({}, p, jcfg))(jpreds)

    # guards: no candidate score on the score threshold, and no pair of
    # kept same-class boxes with its IoU on that class's threshold
    scores = torch.sigmoid(preds[0]["hm"]).amax(-1).flatten()
    assert (scores - tcfg["score_threshold"]).abs().min() > 1e-4
    m = det["mask"][0]
    assert det["mask"].shape == (1, 100) and int(m.sum()) > 0
    kept = det["box3d_lidar"][0]
    for k, th in enumerate(tcfg["nms"]["nms_iou_threshold"]):
        cls = m & (det["label_preds"][0] == k)
        if int(cls.sum()) > 1:
            b = to_pcdet_bev(kept[cls])
            iou = rotated_iou_bev(b, b)
            off = ~torch.eye(len(b), dtype=torch.bool)
            assert (iou[off] - th).abs().min() > 1e-4

    np.testing.assert_array_equal(det["mask"].numpy(),
                                  np.asarray(jdet["mask"]))
    mm = det["mask"].numpy()
    np.testing.assert_array_equal(det["label_preds"].numpy()[mm],
                                  np.asarray(jdet["label_preds"])[mm])
    np.testing.assert_allclose(det["scores"].numpy()[mm],
                               np.asarray(jdet["scores"])[mm], atol=1e-4)
    np.testing.assert_allclose(det["box3d_lidar"].numpy()[mm],
                               np.asarray(jdet["box3d_lidar"])[mm], atol=1e-3)
    assert det["box3d_lidar"].shape[-1] == 7
    assert set(det["label_preds"].numpy()[mm].tolist()) <= {0, 1, 2}


def test_load_jax_variables_full_width_waymo():
    """The flax tree of the full-width pillarnet34_waymo (one task, three
    classes, no vel branch) loads into the port's model: every leaf used,
    every tensor filled, shapes equal."""
    cfg = load_config(os.path.join(ROOT, "configs", "pillarnet",
                                   "pillarnet34_waymo.py"))
    jmodel = build_jax_detector(copy.deepcopy(cfg["model"]),
                                test_cfg=cfg["test_cfg"])
    pts = jnp.zeros((1, 64, 5), jnp.float32)
    variables = random_variables(jmodel, 1, pts, jnp.ones((1, 64), bool),
                                 train=False)
    variables = jax.tree_util.tree_map(np.array, variables)
    port = build_model_from_cfg(cfg, device="cpu")
    load_jax_variables(port, variables)
    head = variables["params"]["head_net"]["task0"]
    assert set(k.split("_")[0] for k in head) == {"reg", "height", "dim",
                                                 "rot", "hm"}
    w = port.head_net.task0.hm_out.weight
    np.testing.assert_array_equal(
        w.detach().numpy(),
        np.transpose(head["hm_out"]["kernel"], (3, 2, 0, 1)))
    assert w.shape[0] == 3


@pytest.mark.parametrize("name", SERVED)
def test_waymo_config_serves_on_cpu(name):
    """Each served Waymo config, its structure and test_cfg as written, cut
    to a 128^2 grid and narrow widths, serves a request through
    `make_infer_fn` with multi-class NMS (200 + 150 + 150 slots)."""
    from __graft_entry__ import _synth_points_realistic

    cfg = load_config(os.path.join(ROOT, "configs", "pillarnet",
                                   name + ".py"))
    model = cfg["model"]
    model["reader"].update(num_filters=(8,), pillar_size=PILLAR)
    model["backbone"]["in_channels"] = 8
    model["neck"].update(num_filters=32, in_channels=[32, 16])
    model["bbox_head"]["pillar_size"] = PILLAR
    net = build_model_from_cfg(cfg, device="cpu", seed=2)
    pts, msk = _synth_points_realistic(1, 4096, PC_RANGE, seed=3, nsweeps=1)
    pts, msk = torch.from_numpy(pts), torch.from_numpy(msk)
    spread_head_outputs(net, pts, msk)
    det = make_infer_fn(net)(pts, msk)
    assert det["box3d_lidar"].shape == (1, 500, 7)
    assert det["mask"].shape == (1, 500) and bool(det["mask"].any())
    assert bool(torch.isfinite(det["box3d_lidar"]).all())
    m = det["mask"][0]
    for k, (lo, hi) in enumerate(((0, 200), (200, 350), (350, 500))):
        assert (det["label_preds"][0, lo:hi][m[lo:hi]] == k).all()
