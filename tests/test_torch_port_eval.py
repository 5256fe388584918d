"""PyTorch port, the evaluation path: the native nuScenes and Waymo
evaluators, the datasets' `evaluation`, double-flip TTA in the head,
`tools/dist_test.py`, `Trainer`'s val workflow and the reference-checkpoint
converter, against the JAX package on the same inputs.

Tolerances:
- nuScenes metrics (every per-class AP, TP error, mAP, NDS): within 1e-12
  of the JAX package's `evaluate_nusc` (the same f64 numpy), and within
  1e-9 of the committed devkit-transcription fixture, as the JAX package's
  own test holds;
- Waymo, device "cpu": the IoU matrices within 1e-4 of the JAX package's
  `_iou_matrix` (on the CPU the JAX package clips polygons; the port
  integrates edges as the rotated-overlap kernel does; the two differ by
  up to ~2e-5); AP/APH within 5e-3 of the committed independent-oracle
  fixture (the JAX package's tolerance), and within 1e-9 of the JAX
  package's `evaluate_waymo` on a set where no IoU lies within 1e-4 of
  its class threshold (checked);
- double-flip: `_average_double_flip` within 1e-6 of the JAX package's
  (the 4-way means may round differently); `predict` on fixed maps: the
  same kept slots and labels, boxes and scores within 1e-6 (the
  tolerance of the port's other predict tests);
- the datasets' `evaluation` on the same detections, `dist_test` against
  itself through both packages' datasets, `Trainer.val` against
  `dist_test` on the trainer's checkpoint, `convert_state_dict`: equal.
"""

import copy
import json
import logging
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillarnet_lts_tpu.datasets.demo import DemoDataset as JDemo
from pillarnet_lts_tpu.datasets.nuscenes import nusc_eval as jnusc
from pillarnet_lts_tpu.datasets.nuscenes.nuscenes import (
    NuScenesDataset as JNuScenes)
from pillarnet_lts_tpu.datasets.waymo import waymo_eval as jwaymo
from pillarnet_lts_tpu.datasets.waymo.waymo import WaymoDataset as JWaymo
from pillarnet_lts_tpu.models import build_detector as build_jax_detector
from pillarnet_lts_tpu.models.bbox_heads import center_head as jhead
from pillarnet_lts_tpu.runtime import torch_convert as jconv
from pillarnet_lts_tpu.utils.config import Config
from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                      spread_head_outputs, train_detector,
                                      with_double_flip)
from pillarnet_lts_torch.datasets import (DataLoader, SynthDataset,
                                          build_dataset)
from pillarnet_lts_torch.datasets.synth import (write_nuscenes_set,
                                                write_waymo_set)
from pillarnet_lts_torch.datasets.nuscenes import nusc_eval as tnusc
from pillarnet_lts_torch.datasets.waymo import waymo_eval as twaymo
from pillarnet_lts_torch.models import build_detector
from pillarnet_lts_torch.models.bbox_heads import center_head as thead
from pillarnet_lts_torch.runtime import torch_convert as tconv
from pillarnet_lts_torch.runtime.convert import (load_jax_variables,
                                                 variables_of)
from pillarnet_lts_torch.tools import dist_test

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
from chip_smoke import DOUBLE_FLIP, spread_checkpoint  # noqa: E402
from tools.make_eval_fixture import (np_iou3d,  # noqa: E402
                                     synth_nusc_scenes, synth_waymo_scenes)
import test_torch_port_threads  # noqa: F401  (one torch thread)

DEMO_PATH = os.path.join(ROOT, "configs/demo/pillarnet18_demo.py")
DEMO = load_config(DEMO_PATH)
with open(os.path.join(ROOT, "tests/fixtures/eval_fixture.json")) as f:
    FIXTURE = json.load(f)


# ---------------------------------------------------------------- nuScenes

def fixture_boxes(by_token, is_pred):
    """The devkit-format fixture scenes as evaluator box dicts (as the
    JAX package's `tests/test_nusc_eval.py` converts them)."""
    return {t: [dict(translation=np.asarray(b["translation"], np.float64),
                     size=np.asarray(b["size"], np.float64),
                     yaw=float(b["yaw"]),
                     velocity=np.asarray(b["velocity"], np.float64),
                     name=b["detection_name"],
                     score=float(b["detection_score"]) if is_pred else None,
                     attribute=b["attribute_name"]) for b in rows]
            for t, rows in by_token.items()}


def assert_nusc_metrics(got, want, tol):
    assert abs(got["mean_ap"] - want["mean_ap"]) <= tol
    assert abs(got["nd_score"] - want["nd_score"]) <= tol
    assert sorted(got["label_aps"]) == sorted(want["label_aps"])
    for cls, aps in want["label_aps"].items():
        for th, ap in aps.items():
            assert abs(got["label_aps"][cls][float(th)] - ap) <= tol, cls
    for cls, errs in want["label_tp_errors"].items():
        for m, e in errs.items():
            assert abs(got["label_tp_errors"][cls][m] - e) <= tol, (cls, m)


@pytest.mark.parametrize("seed", [0, 3])
def test_nusc_evaluator_equals_jax_and_fixture(seed):
    gt_dev, pred_dev = synth_nusc_scenes(seed=seed)
    gt, pred = fixture_boxes(gt_dev, False), fixture_boxes(pred_dev, True)
    got = tnusc.evaluate_nusc(copy.deepcopy(gt), copy.deepcopy(pred))
    want = jnusc.evaluate_nusc(gt, pred)
    assert_nusc_metrics(got, want, 1e-12)
    for m, e in want["tp_errors"].items():
        assert got["tp_errors"][m] == pytest.approx(e, abs=1e-12, nan_ok=True)
    assert 0.0 < got["mean_ap"] < 1.0
    if seed == 0:  # the committed fixture's scenes
        assert_nusc_metrics(got, FIXTURE["nusc"], 1e-9)


def detections_near(infos, class_names, seed, key="gt_boxes"):
    """Detections jittered about each frame's GT (some dropped, some false
    positives), 9-wide boxes, as dist_test hands them to `evaluation`."""
    rng = np.random.RandomState(seed)
    out = {}
    for info in infos:
        gt = np.asarray(info[key], np.float32)
        names = [str(n) for n in info["gt_names"]]
        keep = rng.rand(len(gt)) < 0.8
        boxes = gt[keep].copy()
        boxes[:, :2] += rng.randn(len(boxes), 2).astype(np.float32) * 0.3
        boxes[:, -1] += rng.randn(len(boxes)).astype(np.float32) * 0.1
        fp = gt[:2].copy()
        fp[:, :2] += 8.0
        labels = [class_names.index(n) for n, k in zip(names, keep) if k]
        out[info["token"]] = {
            "box3d_lidar": np.concatenate([boxes, fp]),
            "scores": rng.uniform(0.1, 1.0, len(boxes) + len(fp)),
            "label_preds": np.array(labels + [0] * len(fp), np.int64),
            "metadata": {"token": info["token"]},
        }
    return out


def test_nuscenes_dataset_evaluation_equals_jax(tmp_path):
    """Without the devkit both packages' `evaluation` fall back to the
    native evaluator and give the same result on the same detections."""
    names = ["car", "pedestrian", "barrier"]
    info = write_nuscenes_set(str(tmp_path), 5, 500, 2, names,
                              [-54, -54, -5, 54, 54, 3], seed=2)
    kw = dict(info_path=info, root_path=str(tmp_path), nsweeps=2,
              class_names=names, test_mode=True, pipeline=[])
    port = build_dataset(dict(kw, type="NuScenesDataset"))
    jds = JNuScenes(**kw)
    with open(info, "rb") as f:
        dets = detections_near(pickle.load(f), names, 0)
    got, _ = port.evaluation(dets, output_dir=str(tmp_path), device="cpu")
    native, _ = port.evaluation_native(dets, output_dir=str(tmp_path))
    want, _ = jds.evaluation(dets, output_dir=str(tmp_path))
    assert got == native == want
    assert "mAP: 0.0000" not in got["results"]["nusc"]
    summary = json.load(open(tmp_path / "metrics_summary.json"))
    assert summary["mean_ap"] > 0
    # GT as detections: mAP 1
    gt_dets = {t: dict(d, box3d_lidar=np.asarray(i["gt_boxes"], np.float32),
                       scores=np.ones(len(i["gt_boxes"])),
                       label_preds=np.array([names.index(n)
                                             for n in i["gt_names"]]))
               for (t, d), i in zip(dets.items(), pickle.load(open(info,
                                                                  "rb")))}
    perfect, _ = port.evaluation(gt_dets, device="cpu")
    assert "mAP: 1.0000" in perfect["results"]["nusc"]


# ------------------------------------------------------------------- Waymo

_JAX_IOU = jwaymo._iou_matrix
IOU_PAD = 48  # boxes of one class in one frame, at most


def jax_iou(gt_boxes, pred_boxes):
    """The JAX package's `_iou_matrix` on inputs padded to one shape with
    far-away boxes, then cut back: the IoU is pairwise, so the values are
    its own, and it compiles once instead of once per shape."""
    if len(gt_boxes) == 0 or len(pred_boxes) == 0:
        return _JAX_IOU(gt_boxes, pred_boxes)
    assert max(len(gt_boxes), len(pred_boxes)) <= IOU_PAD

    def pad(b):
        far = np.tile([[1e3, 1e3, 0.0, 1.0, 1.0, 1.0, 0.0]],
                      (IOU_PAD - len(b), 1))
        return np.concatenate([np.asarray(b, np.float64), far])

    return _JAX_IOU(pad(gt_boxes), pad(pred_boxes))[:len(gt_boxes),
                                                     :len(pred_boxes)]


def test_waymo_iou_matrix_within_1e4_of_jax_and_the_f64_oracle():
    """On every frame and class of the fixture's scenes: the port's IoU
    within 1e-4 of the fixture's independent f64 oracle (`np_iou3d`,
    polygon clipping in f64) and within 1e-4 of the JAX package's
    `_iou_matrix` wherever that is within 1e-4 of the oracle.
    The JAX package works in world coordinates in f32 and strays up to
    ~2e-4 from the oracle on small boxes ~70 m out; there the port (each
    row in its GT box's frame) is the closer of the two."""
    gt, pred = synth_waymo_scenes()
    matched = 0
    for token in gt:
        for cls in ("VEHICLE", "PEDESTRIAN", "CYCLIST"):
            g = gt[token]["boxes"][gt[token]["names"] == cls]
            p = pred[token]["boxes"][pred[token]["names"] == cls]
            got = twaymo._iou_matrix(g, p, device="cpu")
            assert got.shape == (len(g), len(p)) and got.dtype == np.float64
            if not got.size:
                continue
            f32 = np.float32
            oracle = np_iou3d(g.astype(f32).astype(np.float64),
                              p.astype(f32).astype(np.float64))
            np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-4)
            matched += (got > 0.5).sum()
            want = jax_iou(g, p)
            jax_ok = np.abs(want - oracle) <= 1e-4
            np.testing.assert_allclose(got[jax_ok], want[jax_ok], rtol=0,
                                       atol=1e-4)
            assert (np.abs(got - oracle) <= np.abs(want - oracle))[
                ~jax_ok].all()
    assert matched > 50  # matching pairs were among them


def test_waymo_evaluator_cpu_matches_fixture():
    gt, pred = synth_waymo_scenes()
    got = twaymo.evaluate_waymo(gt, pred, device="cpu")
    want = FIXTURE["waymo"]
    for level in ("LEVEL_1", "LEVEL_2"):
        for cls, v in want[level].items():
            for k in ("AP", "APH"):
                assert got[level][cls][k] == pytest.approx(v[k], abs=5e-3), \
                    (level, cls, k)
    assert got["mAP_L2"] == pytest.approx(want["mAP_L2"], abs=5e-3)
    assert got["mAPH_L2"] == pytest.approx(want["mAPH_L2"], abs=5e-3)


def small_waymo_set(frames=3):
    """A few frames of the fixture's scenes (few distinct IoU shapes for
    the JAX evaluator's compiles)."""
    gt, pred = synth_waymo_scenes(seed=4, n_tokens=frames)
    return gt, pred


def test_waymo_evaluator_equals_jax_away_from_thresholds(monkeypatch):
    monkeypatch.setattr(jwaymo, "_iou_matrix", jax_iou)
    gt, pred = small_waymo_set()
    near = 0
    for token in gt:
        for cls, th in twaymo.WAYMO_IOU_THRESH.items():
            g = gt[token]["boxes"][gt[token]["names"] == cls]
            p = pred[token]["boxes"][pred[token]["names"] == cls]
            iou = twaymo._iou_matrix(g, p, device="cpu")
            assert not (np.abs(iou - th) < 1e-4).any(), (token, cls)
            near += (iou >= th).sum()
    assert near > 5
    got = twaymo.evaluate_waymo(gt, pred, device="cpu")
    want = jwaymo.evaluate_waymo(gt, pred)
    for level in ("LEVEL_1", "LEVEL_2"):
        assert sorted(got[level]) == sorted(want[level])
        for cls, v in want[level].items():
            for k in ("AP", "APH"):
                assert got[level][cls][k] == pytest.approx(v[k], abs=1e-9)
    for k in ("mAP_L1", "mAPH_L1", "mAP_L2", "mAPH_L2"):
        assert got[k] == pytest.approx(want[k], abs=1e-9)
    assert 0.0 < got["mAP_L1"] < 1.0


def test_waymo_dataset_evaluation_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jwaymo, "_iou_matrix", jax_iou)
    names = ["VEHICLE", "PEDESTRIAN", "CYCLIST"]
    info = write_waymo_set(str(tmp_path), 2, 300, names,
                           [-75.2, -75.2, -2, 75.2, 75.2, 4], seed=1)
    kw = dict(info_path=info, root_path=str(tmp_path), class_names=names,
              test_mode=True, pipeline=[])
    port = build_dataset(dict(kw, type="WaymoDataset"))
    jds = JWaymo(**kw)
    with open(info, "rb") as f:
        infos = pickle.load(f)
    # GT as detections: every IoU is 1 (or 0), far from the thresholds
    dets = {i["token"]: {
        "box3d_lidar": np.asarray(i["gt_boxes"], np.float32),
        "scores": np.linspace(0.9, 0.5, len(i["gt_boxes"])),
        "label_preds": np.array([names.index(n) for n in i["gt_names"]]),
        "metadata": {"token": i["token"]}} for i in infos}
    got, _ = port.evaluation(dets, output_dir=str(tmp_path), device="cpu")
    want, _ = jds.evaluation(dets, output_dir=str(tmp_path))
    assert got == want
    assert "mAP L1 1.0000" in got["results"]["waymo"]
    assert (tmp_path / "detections.pkl").exists()


# ------------------------------------------------------------ double flip

def flip_maps(seed, frames=2, H=12, W=12, ncls=2):
    rng = np.random.RandomState(seed)
    B = 4 * frames
    return [{
        "hm": rng.randn(B, H, W, ncls).astype(np.float32) * 2,
        "reg": rng.rand(B, H, W, 2).astype(np.float32),
        "height": rng.randn(B, H, W, 1).astype(np.float32),
        "dim": (rng.randn(B, H, W, 3) * 0.2).astype(np.float32),
        "rot": rng.randn(B, H, W, 2).astype(np.float32),
        "vel": rng.randn(B, H, W, 2).astype(np.float32),
        "iou": (rng.rand(B, H, W, 1) * 2 - 1).astype(np.float32),
    }]


@pytest.mark.parametrize("seed", [0, 1])
def test_average_double_flip_equals_jax(seed):
    maps = flip_maps(seed)[0]
    got = thead._average_double_flip(
        {k: torch.from_numpy(v) for k, v in maps.items()})
    want = jax.jit(jhead._average_double_flip)(
        {k: jnp.asarray(v) for k, v in maps.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == (2, 12, 12, maps[k].shape[-1])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


def flip_cfg(multi_class):
    if multi_class:
        return dict(nms=dict(use_multi_class_nms=True, group_classes=True,
                             nms_pre_max_size=[[64, 32]],
                             nms_post_max_size=[[16, 8]],
                             nms_iou_threshold=[[0.8, 0.55]]),
                    rectifier=[[0.68, 0.71]], score_threshold=0.1,
                    post_center_limit_range=[-20, -20, -10, 20, 20, 10],
                    double_flip=True)
    return dict(copy.deepcopy(DEMO["test_cfg"]), double_flip=True)


@pytest.mark.parametrize("multi_class", [False, True],
                         ids=["rotate-nms", "multi-class"])
def test_predict_double_flip_matches_jax(multi_class):
    tasks = [dict(stride=8, class_names=["car", "pedestrian"])]
    kw = dict(tasks=tasks, pillar_size=0.5,
              point_cloud_range=[-16, -16, -5, 16, 16, 3],
              code_weights=[1.0] * 10, common_heads={}, reg_iou=None)
    maps = flip_maps(2)
    cfg = flip_cfg(multi_class)
    want = jax.jit(lambda p: jhead.CenterHeadMath(**kw).predict({}, p, cfg))(
        [{k: jnp.asarray(v) for k, v in m.items()} for m in maps])
    got = thead.CenterHeadMath(**kw).predict(
        {}, [{k: torch.from_numpy(v) for k, v in m.items()} for m in maps],
        cfg)
    m = np.asarray(want["mask"])
    assert m.shape[0] == 2 and m.any()
    np.testing.assert_array_equal(got["mask"].numpy(), m)
    np.testing.assert_array_equal(got["label_preds"].numpy()[m],
                                  np.asarray(want["label_preds"])[m])
    for key in ("box3d_lidar", "scores"):
        np.testing.assert_allclose(got[key].numpy()[m],
                                   np.asarray(want[key])[m], rtol=0,
                                   atol=1e-6, err_msg=key)


# ---------------------------------------------------- dist_test, Trainer

def small_demo_config(tmp_path, double_flip=False):
    """The demo config with 2 val frames of 2048 points, batches of 2 (and
    double-flip TTA)."""
    path = tmp_path / ("small_demo_flip.py" if double_flip
                       else "small_demo.py")
    path.write_text(f"exec(open({DEMO_PATH!r}).read())\n"
                    "data['samples_per_gpu'] = 2\n"
                    "data['max_points'] = 2048\n"
                    "data['val'] = dict(data['val'], num_frames=2, "
                    "num_points=2048)\n"
                    + (DOUBLE_FLIP if double_flip else ""))
    return str(path)


def test_dist_test_demo_matches_jax_evaluation(tmp_path):
    cfg_path = small_demo_config(tmp_path, double_flip=True)
    ckpt = spread_checkpoint(torch, cfg_path, "cpu", str(tmp_path / "ckpt"),
                             seed=1)
    out = dist_test.main([cfg_path, "--device", "cpu", "--seed", "1",
                          "--checkpoint", ckpt, "--work_dir", str(tmp_path)])
    dets = out["detections"]
    assert sorted(dets) == ["demo_0", "demo_1"]
    assert sum(len(d["scores"]) for d in dets.values()) > 0
    with open(tmp_path / "prediction.pkl", "rb") as f:
        saved = pickle.load(f)
    assert sorted(saved) == sorted(dets)
    val = load_config(cfg_path)["data"]["val"]
    val.pop("type")
    want, _ = JDemo(**val).evaluation(dets)
    assert out["result"] == want
    assert out["speed"]["frames"] == 2


def test_double_flip_config_text_equals_with_double_flip(tmp_path):
    """A config file that ends in `chip_smoke.DOUBLE_FLIP` loads as
    `apis.with_double_flip` of the same config without it."""
    got = load_config(small_demo_config(tmp_path, double_flip=True))
    want = with_double_flip(load_config(small_demo_config(tmp_path)))
    assert got == want
    assert got["test_cfg"]["double_flip"] is True
    types = [st["type"] for st in got["data"]["val"]["pipeline"]]
    assert types[-2:] == ["DoubleFlip", "Reformat"]


def test_pipelined_rate_over_the_middle_third(monkeypatch):
    """`dist_test.pipelined` over 6 batches of 1-6 frames, on a clock that
    ticks once a reading: every frame's detections, the whole pass's rate,
    and the steady rate from the frames of batches 4-5 (0-based 3-4) over
    the time from batch 3's end to batch 5's."""
    clock = iter(range(100))
    monkeypatch.setattr(dist_test, "time",
                        type("Clock", (), {"perf_counter":
                                           staticmethod(lambda: next(clock))}))
    batches = [{"points": np.zeros((b, 4, 5), np.float32),
                "points_mask": np.ones((b, 4), bool),
                "metadata": [{"token": f"{b}_{i}"} for i in range(b)]}
               for b in range(1, 7)]

    def infer(points, mask):
        B = points.shape[0]
        return {"box3d_lidar": torch.zeros((B, 2, 7)),
                "scores": torch.zeros((B, 2)),
                "label_preds": torch.zeros((B, 2), dtype=torch.long),
                "mask": torch.zeros((B, 2), dtype=torch.bool)}

    dets, rec = dist_test.pipelined(infer, batches, torch.device("cpu"),
                                    lambda b: b["metadata"],
                                    logging.getLogger("test"))
    assert len(dets) == 21 == rec["frames"]
    # readings: 0 before the pass, 1-6 at the batches' ends, 7 after it
    assert (rec["batches"], rec["seconds"]) == (6, 7)
    assert rec["frames_per_s"] == 21 / 7
    assert rec["steady_frames_per_s"] == (4 + 5) / (5 - 3)


def nusc_demo_config(tmp_path, info, nsweeps):
    """The demo model reading a nuScenes-layout set from disk."""
    path = tmp_path / "nusc_demo.py"
    path.write_text(
        f"exec(open({DEMO_PATH!r}).read())\n"
        f"data['samples_per_gpu'] = 2\n"
        f"data['val'] = dict(type='NuScenesDataset', root_path="
        f"{str(tmp_path)!r}, info_path={info!r}, nsweeps={nsweeps}, "
        f"class_names=class_names, test_mode=True, pipeline=["
        f"dict(type='LoadPointCloudFromFile', dataset='NuScenesDataset'), "
        f"dict(type='LoadPointCloudAnnotations', with_bbox=True), "
        f"dict(type='Preprocess', cfg=dict(mode='val', "
        f"shuffle_points=False)), dict(type='Reformat')])\n")
    return str(path)


def test_dist_test_nuscenes_layout_matches_jax_evaluation(tmp_path):
    info = write_nuscenes_set(str(tmp_path), 3, 1000, 3, DEMO["class_names"],
                              DEMO["point_cloud_range"], seed=6)
    cfg_path = nusc_demo_config(tmp_path, info, 3)
    ckpt = spread_checkpoint(torch, cfg_path, "cpu", str(tmp_path / "ckpt"))
    args = [cfg_path, "--device", "cpu", "--checkpoint", ckpt,
            "--work_dir", str(tmp_path / "out")]
    out = dist_test.main(args)
    speed = dist_test.main(args + ["--speed_test"])
    assert speed["speed"]["frames"] == 3 and speed["speed"]["host_ms"] > 0
    # 2 batches: no middle third to time
    assert (out["speed"]["batches"], out["speed"]["steady_frames_per_s"]) \
        == (2, None)
    assert sorted(out["detections"]) == sorted(speed["detections"])
    cfg = load_config(cfg_path)["data"]["val"]
    cfg.pop("type")
    want, _ = JNuScenes(**cfg).evaluation(out["detections"],
                                          output_dir=str(tmp_path))
    assert out["result"] == want
    assert "Nusc (native eval)" in out["result"]["results"]["nusc"]


def test_trainer_val_workflow_matches_dist_test(tmp_path, caplog):
    cfg_path = small_demo_config(tmp_path)
    cfg = load_config(cfg_path)
    model = build_model_from_cfg(cfg, device="cpu", seed=3)
    val_ds = build_dataset(cfg["data"]["val"])
    pts = torch.from_numpy(SynthDataset(cfg, 1, 2048)[0]["points"][None])
    spread_head_outputs(model, pts, torch.ones(pts.shape[:2], dtype=bool))
    with caplog.at_level(logging.INFO):
        trainer = train_detector(model, SynthDataset(cfg, 2, 2048), cfg,
                                 work_dir=str(tmp_path / "run"),
                                 val_dataset=val_ds)
    logged = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("Evaluation demo")]
    assert trainer.epoch == 1 and len(logged) == 1
    out = dist_test.main([str(cfg_path), "--device", "cpu",
                          "--checkpoint", str(tmp_path / "run/epoch_1.pth"),
                          "--work_dir", str(tmp_path / "test")])
    assert logged[0] == f"Evaluation demo: {out['result']['results']['demo']}"
    dets, result = trainer.val(
        DataLoader(val_ds, 2, max_points=2048, drop_last=False), val_ds)
    assert result == out["result"]
    for token, d in out["detections"].items():
        for k in ("box3d_lidar", "scores", "label_preds"):
            np.testing.assert_array_equal(dets[token][k], d[k])
    assert sum(len(d["scores"]) for d in dets.values()) > 0
    with pytest.raises(ValueError, match="requires val_loader"):
        trainer.run(None, 2, workflow=[("train", 1), ("val", 1)])
    with pytest.raises(ValueError, match="unknown workflow mode"):
        trainer.run(None, 2, workflow=[("test", 1)])


def test_dist_test_checkpoint_kinds_agree(tmp_path):
    """`--checkpoint` with a reference det3d `.pth` (converted on load)
    and with a port checkpoint of the same converted weights give the
    same detections."""
    jcfg = Config.fromfile(DEMO_PATH)
    jmodel = build_jax_detector(jcfg.model)
    tmpl = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 5), jnp.float32),
        jnp.ones((1, 64), bool), train=False))
    rng = np.random.RandomState(1)
    sd = {k: (rng.randn(*shape) * 0.1).astype(np.float32)
          for _, (k, shape) in jconv.expected_source_keys(tmpl).items()}
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = np.abs(sd[k]) + 0.5
    ref = tmp_path / "reference.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in sd.items()}}, ref)
    model = build_model_from_cfg(DEMO, device="cpu")
    load_jax_variables(model, jconv.convert_state_dict(sd, tmpl)[0])
    port = tmp_path / "port.pth"
    torch.save({"model": model.state_dict(), "optimizer": {},
                "meta": {"epoch": 0}}, port)
    cfg_path = small_demo_config(tmp_path)
    outs = [dist_test.main([cfg_path, "--device", "cpu", "--checkpoint",
                            str(path), "--work_dir", str(tmp_path / name)])
            for name, path in (("ref", ref), ("port", port))]
    a, b = (o["detections"] for o in outs)
    assert sorted(a) == sorted(b)
    for t in a:
        for k in ("box3d_lidar", "scores", "label_preds"):
            np.testing.assert_array_equal(a[t][k], b[t][k])


def test_dist_test_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist_test.main([DEMO_PATH, "--work_dir", str(tmp_path)])


# ---------------------------------------------------- reference weights

@pytest.mark.parametrize("cfg_path", [
    "configs/pillarnet/pillarnet34_nusc.py",
    "configs/pillarnet/pillarnet18_waymo.py",
    "configs/pillarnet/pillarnet34_fpn_waymo.py",
    "configs/pillarnet/pillarnet18_s4_waymo.py",
    "configs/pillarrcnn/pillarrcnn18_waymo.py",
], ids=os.path.basename)
def test_convert_state_dict_equals_jax(cfg_path):
    """The structural cases of `tests/test_torch_convert.py`, built the
    same way: the port's converter gives the JAX package's tree leaf for
    leaf, its template (from the port model) is the JAX variables tree
    shape for shape, and the converted tree loads into the port model."""
    jcfg = Config.fromfile(os.path.join(ROOT, cfg_path))
    jmodel = build_jax_detector(jcfg.model, train_cfg=jcfg.train_cfg,
                                test_cfg=jcfg.test_cfg)
    pts, msk = jnp.zeros((1, 64, 5), jnp.float32), jnp.ones((1, 64), bool)
    if jcfg.model["type"] == "PillarRCNN":
        tmpl = jax.eval_shape(lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0),
             "sampler": jax.random.PRNGKey(1)},
            pts, msk, jnp.zeros((1, 8, 10), jnp.float32), train=True))
    else:
        tmpl = jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), pts, msk, train=False))
    exp = jconv.expected_source_keys(tmpl)
    rng = np.random.RandomState(0)
    sd = {k: rng.randn(*s).astype(np.float32) for _, (k, s) in exp.items()}
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = np.abs(sd[k]) + 0.5
    want, wrep = jconv.convert_state_dict(sd, tmpl, strict=True)

    cfg = load_config(os.path.join(ROOT, cfg_path))
    model = build_detector(cfg["model"], train_cfg=cfg.get("train_cfg"),
                           test_cfg=cfg["test_cfg"], device="cpu")
    port_tmpl = variables_of(model)
    flat = jax.tree_util.tree_flatten_with_path
    assert ([(jax.tree_util.keystr(p), tuple(v.shape))
             for p, v in flat(port_tmpl)[0]]
            == [(jax.tree_util.keystr(p), tuple(v.shape))
                for p, v in flat(dict(tmpl))[0]])
    got, rep = tconv.convert_state_dict(sd, port_tmpl, strict=True)
    assert {k: sorted(v) for k, v in rep.items()} == {
        k: sorted(v) for k, v in wrep.items()}
    (gl, gdef), (wl, wdef) = flat(got), flat(dict(want))
    assert gdef == wdef
    for (p, g), (_, w) in zip(gl, wl):
        assert g.dtype == w.dtype, jax.tree_util.keystr(p)
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(p))
    if "nusc" in cfg_path:  # a reference .pth into the model
        path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                            f"ref_{os.getpid()}.pth")
        torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v)
                                   for k, v in sd.items()}}, path)
        try:
            report = tconv.load_reference_checkpoint(model, path)
        finally:
            os.remove(path)
        assert len(report["converted"]) == len(rep["converted"])
        load_jax_variables(model, got)  # the same tree, strict


# ------------------------------------------------------------ no JAX

def test_eval_path_imports_no_jax(tmp_path):
    """Every module of the eval path imported, and `dist_test` run on the
    demo config on the CPU, in a process where importing `jax` or the JAX
    package fails."""
    modules = [
        "pillarnet_lts_torch.utils.registry",
        "pillarnet_lts_torch.datasets",
        "pillarnet_lts_torch.datasets.builder",
        "pillarnet_lts_torch.datasets.custom",
        "pillarnet_lts_torch.datasets.demo",
        "pillarnet_lts_torch.datasets.eval_metric",
        "pillarnet_lts_torch.datasets.loader.build_loader",
        "pillarnet_lts_torch.datasets.nuscenes.nusc_common",
        "pillarnet_lts_torch.datasets.nuscenes.nusc_eval",
        "pillarnet_lts_torch.datasets.nuscenes.nuscenes",
        "pillarnet_lts_torch.datasets.pipelines.compose",
        "pillarnet_lts_torch.datasets.pipelines.loading",
        "pillarnet_lts_torch.datasets.pipelines.noop",
        "pillarnet_lts_torch.datasets.pipelines.test_aug",
        "pillarnet_lts_torch.datasets.waymo.waymo",
        "pillarnet_lts_torch.datasets.waymo.waymo_eval",
        "pillarnet_lts_torch.eval_utils",
        "pillarnet_lts_torch.runtime.torch_convert",
        "pillarnet_lts_torch.runtime.trainer",
        "pillarnet_lts_torch.tools.dist_test",
    ]
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'pillarnet_lts_tpu'):\n"
        "    sys.modules[name] = None  # importing it raises\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "from pillarnet_lts_torch.tools import dist_test\n"
        "out = dist_test.main([sys.argv[1], '--device', 'cpu', "
        "'--checkpoint', sys.argv[3], '--work_dir', sys.argv[2]])\n"
        "assert 'demo' in out['result']['results']\n"
        "print('no-jax ok')\n")
    cfg_path = small_demo_config(tmp_path)
    ckpt = spread_checkpoint(torch, cfg_path, "cpu", str(tmp_path / "ckpt"))
    out = subprocess.run([sys.executable, "-c", code, cfg_path,
                          str(tmp_path), ckpt],
                         cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "no-jax ok" in out.stdout
