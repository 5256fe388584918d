"""Native Waymo detection metrics (devkit-free AP / APH, L1 / L2).

The reference evaluates Waymo by exporting `detection_pred.bin` for the
official `compute_detection_metrics_main` binary
(`det3d/datasets/waymo/waymo_common.py:53-117`), which needs the
waymo-open-dataset package (a heavy TF dependency that frequently cannot be
installed).  This module re-implements the Waymo Open Dataset detection
protocol (Sun et al., CVPR 2020, §5; metric semantics mirrored from the
public metrics library) in numpy + the port's 3D IoU (`ops/iou3d.py`):

  * per-class 3D-IoU matching — VEHICLE 0.7, PEDESTRIAN 0.5, CYCLIST 0.5 —
    with Hungarian assignment maximizing total IoU per frame;
  * PR points swept over score cutoffs, re-matching at each cutoff exactly
    like the official library (the IoU matrix is cutoff-independent and
    computed once per frame);
  * AP = step integral of the precision envelope over recall; APH weights
    every TP by heading accuracy max(0, 1 - |dyaw_wrapped| / pi) in both
    precision and recall;
  * difficulty: LEVEL_2 gt = manual difficulty 2 or <= 5 lidar points;
    LEVEL_1 metrics treat L2 gt as don't-care (matched predictions are
    neither TP nor FP, unmatched L2 gt are not FN).

Deviations from the official binary (documented):
  * score cutoffs default to a fixed uniform grid (the official tool derives
    data-dependent cutoffs targeting even recall deltas) — sub-0.1pp effect
    at 101 cutoffs;
  * no per-range / velocity breakdowns.

This is the port's copy of `pillarnet_lts_tpu/datasets/waymo/
waymo_eval.py`. Its one change: the (gt, prediction) IoU matrix of each
frame and class is `ops.iou3d.boxes_iou3d` on `device`, in each GT box's
own frame, whose BEV overlap is one launch of the rotated-overlap kernel
(`csrc/rotated_overlap.cu`) on a CUDA device and the kernel's plain
version on the CPU; the matrix comes back to the host for the Hungarian
match. The JAX package computes it with its own `boxes_iou3d` in world
coordinates.
"""

from typing import Dict, Optional

import numpy as np
import torch

from ...ops.iou3d import boxes_iou3d

__all__ = [
    "WAYMO_IOU_THRESH",
    "compute_ap_from_points",
    "evaluate_waymo",
    "gt_from_infos",
    "preds_from_detections",
]

WAYMO_IOU_THRESH = {"VEHICLE": 0.7, "PEDESTRIAN": 0.5, "CYCLIST": 0.5}


def _to7(boxes):
    """det3d 9-dim [x y z w l h vx vy r] (or 7-dim) -> 7-dim IoU layout;
    no boxes (a frame without detections) -> (0, 7)."""
    boxes = np.asarray(boxes, np.float64)
    if boxes.size == 0:
        return np.zeros((0, 7))
    boxes = boxes.reshape(len(boxes), -1)
    if boxes.shape[1] == 9:
        boxes = boxes[:, [0, 1, 2, 3, 4, 5, 8]]
    return boxes


def gt_from_infos(infos) -> Dict[str, dict]:
    """Info pkl records -> {token: {boxes7, names, yaw, difficulty}}.

    Difficulty uses `difficulty` / `num_points_in_gt` when the info was
    created by our `waymo_infos.py` (additive fields); reference-layout
    infos without them evaluate everything as LEVEL_1 (L1 == L2 then).
    """
    out = {}
    for info in infos:
        boxes = _to7(info["gt_boxes"])
        names = np.asarray(info["gt_names"]).astype(str)
        n = len(names)
        manual = np.asarray(
            info.get("difficulty", np.zeros(n))).reshape(-1)
        npts = np.asarray(
            info.get("num_points_in_gt", np.full(n, 6))).reshape(-1)
        difficulty = np.where((manual == 2) | (npts <= 5), 2, 1)
        out[info["token"]] = {
            "boxes": boxes,
            "names": np.char.upper(names),
            "difficulty": difficulty,
        }
    return out


def preds_from_detections(detections, class_names) -> Dict[str, dict]:
    """dist_test detection dicts -> {token: {boxes7, names, scores}}."""
    out = {}
    upper = [str(c).upper() for c in class_names]
    for token, det in detections.items():
        box3d = np.asarray(det["box3d_lidar"], np.float64)
        labels = np.asarray(det["label_preds"], np.int64)
        out[token] = {
            "boxes": _to7(box3d),
            "names": np.array([upper[i] for i in labels]),
            "scores": np.asarray(det["scores"], np.float64),
        }
    return out


def _iou_matrix(gt_boxes, pred_boxes, device="cuda") -> np.ndarray:
    """(G, 7) x (P, 7) f64 -> (G, P) f64: the 3D IoU in f32 on `device`,
    each row in its GT box's own frame. Both boxes of a pair move by the
    GT box's BEV centre (in f64) before the f32 corners and edge integrals,
    which in world coordinates lose ~1e-4 of IoU on a pedestrian 70 m out
    (their rounding grows with the distance from the origin). One (G, 1,
    P) `boxes_iou3d` call: one rotated-overlap launch on a CUDA device,
    none if G or P is 0."""
    if len(gt_boxes) == 0 or len(pred_boxes) == 0:
        return np.zeros((len(gt_boxes), len(pred_boxes)))
    gt = np.asarray(gt_boxes, np.float64)
    rel = np.repeat(np.asarray(pred_boxes, np.float64)[None], len(gt), 0)
    rel[..., :2] -= gt[:, None, :2]
    local = gt.copy()
    local[:, :2] = 0.0
    iou = boxes_iou3d(
        torch.from_numpy(local[:, None].astype(np.float32)).to(device),
        torch.from_numpy(rel.astype(np.float32)).to(device))
    return iou[:, 0].cpu().numpy().astype(np.float64)


def _heading_acc(gt_yaw, pred_yaw) -> np.ndarray:
    d = np.abs(gt_yaw[:, None] - pred_yaw[None, :]) % (2 * np.pi)
    d = np.minimum(d, 2 * np.pi - d)
    return np.maximum(0.0, 1.0 - d / np.pi)


def _match(iou, thresh):
    """Hungarian assignment maximizing total IoU over pairs >= thresh.

    Returns (gt_idx, pred_idx) arrays of accepted matches.
    """
    if iou.size == 0:
        return np.zeros(0, int), np.zeros(0, int)
    from scipy.optimize import linear_sum_assignment

    cost = np.where(iou >= thresh, -iou, 0.0)
    rows, cols = linear_sum_assignment(cost)
    ok = iou[rows, cols] >= thresh
    return rows[ok], cols[ok]


def compute_ap_from_points(recalls, precisions) -> float:
    """Step integral of the precision envelope over recall (the official
    compute_ap semantics: precision made non-increasing in recall, then
    sum of recall deltas x precision)."""
    r = np.asarray(recalls, np.float64)
    p = np.asarray(precisions, np.float64)
    order = np.argsort(r)
    r, p = r[order], p[order]
    # envelope: p[i] = max precision at recall >= r[i]
    p = np.maximum.accumulate(p[::-1])[::-1]
    prev = 0.0
    ap = 0.0
    for ri, pi in zip(r, p):
        ap += (ri - prev) * pi
        prev = ri
    return float(ap)


def evaluate_waymo(gt_by_token, pred_by_token, class_names=None,
                   cutoffs: Optional[np.ndarray] = None, verbose=False,
                   device="cuda"):
    """Full Waymo-protocol evaluation -> metrics dict.

    Args:
      gt_by_token / pred_by_token: outputs of `gt_from_infos` /
        `preds_from_detections` (a common rigid frame, det3d yaw).
      class_names: classes to evaluate (default: all with an IoU threshold).
      cutoffs: score cutoffs for the PR sweep (default uniform 101).
      device: where the IoU matrices are computed ("cuda": the
        rotated-overlap kernel, one launch per frame and class with both
        boxes; "cpu": its plain version).

    Returns {"LEVEL_1": {cls: {"AP":..,"APH":..}}, "LEVEL_2": {...},
             "mAP_L1", "mAPH_L1", "mAP_L2", "mAPH_L2"}.
    """
    classes = [c.upper() for c in (class_names or WAYMO_IOU_THRESH)]
    classes = [c for c in classes if c in WAYMO_IOU_THRESH]
    if cutoffs is None:
        cutoffs = np.linspace(0.0, 1.0, 101)

    result = {"LEVEL_1": {}, "LEVEL_2": {}}
    for cls in classes:
        thresh = WAYMO_IOU_THRESH[cls]
        # per-frame, cutoff-independent precomputation
        frames = []
        n_counted = {1: 0, 2: 0}
        for token, gt in gt_by_token.items():
            gm = gt["names"] == cls
            g_boxes = gt["boxes"][gm]
            g_diff = gt["difficulty"][gm]
            pred = pred_by_token.get(token)
            if pred is None:
                pm = np.zeros(0, bool)
                p_boxes = np.zeros((0, 7))
                p_scores = np.zeros(0)
            else:
                pm = pred["names"] == cls
                p_boxes = pred["boxes"][pm]
                p_scores = pred["scores"][pm]
            iou = _iou_matrix(g_boxes, p_boxes, device)
            hacc = _heading_acc(g_boxes[:, 6], p_boxes[:, 6])
            frames.append((iou, hacc, g_diff, p_scores))
            n_counted[1] += int((g_diff == 1).sum())
            n_counted[2] += len(g_diff)

        for level in (1, 2):
            npos = n_counted[level]
            if npos == 0:
                continue
            pts_r, pts_p, pts_rh, pts_ph = [], [], [], []
            for cut in cutoffs:
                tp = fp = 0
                tph = 0.0
                for iou, hacc, g_diff, p_scores in frames:
                    keep = p_scores >= cut
                    if not keep.any():
                        continue
                    sub = iou[:, keep]
                    gi, pi = _match(sub, thresh)
                    counted = g_diff[gi] <= level
                    n_tp = int(counted.sum())
                    tp += n_tp
                    tph += float(hacc[:, keep][gi, pi][counted].sum())
                    # matches to higher-difficulty gt are don't-care
                    fp += int(keep.sum()) - len(gi)
                if tp + fp == 0:
                    continue
                pts_r.append(tp / npos)
                pts_p.append(tp / (tp + fp))
                pts_rh.append(tph / npos)
                pts_ph.append(tph / (tp + fp))
            result[f"LEVEL_{level}"][cls] = {
                "AP": compute_ap_from_points(pts_r, pts_p),
                "APH": compute_ap_from_points(pts_rh, pts_ph),
            }

    for level in (1, 2):
        per = result[f"LEVEL_{level}"]
        result[f"mAP_L{level}"] = float(np.mean(
            [v["AP"] for v in per.values()])) if per else 0.0
        result[f"mAPH_L{level}"] = float(np.mean(
            [v["APH"] for v in per.values()])) if per else 0.0

    if verbose:
        for level in (1, 2):
            for cls, v in result[f"LEVEL_{level}"].items():
                print(f"L{level} {cls:<11s} AP {v['AP']:.4f} "
                      f"APH {v['APH']:.4f}")
            print(f"L{level} mAP {result[f'mAP_L{level}']:.4f} "
                  f"mAPH {result[f'mAPH_L{level}']:.4f}")
    return result
