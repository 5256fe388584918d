"""Native nuScenes detection-metric evaluator (devkit-free mAP / NDS).

The reference computes final nuScenes metrics by shelling into the
nuscenes-devkit (`det3d/datasets/nuscenes/nuscenes.py:287-327`,
`NuScenesEval`), which drags in the full devkit + raw table set at eval
time.  This module re-implements the official *detection_cvpr_2019*
protocol (Caesar et al., "nuScenes: A multimodal dataset for autonomous
driving", CVPR 2020, §4.1; algorithmic behavior mirrored from the public
devkit's eval/detection) directly on our info pkls and detector output —
pure numpy, no external dependency, so `tools/dist_test.py` produces
mAP/NDS even where the devkit cannot be installed.

This is the port's copy of `pillarnet_lts_tpu/datasets/nuscenes/
nusc_eval.py`, line for line (f64 numpy), so that the two give the same
numbers bit for bit; `pillarnet_lts_torch.tools.dist_test` reaches it.

Protocol summary:
  * per-class, per-threshold matching by 2D center distance
    (thresholds 0.5/1/2/4 m), predictions sorted by score across the whole
    split, greedy nearest-unmatched-GT assignment;
  * AP = normalized area of the 101-point interpolated precision curve
    above (recall > 0.1, precision > 0.1); mAP = mean over classes x
    thresholds;
  * TP metrics at the 2 m threshold: ATE (center distance), ASE (1 - IoU of
    aligned boxes), AOE (yaw difference; period pi for barriers), AVE
    (velocity L2), AAE (attribute mismatch); cones skip AOE/AVE/AAE,
    barriers skip AVE/AAE;
  * NDS = (5 * mAP + sum_m (1 - min(1, mTP_m))) / 10.

Known deviations from the devkit (documented, both second-order):
  * evaluation runs in the lidar frame (center distances, yaw deltas and
    velocity deltas are invariant under the rigid lidar->global transform;
    the class-range filter measures distance to the lidar origin instead of
    the ego center — a <=1 m difference at the range boundary);
  * the devkit's map-based "bikes in bike-rack" GT removal needs raw map
    tables and is skipped.
"""

from typing import Dict, List

import numpy as np

__all__ = [
    "DETECTION_CVPR_2019",
    "accumulate",
    "calc_ap",
    "calc_tp",
    "evaluate_nusc",
    "gt_from_infos",
    "preds_from_detections",
]


DETECTION_CVPR_2019 = {
    "class_range": {
        "car": 50, "truck": 50, "bus": 50, "trailer": 50,
        "construction_vehicle": 50, "pedestrian": 40, "motorcycle": 40,
        "bicycle": 40, "traffic_cone": 30, "barrier": 30,
    },
    "dist_ths": [0.5, 1.0, 2.0, 4.0],
    "dist_th_tp": 2.0,
    "min_recall": 0.1,
    "min_precision": 0.1,
    "max_boxes_per_sample": 500,
    "mean_ap_weight": 5,
}

TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")
# classes for which a TP metric is undefined in the official protocol
_TP_EXCLUDE = {
    "traffic_cone": {"orient_err", "vel_err", "attr_err"},
    "barrier": {"vel_err", "attr_err"},
}
_N_INTERP = 101


# ---------------------------------------------------------------------------
# box containers (plain dicts)
# ---------------------------------------------------------------------------


def _box(translation, size, yaw, velocity, name, score=None, attribute=""):
    return {
        "translation": np.asarray(translation, np.float64),
        "size": np.asarray(size, np.float64),          # (w, l, h)
        "yaw": float(yaw),
        "velocity": np.asarray(velocity, np.float64),  # (vx, vy)
        "name": str(name),
        "score": None if score is None else float(score),
        "attribute": attribute or "",
    }


def gt_from_infos(infos) -> Dict[str, List[dict]]:
    """Info pkl records -> eval GT (lidar frame).

    Infos store det3d 9-dim boxes [x y z w l h vx vy r] with
    r = -yaw - pi/2 (`nusc_common.py` info creation); invert to nusc yaw.
    The optional `gt_attributes` field (written by our info creation when
    available) feeds AAE; absent attributes evaluate as the official
    "no attribute" case.
    """
    out = {}
    for info in infos:
        boxes = np.asarray(info["gt_boxes"], np.float64).reshape(-1, 9)
        names = list(info["gt_names"])
        attrs = list(info.get("gt_attributes", [""] * len(names)))
        out[info["token"]] = [
            _box(
                translation=b[:3], size=b[3:6], yaw=-b[8] - np.pi / 2,
                velocity=b[6:8], name=n, attribute=a,
            )
            for b, n, a in zip(boxes, names, attrs)
        ]
    return out


def preds_from_detections(detections, class_names) -> Dict[str, List[dict]]:
    """Detector output (`box3d_lidar`/`scores`/`label_preds` per token,
    the dist_test accumulation format) -> eval predictions (lidar frame)."""
    out = {}
    for token, det in detections.items():
        box3d = np.asarray(det["box3d_lidar"], np.float64)
        scores = np.asarray(det["scores"], np.float64)
        labels = np.asarray(det["label_preds"], np.int64)
        rows = []
        for i in range(box3d.shape[0]):
            vel = box3d[i, 6:8] if box3d.shape[1] == 9 else np.zeros(2)
            rows.append(_box(
                translation=box3d[i, :3], size=box3d[i, 3:6],
                yaw=-box3d[i, -1] - np.pi / 2, velocity=vel,
                name=class_names[int(labels[i])], score=scores[i],
            ))
        out[token] = rows
    return out


# ---------------------------------------------------------------------------
# pairwise metrics
# ---------------------------------------------------------------------------


def _center_distance(a, b) -> float:
    return float(np.linalg.norm(a["translation"][:2] - b["translation"][:2]))


def _scale_iou(gt, pred) -> float:
    """IoU of the two boxes after aligning center and yaw."""
    mins = np.minimum(gt["size"], pred["size"])
    inter = float(np.prod(mins))
    union = float(np.prod(gt["size"])) + float(np.prod(pred["size"])) - inter
    return inter / union if union > 0 else 0.0


def _yaw_diff(gt, pred, period) -> float:
    d = (gt["yaw"] - pred["yaw"]) % period
    return float(min(d, period - d))


def _vel_l2(gt, pred) -> float:
    return float(np.linalg.norm(gt["velocity"][:2] - pred["velocity"][:2]))


def _attr_err(gt, pred) -> float:
    if not gt["attribute"]:
        return np.nan  # official: no GT attribute -> nan, nan-ignored later
    return float(gt["attribute"] != pred["attribute"])


def _cummean(x: np.ndarray) -> np.ndarray:
    """nan-aware cumulative mean (official cummean semantics): all-nan
    input yields ones."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    sums = np.nancumsum(x)
    counts = np.cumsum(~np.isnan(x)).astype(np.float64)
    return np.divide(sums, counts, out=np.zeros_like(sums),
                     where=counts != 0)


# ---------------------------------------------------------------------------
# core accumulation
# ---------------------------------------------------------------------------


def accumulate(gt_by_token, pred_by_token, class_name, dist_th, dist_th_tp):
    """Precision/recall + TP-error curves for one (class, threshold).

    Returns a dict with 101-point interpolated `precision`, `confidence`
    and (when dist_th == dist_th_tp) the five TP error curves, plus `npos`.
    """
    npos = sum(
        sum(1 for g in gts if g["name"] == class_name)
        for gts in gt_by_token.values()
    )
    curves = {
        "precision": np.zeros(_N_INTERP),
        "confidence": np.zeros(_N_INTERP),
        "npos": npos,
    }
    for m in TP_METRICS:
        curves[m] = np.ones(_N_INTERP)
    if npos == 0:
        return curves

    preds = [
        (token, p)
        for token, rows in pred_by_token.items()
        for p in rows if p["name"] == class_name
    ]
    preds.sort(key=lambda tp_: -tp_[1]["score"])
    if not preds:
        return curves

    taken = set()  # (token, gt index) pairs already matched
    tp, fp, conf = [], [], []
    match = {m: [] for m in TP_METRICS}
    match_conf = []
    period = np.pi if class_name == "barrier" else 2 * np.pi

    for token, pred in preds:
        gts = gt_by_token.get(token, ())
        best, best_d = None, np.inf
        for gi, gt in enumerate(gts):
            if gt["name"] != class_name or (token, gi) in taken:
                continue
            d = _center_distance(gt, pred)
            if d < best_d:
                best, best_d = gi, d
        if best is not None and best_d < dist_th:
            taken.add((token, best))
            tp.append(1); fp.append(0)
            gt = gts[best]
            match["trans_err"].append(best_d)
            match["scale_err"].append(1.0 - _scale_iou(gt, pred))
            match["orient_err"].append(_yaw_diff(gt, pred, period))
            match["vel_err"].append(_vel_l2(gt, pred))
            match["attr_err"].append(_attr_err(gt, pred))
            match_conf.append(pred["score"])
        else:
            tp.append(0); fp.append(1)
        conf.append(pred["score"])

    tp = np.cumsum(tp).astype(np.float64)
    fp = np.cumsum(fp).astype(np.float64)
    prec = tp / (tp + fp)
    rec = tp / npos

    rec_interp = np.linspace(0, 1, _N_INTERP)
    curves["precision"] = np.interp(rec_interp, rec, prec, right=0)
    curves["confidence"] = np.interp(rec_interp, rec, np.asarray(conf),
                                     right=0)
    if dist_th == dist_th_tp and match_conf:
        for m in TP_METRICS:
            cm = _cummean(np.asarray(match[m], np.float64))
            # errors are indexed by confidence: interpolate the cumulative
            # mean error onto the confidence value at each recall point
            curves[m] = np.interp(
                curves["confidence"], np.asarray(match_conf)[::-1],
                cm[::-1])
    return curves


def calc_ap(curves, min_recall, min_precision) -> float:
    """Normalized AP over the operating region (official calc_ap)."""
    prec = curves["precision"].copy()
    prec = prec[round(100 * min_recall) + 1:]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - min_precision)


def calc_tp(curves, metric, min_recall) -> float:
    """Mean TP error over the achieved-recall region (official calc_tp)."""
    first = round(100 * min_recall) + 1
    nz = np.nonzero(curves["confidence"])[0]
    last = int(nz[-1]) if len(nz) else 0
    if last < first:
        return 1.0
    return float(np.mean(curves[metric][first:last + 1]))


# ---------------------------------------------------------------------------
# filtering + top-level evaluation
# ---------------------------------------------------------------------------


def _filter_boxes(by_token, class_range, max_per_sample=None):
    out = {}
    for token, rows in by_token.items():
        kept = [
            b for b in rows
            if b["name"] in class_range
            and np.linalg.norm(b["translation"][:2])
            <= class_range[b["name"]]
        ]
        if max_per_sample is not None and len(kept) > max_per_sample:
            kept = sorted(kept, key=lambda b: -b["score"])[:max_per_sample]
        out[token] = kept
    return out


def evaluate_nusc(gt_by_token, pred_by_token, cfg=None, verbose=False):
    """Full detection evaluation -> metrics dict.

    Args:
      gt_by_token / pred_by_token: {sample_token: [box dicts]} in a common
        rigid frame (see `gt_from_infos` / `preds_from_detections`).
      cfg: protocol config; defaults to detection_cvpr_2019.

    Returns dict with `mean_ap`, `nd_score`, `label_aps` (class ->
    {dist_th: ap}), `label_tp_errors` (class -> {metric: err}) and
    `tp_errors` (metric -> mean over defined classes) — the same quantities
    the devkit's DetectionMetrics carries.
    """
    cfg = dict(DETECTION_CVPR_2019, **(cfg or {}))
    class_range = cfg["class_range"]
    gt = _filter_boxes(gt_by_token, class_range)
    # evaluate only tokens with GT (official: eval set defines the tokens)
    pred = _filter_boxes(
        {t: pred_by_token.get(t, []) for t in gt},
        class_range, cfg["max_boxes_per_sample"])

    label_aps, label_tp = {}, {}
    for cls in class_range:
        npos = sum(sum(1 for g in rows if g["name"] == cls)
                   for rows in gt.values())
        aps = {}
        tp_curves = None
        for dist_th in cfg["dist_ths"]:
            curves = accumulate(gt, pred, cls, dist_th, cfg["dist_th_tp"])
            aps[dist_th] = calc_ap(curves, cfg["min_recall"],
                                   cfg["min_precision"])
            if dist_th == cfg["dist_th_tp"]:
                tp_curves = curves
        if npos == 0:
            continue  # class absent from this split: excluded from means
        label_aps[cls] = aps
        label_tp[cls] = {
            m: calc_tp(tp_curves, m, cfg["min_recall"])
            for m in TP_METRICS if m not in _TP_EXCLUDE.get(cls, ())
        }

    mean_ap = float(np.mean([
        ap for aps in label_aps.values() for ap in aps.values()
    ])) if label_aps else 0.0
    tp_errors = {}
    for m in TP_METRICS:
        vals = [errs[m] for errs in label_tp.values() if m in errs]
        tp_errors[m] = float(np.mean(vals)) if vals else np.nan

    total = cfg["mean_ap_weight"] * mean_ap
    for m in TP_METRICS:
        e = tp_errors[m]
        total += 0.0 if np.isnan(e) else 1.0 - min(1.0, e)
    nd_score = total / (cfg["mean_ap_weight"] + len(TP_METRICS))

    metrics = {
        "mean_ap": mean_ap,
        "nd_score": float(nd_score),
        "label_aps": label_aps,
        "label_tp_errors": label_tp,
        "tp_errors": tp_errors,
    }
    if verbose:
        print(f"NDS {nd_score:.4f}  mAP {mean_ap:.4f}")
        for cls, aps in label_aps.items():
            line = " ".join(f"{th}:{ap:.3f}" for th, ap in aps.items())
            print(f"  {cls:<22s} {line}")
        for m, e in tp_errors.items():
            print(f"  m{m}: {e:.4f}")
    return metrics
