"""Center-distance AP of the demo set (the port's copy of the JAX
package's `datasets/eval_metric.py`).

Predictions, in descending score, greedily take the nearest free ground
truth within a centre-distance threshold, per class; AP is the area under
the precision envelope over recall (trapezoid); the thresholds are the
nuScenes ones.
"""

import numpy as np


def _ap_single(pred_boxes, pred_scores, gt_boxes, thresh):
    """pred (N, >=2 xy), scores (N,), gt (M, >=2 xy) -> AP at distance
    thresh."""
    n_gt = len(gt_boxes)
    if n_gt == 0:
        return np.nan
    order = np.argsort(-pred_scores)
    pred_boxes = pred_boxes[order]
    taken = np.zeros(n_gt, bool)
    tp = np.zeros(len(pred_boxes))
    fp = np.zeros(len(pred_boxes))
    for i, p in enumerate(pred_boxes):
        d = np.linalg.norm(gt_boxes[:, :2] - p[:2], axis=1)
        d[taken] = np.inf
        j = int(np.argmin(d))
        if d[j] <= thresh:
            taken[j] = True
            tp[i] = 1
            continue
        fp[i] = 1
    tp_c = np.cumsum(tp)
    fp_c = np.cumsum(fp)
    recall = tp_c / n_gt
    precision = tp_c / np.maximum(tp_c + fp_c, 1e-9)
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    if len(recall) == 0:
        return 0.0
    return float(np.trapezoid(np.concatenate([[precision[0]], precision]),
                              np.concatenate([[0.0], recall])))


def center_distance_map(detections, gts, class_names,
                        thresholds=(0.5, 1.0, 2.0, 4.0)):
    """detections / gts: {token: {box3d_lidar (N, >=2), scores,
    label_preds (0-based)}}. Returns {'per_class': {name: AP}, 'mAP'}."""
    per_class = {}
    for cls_id, name in enumerate(class_names):
        aps = []
        for t in thresholds:
            pb, ps, gb = [], [], []
            for token, det in detections.items():
                gt = gts.get(token)
                if gt is None:
                    continue
                dm = np.asarray(det["label_preds"]) == cls_id
                gm = np.asarray(gt["label_preds"]) == cls_id
                pb.append(np.asarray(det["box3d_lidar"])[dm])
                ps.append(np.asarray(det["scores"])[dm])
                gb.append(np.asarray(gt["box3d_lidar"])[gm])
            if not pb:
                continue
            # one pool over all frames, each frame's x moved 10 km from the
            # last so that no prediction meets another frame's ground truth
            pb2, gb2 = [], []
            for k, (p, g) in enumerate(zip(pb, gb)):
                p, g = p.copy(), g.copy()
                if p.size:
                    p[:, 0] += 10000.0 * k
                if g.size:
                    g[:, 0] += 10000.0 * k
                pb2.append(p)
                gb2.append(g)
            ap = _ap_single(np.concatenate(pb2), np.concatenate(ps),
                            np.concatenate(gb2), t)
            if not np.isnan(ap):
                aps.append(ap)
        if aps:
            per_class[name] = float(np.mean(aps))
    mean_ap = float(np.mean(list(per_class.values()))) if per_class else 0.0
    return {"per_class": per_class, "mAP": mean_ap}
