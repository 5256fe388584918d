"""The comparison that decides `correct`: served detections against the
plain reference's.

For every detection the system served, the reference's location whose
decoded box lies closest names the location that produced it; the
distance is the largest absolute difference over the box's fields (the
yaw taken modulo 2 pi), the served score against the reference's score of
the served label there, and how far that score lies below the reference's
best class there (so that a label is judged by its score, as a served
token by its logit). `det_gap` is the largest such distance over the
sample.
`kept_mismatch` compares the kept locations of each task: the share of
locations kept on one side only, over those kept on either.
"""

import math

import numpy as np
import torch


def _yaw_gap(a, b):
    d = torch.remainder(a - b + math.pi, 2 * math.pi) - math.pi
    return d.abs()


def frame_readings(served, ref_frame, class_offsets):
    """One frame. served: the system's host detections of the frame
    (numpy box3d_lidar (K, D), scores, label_preds, mask); ref_frame:
    per task (boxes (L, D), scores (L,), labels (L,), kept (k,), class
    scores (L, C)) from `Reference.detect`. -> (largest gap, locations kept on one side only,
    locations kept on either)."""
    dev = ref_frame[0][0].device
    mask = np.asarray(served["mask"]).astype(bool)
    boxes = torch.from_numpy(np.asarray(served["box3d_lidar"])[mask]).to(
        dev, torch.float64)
    scores = torch.from_numpy(np.asarray(served["scores"])[mask]).to(
        dev, torch.float64)
    labels = torch.from_numpy(np.asarray(served["label_preds"])[mask]).to(
        dev, torch.int64)
    bounds = list(class_offsets) + [1 << 30]
    gap, only_one, either = 0.0, 0, 0
    for t, (rb, rs, rl, kept, rc) in enumerate(ref_frame):
        sel = (labels >= bounds[t]) & (labels < bounds[t + 1])
        got = set()
        if sel.any():
            pb, ps = boxes[sel], scores[sel]
            pc = (labels[sel] - bounds[t])
            rc = rc.double()
            # (P, L): the reference's score of each served label, and how
            # far it lies below the reference's best class there
            r_score = rc[:, pc].T
            below = rs.double()[None] - r_score
            d = (pb[:, None, :-1] - rb[None, :, :-1].double()).abs().amax(-1)
            d = torch.maximum(d, (ps[:, None] - r_score).abs())
            d = torch.maximum(d, below)
            best, loc = d.min(1)
            yaw = _yaw_gap(pb[:, -1], rb[loc, -1].double())
            gap = max(gap, float(torch.maximum(best, yaw).max()))
            got = set(loc.tolist())
        ref = set(kept.tolist())
        only_one += len(got ^ ref)
        either += len(got | ref)
    return gap, only_one, either


def readings(served_frames, ref_frames, class_offsets):
    """The sample's numbers: {'det_gap': ..., 'kept_mismatch': ...}."""
    gap, only_one, either = 0.0, 0, 0
    for served, ref in zip(served_frames, ref_frames):
        g, o, e = frame_readings(served, ref, class_offsets)
        gap, only_one, either = max(gap, g), only_one + o, either + e
    return {"det_gap": gap, "kept_mismatch": only_one / max(either, 1)}


def split_frames(det):
    """A batched host detection dict -> one dict per frame."""
    n = len(det["mask"])
    return [{k: v[i] for k, v in det.items()} for i in range(n)]
