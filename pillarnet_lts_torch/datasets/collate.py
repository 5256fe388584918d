"""Batch collation with static shapes.

Port of `pillarnet_lts_tpu/parallel/collate.py::collate_batch`: clouds are
padded into one (B, N, C) buffer with a validity mask (N = `max_points`,
or the next bucket above the largest cloud), double-flip groups (lists of
4 examples from `Reformat(double_flip=True)`) are flattened, and the
per-task targets are stacked. One layout change: the heatmap targets come
out (B, C, H, W) per task, the layout of the port's head maps, so the loss
reads them without a transpose.
"""

import numpy as np

_TARGET_LIST_KEYS = ("hm", "anno_box", "ind", "mask", "cat", "gt_box")
_STACK_KEYS = ("gt_boxes_and_cls",)


def bucket_size(n):
    """The smallest of 2048, 3072, 4608, ... (x1.5, truncated) that holds
    n points: few distinct shapes when `max_points` is not set."""
    b = 2048
    while b < n:
        b = int(b * 1.5)
    return b


def collate_batch(batch_list, max_points=None):
    """Example dicts -> numpy batch: 'points' (B, N, C) f32, 'points_mask'
    (B, N) bool (points past N are dropped), per-task stacked targets
    ('hm' as (B, C, H, W)), 'gt_boxes_and_cls' and 'metadata'."""
    flat = []
    for ex in batch_list:
        flat.extend(ex if isinstance(ex, list) else [ex])
    batch_list = flat

    clouds = [np.asarray(ex["points"]) for ex in batch_list]
    if max_points is None:
        max_points = bucket_size(max(p.shape[0] for p in clouds))
    B = len(batch_list)
    points = np.zeros((B, max_points, clouds[0].shape[1]), np.float32)
    mask = np.zeros((B, max_points), bool)
    for i, p in enumerate(clouds):
        n = min(p.shape[0], max_points)
        points[i, :n] = p[:n]
        mask[i, :n] = True
    out = {"points": points, "points_mask": mask}

    first = batch_list[0]
    for key in _TARGET_LIST_KEYS:
        if key in first:
            out[key] = [np.stack([np.asarray(ex[key][t]) for ex in batch_list])
                        for t in range(len(first[key]))]
    if "hm" in out:
        out["hm"] = [np.ascontiguousarray(h.transpose(0, 3, 1, 2))
                     for h in out["hm"]]
    for key in _STACK_KEYS:
        if key in first:
            out[key] = np.stack([np.asarray(ex[key]) for ex in batch_list])
    out["metadata"] = [ex.get("metadata") for ex in batch_list]
    return out
