"""Batch collation with static shapes, and the training data loader.

Port of `pillarnet_lts_tpu/parallel/collate.py::collate_batch`: clouds are
padded into one (B, max_points, C) buffer with a validity mask, and the
per-task targets are stacked. One layout change: the heatmap targets come
out (B, C, H, W) per task, the layout of the port's head maps, so the loss
reads them without a transpose. `DataLoader` is a plain synchronous
loader (the JAX package's threads overlapped its compile-heavy host; the
port's scenes are made in tens of milliseconds).
"""

import numpy as np

_TARGET_LIST_KEYS = ("hm", "anno_box", "ind", "mask", "cat", "gt_box")
_STACK_KEYS = ("gt_boxes_and_cls",)


def collate_batch(batch_list, max_points):
    """Example dicts -> numpy batch: 'points' (B, max_points, C) f32,
    'points_mask' (B, max_points) bool (points past max_points are
    dropped), per-task stacked targets ('hm' as (B, C, H, W)),
    'gt_boxes_and_cls' and 'metadata'."""
    B = len(batch_list)
    num_feats = np.asarray(batch_list[0]["points"]).shape[1]
    points = np.zeros((B, max_points, num_feats), np.float32)
    mask = np.zeros((B, max_points), bool)
    for i, ex in enumerate(batch_list):
        p = np.asarray(ex["points"])
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


class DataLoader:
    """Batches of `dataset` (indexable, with a length), collated to
    `max_points`, in an order shuffled per epoch from the epoch number
    (`set_epoch`); a last short batch is dropped."""

    def __init__(self, dataset, batch_size, max_points):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_points = max_points
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        np.random.RandomState(self.epoch).shuffle(idx)
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield collate_batch([self.dataset[int(i)] for i in sel],
                                self.max_points)
