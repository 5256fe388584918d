"""Rotated greedy NMS with static shapes, batched over tasks and samples.

Port of `pillarnet_lts_tpu/ops/nms.py` (the rotated path). Suppression is the
fixed-sweep fixpoint of `_greedy_suppress` (batched matvecs), so the whole
NMS runs on the device with no host sync: fixed K candidates in, fixed
`post_max_size` slots out (padded, validity-masked).
"""

import torch

from .iou3d import rotated_iou_bev, to_pcdet_bev

# Number of fixpoint sweeps: exact greedy for every suppression chain of
# depth <= this (`test_cfg.nms.nms_sweeps` overrides it).
_NMS_SWEEPS = 16


def _greedy_suppress(iou, valid, thresh, sweeps=_NMS_SWEEPS):
    """Greedy suppression over score-descending boxes.

    With M[j, i] = (j < i) & (iou[j, i] > thresh), the greedy keep set is the
    fixpoint of keep_i <- valid_i & ~any_j(M[j, i] & keep_j), starting from
    keep = valid; `sweeps` iterations are exact for chains up to that depth.

    Args:
      iou: (..., K, K) pairwise IoU, rows/cols in score order (desc).
      valid: (..., K) candidate validity.
      thresh: scalar IoU threshold.
    Returns:
      keep: (..., K) bool.
    """
    k = iou.shape[-1]
    idx = torch.arange(k, device=iou.device)
    lower = idx[:, None] < idx[None, :]  # j < i: row j suppresses col i
    m = (lower & (iou > thresh)).to(torch.float32)
    keep = valid
    for _ in range(sweeps):
        suppressed = (keep.to(torch.float32)[..., None, :] @ m)[..., 0, :] > 0.0
        keep = valid & ~suppressed
    return keep


def _select_topk_sorted(keep, post_max_size):
    """First `post_max_size` kept slots (in existing order) -> (idx, mask)."""
    k = keep.shape[-1]
    ar = torch.arange(k, device=keep.device)
    rank_key = torch.where(keep, ar, k + ar)
    order = torch.argsort(rank_key, dim=-1)[..., :post_max_size]
    return order, torch.gather(keep, -1, order)


def rotated_nms(boxes, scores, valid, nms_thresh, post_max_size,
                sweeps=_NMS_SWEEPS):
    """Greedy rotated-BEV NMS over score-sorted, fixed-size candidates.

    Args:
      boxes: (..., K, 7+) det3d boxes, score-descending along K.
      scores: (..., K) matching scores (passthrough, unused).
      valid: (..., K) bool; padding / below-threshold rows are False.
      nms_thresh: BEV IoU threshold.
      post_max_size: output size.
      sweeps: fixpoint sweeps.
    Returns:
      (sel_idx, sel_mask): (..., post_max_size) indices into the K
      candidates and their validity.
    """
    del scores
    bev = to_pcdet_bev(boxes)
    iou = rotated_iou_bev(bev, bev)
    keep = _greedy_suppress(iou, valid, nms_thresh, sweeps=sweeps)
    return _select_topk_sorted(keep, post_max_size)
