"""CenterNet detection losses on NCHW head maps.

Port of `pillarnet_lts_tpu/models/losses/centernet_loss.py`:

- `fast_focal_loss`: the penalty-reduced focal loss (CornerNet form);
- `reg_loss`: masked L1 at the object centres, per box dimension;
- `iou_loss`: the IoU-aware confidence loss, target 2 * IoU(pred, gt) - 1
  with the rotated aligned 3D IoU (`ops/iou3d.py::boxes_aligned_iou3d`);
- `iou_reg_loss`: 1 - IoU / GIoU / DIoU of axis-aligned 3D boxes.

The JAX package gathers from NHWC maps flattened to (B, H*W, C); the
port's maps are NCHW, so `gather_feat` reads (B, C, H*W) at the same flat
index y * W + x. One deviation: the focal loss of a task with no object
in the batch is -neg_loss with a finite gradient, as in the reference
(`centernet_loss.py:34-63`, its early return); the JAX package's branchless
`where` also divides by the zero count there, and its gradient is NaN.

Under a data-parallel process group each loss is this rank's share of the
loss of the global batch: its own numerator over the global count (the
object count, summed over the ranks by `parallel.dist.sum_over_ranks`),
so the losses summed over the ranks are the global batch's. The focal
loss's no-object branch tests the global count.
"""

import torch

from ...ops.iou3d import boxes_aligned_iou3d
from ...parallel.dist import sum_over_ranks


def gather_feat(feat, ind):
    """(B, C, H, W) map + (B, M) flat indices y * W + x -> (B, M, C)."""
    B, C = feat.shape[:2]
    idx = ind.long()[:, None, :].expand(B, C, ind.shape[1])
    return feat.reshape(B, C, -1).gather(2, idx).transpose(1, 2)


def fast_focal_loss(out, target, ind, mask, cat):
    """out: (B, C, H, W) sigmoid heatmap, clamped; target: (B, C, H, W)
    gaussian target; ind, mask, cat: (B, M) peak indices, validity and
    class ids."""
    maskf = mask.float()
    neg = (1.0 - target).square()
    neg_loss = (torch.log(1.0 - out) * out.square() * neg.square()).sum()
    pos_pred = gather_feat(out, ind).gather(2, cat.long()[..., None])
    num_pos = sum_over_ranks(maskf.sum())
    pos_loss = (torch.log(pos_pred) * (1.0 - pos_pred).square()
                * maskf[..., None]).sum()
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / num_pos.clamp_min(1.0))


def reg_loss(output, mask, ind, target):
    """Masked L1 of (B, D, H, W) predictions at `ind` against (B, M, D)
    targets; returns the per-dimension loss vector (D,)."""
    pred = gather_feat(output, ind)
    maskf = mask.float()[..., None]
    loss = (pred * maskf - target * maskf).abs()
    loss = loss / (sum_over_ranks(maskf.sum()) + 1e-4)
    return loss.sum(dim=(0, 1))


def iou_loss(iou_pred, mask, ind, box_pred, box_gt):
    """IoU-aware confidence loss: (B, 1, H, W) predictions against
    2 * IoU(box_pred at ind, box_gt) - 1; box_pred (B, 7, H, W) decoded
    boxes (no gradient), box_gt (B, M, 7)."""
    maskf = mask.float()
    pred = gather_feat(iou_pred, ind)[..., 0]
    pred_box = gather_feat(box_pred, ind)
    target = 2.0 * boxes_aligned_iou3d(pred_box, box_gt) - 1.0
    loss = ((pred - target).abs() * maskf).sum()
    return loss / (sum_over_ranks(maskf.sum()) + 1e-4)


def _corners2d(box):
    """The low and high BEV corners (..., 2) of axis-aligned boxes, the
    corners 0 and 2 of `center_utils.py:123-128`."""
    center, dim = box[..., :2], box[..., 3:5]
    return dim * -0.5 + center, dim * 0.5 + center


def _overlap_terms(pred, gt):
    q_lo, q_hi = _corners2d(pred)
    g_lo, g_hi = _corners2d(gt)
    inter_max = torch.minimum(q_hi, g_hi)
    inter_min = torch.maximum(q_lo, g_lo)
    out_max = torch.maximum(q_hi, g_hi)
    out_min = torch.minimum(q_lo, g_lo)

    vol_p = pred[..., 3] * pred[..., 4] * pred[..., 5]
    vol_g = gt[..., 3] * gt[..., 4] * gt[..., 5]
    top_g = gt[..., 2] + 0.5 * gt[..., 5]
    top_p = pred[..., 2] + 0.5 * pred[..., 5]
    bot_g = gt[..., 2] - 0.5 * gt[..., 5]
    bot_p = pred[..., 2] - 0.5 * pred[..., 5]
    inter_h = (torch.minimum(top_g, top_p)
               - torch.maximum(bot_g, bot_p)).clamp_min(0.0)
    inter = (inter_max - inter_min).clamp_min(0.0)
    vol_inter = inter[..., 0] * inter[..., 1] * inter_h
    vol_union = vol_g + vol_p - vol_inter
    outer_h = (torch.maximum(top_g, top_p)
               - torch.minimum(bot_g, bot_p)).clamp_min(0.0)
    outer = (out_max - out_min).clamp_min(0.0)
    return vol_inter, vol_union, outer, outer_h


def _nonzero(v):
    return torch.where(v == 0, 1e-6, v)


def bbox3d_overlaps_iou(pred, gt):
    vol_inter, vol_union, _, _ = _overlap_terms(pred, gt)
    return (vol_inter / _nonzero(vol_union)).clamp(0.0, 1.0)


def bbox3d_overlaps_giou(pred, gt):
    vol_inter, vol_union, outer, outer_h = _overlap_terms(pred, gt)
    closure = outer[..., 0] * outer[..., 1] * outer_h
    gious = (vol_inter / _nonzero(vol_union)
             - (closure - vol_union) / _nonzero(closure))
    return gious.clamp(-1.0, 1.0)


def bbox3d_overlaps_diou(pred, gt):
    vol_inter, vol_union, outer, outer_h = _overlap_terms(pred, gt)
    inter_diag = (gt[..., 0:3] - pred[..., 0:3]).square().sum(-1)
    outer_diag = (outer[..., 0].square() + outer[..., 1].square()
                  + outer_h.square())
    dious = (vol_inter / _nonzero(vol_union)
             - inter_diag / _nonzero(outer_diag))
    return dious.clamp(-1.0, 1.0)


_IOU_FUNCS = {
    "IoU": bbox3d_overlaps_iou,
    "GIoU": bbox3d_overlaps_giou,
    "DIoU": bbox3d_overlaps_diou,
}


def iou_reg_loss(box_pred, mask, ind, box_gt, kind="IoU"):
    """(1 - IoU variant) of (B, 7, H, W) decoded boxes at `ind` against
    (B, M, 7) ground truth, averaged over the objects."""
    maskf = mask.float()
    iou = _IOU_FUNCS[kind](gather_feat(box_pred, ind), box_gt)
    return (((1.0 - iou) * maskf).sum()
            / (sum_over_ranks(maskf.sum()) + 1e-4))
