"""RoI head box math: the canonical RoI targets, the RCNN losses, and
decoding the refinement into world boxes.

Port of `pillarnet_lts_tpu/models/roi_heads/roi_head_template.py`
(`limit_period`, `rotate_points_along_z`, `canonicalize_roi_targets`,
`box_cls_layer_loss`, `box_reg_layer_loss`, `box_iou_layer_loss`,
`generate_predicted_boxes`). Each loss divides by its count summed over
the ranks of a data-parallel group, the JAX mesh's global batch.
"""

import math

import torch

from ...core.utils import device_constant
from ...ops.iou3d import boxes_aligned_iou3d
from ...parallel.dist import sum_over_ranks


def limit_period(val, offset=0.5, period=math.pi):
    return val - torch.floor(val / period + offset) * period


def rotate_points_along_z(points, angle):
    """points (..., N, 3+C), angle (...,): rotate x, y by the angle
    (points @ [[c, -s, 0], [s, c, 0], [0, 0, 1]], the reference's
    `box_torch_ops.rotate_points_along_z`)."""
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    xr = points[..., 0:1] * c + points[..., 1:2] * s
    yr = points[..., 0:1] * (-s) + points[..., 1:2] * c
    return torch.cat([xr, yr, points[..., 2:]], dim=-1)


def canonicalize_roi_targets(targets):
    """The regression targets in each RoI's frame: the GT box minus its
    RoI (centre, dims, yaw), turned by minus the RoI's yaw, the heading
    flipped by pi when it points backwards and clipped to [-pi/2, pi/2].

    targets: `RoiTargets` (raw `gt_of_rois`); the RoI width (7, or 9 with
    velocity) decides the code. Returns the dict of the JAX package's
    (`rois`, `gt_of_rois` canonical, `gt_of_rois_src` raw, and the
    sampler's other fields)."""
    rois = targets.rois
    src = targets.gt_of_rois
    roi_ry = limit_period(rois[..., 6], offset=0.5, period=2 * math.pi)
    gt = torch.cat([src[..., :6] - rois[..., :6],
                    src[..., 6:7] - roi_ry[..., None], src[..., 7:]], dim=-1)
    B, M = gt.shape[:2]
    gt = rotate_points_along_z(gt.reshape(B * M, 1, -1),
                               -roi_ry.reshape(B * M)).reshape(B, M, -1)
    if rois.shape[-1] == 9:  # relative velocity
        gt = torch.cat([gt[..., :7], gt[..., 7:-1] - rois[..., 7:],
                        gt[..., -1:]], dim=-1)

    heading = gt[..., 6] % (2 * math.pi)
    opposite = (heading > math.pi * 0.5) & (heading < math.pi * 1.5)
    heading = torch.where(opposite, (heading + math.pi) % (2 * math.pi),
                          heading)
    heading = torch.where(heading > math.pi, heading - 2 * math.pi, heading)
    heading = heading.clamp(-math.pi / 2, math.pi / 2)
    gt = torch.cat([gt[..., :6], heading[..., None], gt[..., 7:]], dim=-1)
    return {"rois": rois, "gt_of_rois": gt, "gt_of_rois_src": src,
            "gt_iou_of_rois": targets.gt_iou_of_rois,
            "roi_scores": targets.roi_scores,
            "roi_labels": targets.roi_labels,
            "reg_valid_mask": targets.reg_valid_mask,
            "rcnn_cls_labels": targets.rcnn_cls_labels}


def box_cls_layer_loss(rcnn_cls, rcnn_cls_labels, weight=1.0):
    """Binary cross entropy with soft labels, averaged over the RoIs whose
    label is not -1 (ignored; over the ranks of a data-parallel group)."""
    logits = rcnn_cls.reshape(-1)
    labels = rcnn_cls_labels.reshape(-1)
    p = torch.sigmoid(logits).clamp(1e-7, 1 - 1e-7)
    per = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    valid = (labels >= 0).to(torch.float32)
    return ((per * valid).sum()
            / sum_over_ranks(valid.sum()).clamp_min(1.0) * weight)


def box_reg_layer_loss(rcnn_reg, reg_valid_mask, gt_of_rois, code_weights,
                       weight=1.0):
    """Code-weighted L1 between the refinement and the canonical targets,
    averaged over the foreground RoIs (reg_valid_mask > 0; over the ranks
    of a data-parallel group)."""
    code_size = rcnn_reg.shape[-1]
    targets = gt_of_rois[..., :code_size].reshape(-1, code_size)
    preds = rcnn_reg.reshape(-1, code_size)
    fg = (reg_valid_mask.reshape(-1) > 0).to(torch.float32)
    cw = device_constant(list(code_weights), preds.device, preds.dtype)
    per = (preds - targets).abs() * cw
    return ((per.sum(-1) * fg).sum()
            / sum_over_ranks(fg.sum()).clamp_min(1.0) * weight)


def box_iou_layer_loss(rcnn_iou, reg_valid_mask, gt_of_rois_src,
                       batch_box_preds, weight=1.0):
    """L1 between the IoU branch and 2 * IoU3d(decoded box, its GT) - 1,
    averaged over the foreground RoIs (over the ranks of a data-parallel
    group); the decoded boxes are detached, and the background and padded
    rows (their zero boxes) are masked out by reg_valid_mask."""
    preds = batch_box_preds[..., :7].reshape(-1, 7).detach()
    gt = gt_of_rois_src[..., :7].reshape(-1, 7)
    fg = (reg_valid_mask.reshape(-1) > 0).to(torch.float32)
    iou_targets = 2.0 * boxes_aligned_iou3d(preds, gt) - 1.0
    per = (rcnn_iou.reshape(-1) - iou_targets).abs()
    return ((per * fg).sum()
            / sum_over_ranks(fg.sum()).clamp_min(1.0) * weight)


def generate_predicted_boxes(rois, cls_preds, box_preds):
    """Canonical-frame residuals -> world boxes.

    rois (B, N, C); cls_preds (B * N, k); box_preds (B * N, C) ->
    (batch_cls_preds (B, N, k), batch_box_preds (B, N, C)): each residual
    is added to its RoI with the RoI's centre zeroed, turned by the RoI's
    yaw and moved to its centre."""
    B, N, code_size = rois.shape
    batch_cls_preds = cls_preds.reshape(B, N, -1)
    batch_box_preds = box_preds.reshape(B, N, code_size)
    roi_ry = rois[..., 6].reshape(-1)
    roi_xyz = rois[..., 0:3].reshape(-1, 3)
    local_rois = torch.cat([torch.zeros_like(rois[..., 0:3]),
                            rois[..., 3:]], dim=-1)
    preds = (batch_box_preds + local_rois).reshape(B * N, code_size)
    preds = rotate_points_along_z(preds[:, None, :], roi_ry)[:, 0, :]
    preds = torch.cat([preds[:, 0:3] + roi_xyz, preds[:, 3:]], dim=-1)
    return batch_cls_preds, preds.reshape(B, N, code_size)
