"""RoI head box math: decoding the refinement into world boxes.

Port of the eval half of `pillarnet_lts_tpu/models/roi_heads/
roi_head_template.py` (`limit_period`, `rotate_points_along_z`,
`generate_predicted_boxes`). The training half (`canonicalize_roi_targets`,
the RCNN losses) and `proposal_target_layer` are not ported yet.
"""

import math

import torch


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
