"""Auxiliary per-grid-point foreground classification head.

Port of the forward of `pillarnet_lts_tpu/models/point_heads/
point_head.py::PointHead`: Dense + BN + ReLU layers (`cls_fc{k}`,
`cls_bn{k}`; the BN folded at eval) and a one-logit projection
(`cls_out`), computed in `dtype` (the grid features are cast to it, as
flax's `Dense(dtype=...)` casts its input), and its training half: the per-grid-point foreground
targets (`assign_point_targets_2d`) and the sigmoid focal loss
(`point_cls_loss`).
"""

import torch
from torch import nn

from ...parallel.dist import sum_over_ranks
from ..registry import POINT_HEAD
from ..utils.dense import Dense, dense_bn_relu
from ..utils.norm import MaskedBatchNorm


@POINT_HEAD.register_module
class PointHead(nn.Module):
    def __init__(self, in_channels, num_class, model_cfg,
                 dtype=torch.float32, device=None):
        super().__init__()
        del num_class  # one logit, as the JAX package's (class-agnostic)
        self.dtype = dtype
        self.num_layers = len(model_cfg["CLS_FC"])
        c = in_channels
        for k, ch in enumerate(model_cfg["CLS_FC"]):
            setattr(self, f"cls_fc{k}", Dense(
                c, ch, use_bias=False, init_std=(2.0 / (c + ch)) ** 0.5,
                device=device))
            setattr(self, f"cls_bn{k}", MaskedBatchNorm(ch, device=device))
            c = ch
        self.cls_out = Dense(c, 1, device=device)

    def forward(self, point_features):
        """point_features (B, R, G, C) -> logits (B, R, G, 1) in dtype."""
        x = point_features.to(self.dtype)
        for k in range(self.num_layers):
            x = dense_bn_relu(getattr(self, f"cls_fc{k}"),
                              getattr(self, f"cls_bn{k}"), x, self.training)
        return self.cls_out(x)


def assign_point_targets_2d(point_coords, gt_of_rois_src):
    """(B, R, G, 2) grid points vs (B, R, code + 1) per-RoI GT boxes ->
    (B, R, G) f32 labels: 1 where the point lies in its RoI's GT footprint
    (the rotated BEV rectangle, edges included) and the GT is not an
    all-zero padding row."""
    gt = gt_of_rois_src
    rel = point_coords - gt[..., None, 0:2]
    ang = gt[..., 6]
    c = torch.cos(ang)[..., None]
    s = torch.sin(ang)[..., None]
    lx = rel[..., 0] * c + rel[..., 1] * s
    ly = -rel[..., 0] * s + rel[..., 1] * c
    half_w = gt[..., 3][..., None] * 0.5
    half_l = gt[..., 4][..., None] * 0.5
    valid_gt = (gt[..., :6].abs().sum(-1) > 0)[..., None]
    inside = (lx.abs() <= half_w) & (ly.abs() <= half_l) & valid_gt
    return inside.to(torch.float32)


def point_cls_loss(logits, labels, weight=1.0, alpha=0.25, gamma=2.0):
    """Sigmoid focal loss over every grid point, divided by the number of
    positives (at least 1; over the ranks of a data-parallel group)."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1)
    pos_normalizer = sum_over_ranks(
        (labels > 0).sum().to(torch.float32)).clamp_min(1.0)
    p = torch.sigmoid(logits)
    alpha_w = labels * alpha + (1 - labels) * (1 - alpha)
    pt = labels * (1.0 - p) + (1 - labels) * p
    focal = alpha_w * torch.pow(pt, gamma)
    bce = (logits.clamp_min(0) - logits * labels
           + torch.log1p(torch.exp(-logits.abs())))
    return (focal * bce * (1.0 / pos_normalizer)).sum() * weight
