"""Legacy detector classes kept for the config zoo.

Port of `pillarnet_lts_tpu/models/detectors/legacy.py`:

- `VoxelNet`: the generic reader -> backbone -> neck -> head single-stage
  detector, which in this framework is `PillarNet`; a registered alias.
- `TwoStageDetector`: the CenterPoint-era two-stage detector whose second
  stage bilinear-samples the neck's last map at box centres
  (`num_point` 1: the centre; 5: the centre and the four edge midpoints,
  `box_center_points`) through `BEVFeatureExtractor`, in place of Pillar
  R-CNN's RoI grid. A `PillarRCNN` that overrides only the pooling: the
  RoIs, the RoI head, the decoding and `post_process`'s
  sqrt(sigmoid(cls) * roi_score) are Pillar R-CNN's, as in the JAX
  package. It has no point head, and `point_coords` is None.

`use_final_feature` (pooling from the head's shared-conv map) and a point
head raise at construction, where the JAX package raises.
"""

import torch

from .pillar_rcnn import PillarRCNN
from .pillarnet import PillarNet
from .. import builder
from ..registry import DETECTORS


@DETECTORS.register_module
class VoxelNet(PillarNet):
    """The generic single-stage detector; `PillarNet`'s flow."""


def box_center_points(rois, num_point):
    """Query points of box-centre BEV pooling.

    rois: (B, K, C) [x, y, z, w, l, h, yaw, ...] (yaw at slot 6). Returns
    (B, num_point * K, 2): the centres, then (num_point 5) the midpoints
    of the front, back, left and right edges, each section K long: the
    edge offsets (-+w/2, 0) and (0, -+l/2) in the box frame, turned as
    `rotation_2d` turns (x' = ox c + oy s, y' = -ox s + oy c) and moved
    to the centre."""
    centers = rois[..., :2]
    if num_point == 1:
        return centers
    if num_point != 5:
        raise NotImplementedError(f"num_point={num_point} (1 or 5)")
    w = rois[..., 3:4]
    l = rois[..., 4:5]
    rot = rois[..., 6]
    c, s = torch.cos(rot), torch.sin(rot)
    zeros = torch.zeros_like(w)
    offs = [torch.cat([-w / 2, zeros], -1), torch.cat([w / 2, zeros], -1),
            torch.cat([zeros, -l / 2], -1), torch.cat([zeros, l / 2], -1)]
    pts = [centers]
    for o in offs:
        rx = o[..., 0] * c + o[..., 1] * s
        ry = -o[..., 0] * s + o[..., 1] * c
        pts.append(centers + torch.stack([rx, ry], dim=-1))
    return torch.cat(pts, dim=1)


@DETECTORS.register_module
class TwoStageDetector(PillarRCNN):
    """Box-centre pooling two-stage detector (reference
    `two_stage.py:10-194`). Its second-stage modules take no backbone
    geometry."""

    def __init__(self, first_stage_cfg, second_stage_modules=(),
                 roi_head=None, point_head=None, num_point=1, freeze=False,
                 use_final_feature=False, train_cfg=None, test_cfg=None,
                 pretrained=None, dtype=torch.float32, device=None):
        if use_final_feature:
            raise NotImplementedError(
                "use_final_feature is unused by every reference config")
        if point_head is not None:
            raise NotImplementedError(
                "point_head is unused with the legacy TwoStageDetector")
        super().__init__(first_stage_cfg, second_stage_modules, roi_head,
                         None, num_point, freeze, False, train_cfg,
                         test_cfg, pretrained, dtype, device)

    def _second_stage_module(self, cfg, device):
        return builder.build_second_stage_module(cfg, device=device)

    def _pool(self, bev, feats, rois):
        centers = box_center_points(rois, self.num_point)
        roi_feats = None
        for k in range(self.num_second_stage):
            roi_feats = getattr(self, f"second_stage_{k}")(bev[-1], centers)
        return roi_feats, None, None
