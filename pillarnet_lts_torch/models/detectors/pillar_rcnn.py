"""Pillar R-CNN two-stage detector, inference.

Port of the eval branch of `pillarnet_lts_tpu/models/detectors/
pillar_rcnn.py::PillarRCNN` and its `post_process`: the first stage (a
`PillarNet`, `single_det`) predicts padded proposals (decode and NMS, on
the card without a host sync); every proposal slot, kept or padded,
becomes a RoI (a padded one is the zero box with label 0 and score 0), so
the second stage has static shapes: R = the sum of the NMS post sizes.
The second stage pools a rotated grid of BEV features per RoI
(`second_stage_0`), runs the point head (`point_head_net`; its logits are
returned, unused at eval) and the RoI head (`roi_head_net`), and decodes
the refined boxes. `post_process` rescores them as
sqrt(sigmoid(cls) * roi_score) and masks out the padded slots.

Submodule names mirror flax's (`single_det`, `second_stage_0`,
`roi_head_net`, `point_head_net`), so `runtime/convert.py` loads the JAX
package's variables tree.

Not ported yet: training (the proposal target sampling, the canonical
RoI targets, the RCNN and point losses; `forward` in training mode
raises), the bf16 and int8 two-stage configs, and `freeze` (it matters
only in training).
"""

from typing import Optional, Sequence

import torch
from torch import nn

from .. import builder
from ..registry import DETECTORS
from ..roi_heads.roi_head_template import generate_predicted_boxes
from .pillarnet import PillarNet

_TRAINING = ("Pillar R-CNN training (proposal target sampling, canonical "
             "RoI targets, the RCNN and point losses) is not ported yet; "
             "call model.eval()")


@DETECTORS.register_module
class PillarRCNN(nn.Module):
    def __init__(self, first_stage_cfg,
                 second_stage_modules: Sequence[dict] = (),
                 roi_head: Optional[dict] = None,
                 point_head: Optional[dict] = None, num_point=1,
                 freeze=False, use_final_feature=False,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, pretrained=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        del num_point, use_final_feature, pretrained, freeze
        if dtype != torch.float32:
            raise NotImplementedError(
                "PillarRCNN: only the f32 two-stage is ported")
        if roi_head is None:
            raise ValueError("PillarRCNN needs a roi_head")
        fs = dict(first_stage_cfg)
        fs.pop("type", None)
        self.dtype = dtype
        self.code_size = int(roi_head.get("code_size", 7))
        self.single_det = PillarNet(**fs, train_cfg=train_cfg,
                                    test_cfg=test_cfg, dtype=dtype,
                                    device=device)
        backbone = self.single_det.backbone_net
        bev_channels = self.single_det.neck_net.out_channels[-1]
        self.num_second_stage = len(second_stage_modules)
        for k, m in enumerate(second_stage_modules):
            if m.get("in_channels", bev_channels) != bev_channels:
                raise ValueError(
                    f"second stage {m['type']}: in_channels "
                    f"{m['in_channels']} != the neck's last map's "
                    f"{bev_channels}")
            setattr(self, f"second_stage_{k}",
                    builder.build_second_stage_module(
                        m, backbone.backbone_channels,
                        backbone.backbone_strides, device))
        self.roi_head_net = builder.build_roi_head(roi_head, device)
        self.point_head_net = (builder.build_point_head(point_head, device)
                               if point_head is not None else None)
        if (point_head or {}).get("model_cfg", {}).get("ATT_MODEL", False):
            raise NotImplementedError("PointHead ATT_MODEL is not ported yet")

    def processed_test_cfg(self):
        return self.single_det.processed_test_cfg()

    def first_stage(self, points, points_mask, test_cfg=None):
        """(padded first-stage detections, the neck's maps, the backbone's
        dict, the head's per-task predictions)."""
        preds, bev, feats = self.single_det.forward_two_stage(points,
                                                              points_mask)
        first = self.single_det.predict({}, preds, test_cfg)
        return first, bev, feats, preds

    def second_stage(self, first, bev, feats):
        """Refine the first stage's padded detections: RoIs -> grid
        pooling -> point head -> RoI head -> decoded boxes."""
        boxes = first["box3d_lidar"]
        if self.code_size == 9 and boxes.shape[-1] == 9:  # yaw to slot 6
            boxes = torch.cat([boxes[..., :6], boxes[..., 8:],
                               boxes[..., 6:8]], dim=-1)
        elif boxes.shape[-1] > self.code_size:
            boxes = torch.cat([boxes[..., :6], boxes[..., -1:]], dim=-1)
        valid = first["mask"]
        rois = boxes * valid[..., None]
        out = {"roi_labels": (first["label_preds"] + 1) * valid,
               "roi_scores": first["scores"] * valid}

        roi_feats = point_feats = point_coords = None
        for k in range(self.num_second_stage):
            roi_feats, point_feats, point_coords = getattr(
                self, f"second_stage_{k}")(bev[-1], feats, rois)
        out["point_coords"] = point_coords
        if self.point_head_net is not None:
            out["point_logits"] = self.point_head_net(point_feats)
        rcnn_cls, rcnn_reg = self.roi_head_net(roi_feats, rois,
                                               out["roi_scores"])
        out["rcnn_cls"], out["rcnn_reg"] = rcnn_cls, rcnn_reg
        out["batch_cls_preds"], out["batch_box_preds"] = \
            generate_predicted_boxes(rois, rcnn_cls, rcnn_reg)
        return out

    def forward(self, points, points_mask, test_cfg=None):
        """points (B, N, C) f32, points_mask (B, N) bool -> the eval output
        dict of the JAX package (`one_stage_preds`, `roi_labels`,
        `roi_scores`, `point_coords`, `point_logits`, `rcnn_cls`,
        `rcnn_reg`, `batch_cls_preds`, `batch_box_preds`). `test_cfg`: the
        first stage's, by default its processed config."""
        if self.training:
            raise NotImplementedError(_TRAINING)
        first, bev, feats, preds = self.first_stage(points, points_mask,
                                                    test_cfg)
        out = self.second_stage(first, bev, feats)
        out["one_stage_preds"] = preds
        return out

    def loss(self, example, out, train_cfg=None):
        raise NotImplementedError(_TRAINING)

    @staticmethod
    def post_process(out):
        """Final scoring: score = sqrt(sigmoid(cls) * roi_score); a slot
        is kept where its RoI was a detection and every refined dimension
        is positive. Returns the padded detection dict (box3d_lidar,
        scores, label_preds, mask)."""
        box_preds = out["batch_box_preds"]
        cls_preds = out["batch_cls_preds"][..., 0]
        label_preds = out["roi_labels"]
        if box_preds.shape[-1] == 9:  # yaw back to the last slot
            box_preds = torch.cat([box_preds[..., :6], box_preds[..., 7:],
                                   box_preds[..., 6:7]], dim=-1)
        scores = torch.sqrt(torch.sigmoid(cls_preds) * out["roi_scores"])
        mask = (label_preds != 0) & (box_preds[..., 3:6] > 0).all(-1)
        return {
            "box3d_lidar": box_preds * mask[..., None],
            "scores": scores * mask,
            "label_preds": (label_preds - 1).clamp_min(0),
            "mask": mask,
        }
