"""Pillar R-CNN two-stage detector: inference and training.

Port of `pillarnet_lts_tpu/models/detectors/pillar_rcnn.py::PillarRCNN`
(its forward in both modes, `loss` and `post_process`): the first stage (a
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

In training (`model.train()`) the first stage runs in training mode
(unless `freeze`), its detached predictions go through the same predict
(no gradient), and `proposal_target_layer` samples ROI_PER_IMAGE RoIs per
sample against `gt_boxes_and_cls` with draws from the caller's
`generator` (`sampler_draws`), which then also drives the RoI head's
dropout. The second stage pools the sampled RoIs; `loss` adds the RCNN
classification and regression losses, the IoU branch's loss (a head with
three outputs, `RoIFFNHead` with `num_iou_fcs > 0`, against the detached
decoded boxes `batch_box_preds_det`) and the point head's focal loss to
the first task's CenterNet loss and lists each per task, as the JAX
package does. With `freeze` the first stage runs in eval mode under
`torch.no_grad()`: no gradient and no running-statistics update, the JAX
package's `train=False` plus `stop_gradient`. With the point head's
`ATT_MODEL` the grid points' features are scaled by sigmoid(point
logits) before the RoI head pools them.

`dtype` (f32 or bf16) is the compute dtype of both stages, as in the JAX
package: the first stage computes in it, its detections (hence the RoIs)
are decoded in f32, the grid pooling's convs run on its maps in dtype
and samples them with f32 weights (f32 features), and the point and RoI
heads cast those to dtype. Both dtypes serve and train
(`runtime/train_step.py`: f32 parameters, bf16 compute). An int8
model (`runtime.quantize.enable_backbone_quant` on the config, then
`calibrate`) quantizes the first stage's reader, backbone and neck in
either dtype; the second stage stays in dtype.
"""

import inspect
from typing import Optional, Sequence

import torch
from torch import nn

from .. import builder
from ..point_heads.point_head import assign_point_targets_2d, point_cls_loss
from ...runtime import tracing
from ..registry import DETECTORS, ROI_HEAD
from ..roi_heads.proposal_target_layer import (proposal_target_layer,
                                               sampler_draws)
from ..roi_heads.roi_head_template import (box_cls_layer_loss,
                                           box_iou_layer_loss,
                                           box_reg_layer_loss,
                                           canonicalize_roi_targets,
                                           generate_predicted_boxes)
from .pillarnet import PillarNet


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
        del use_final_feature, pretrained
        if roi_head is None:
            raise ValueError("PillarRCNN needs a roi_head")
        fs = dict(first_stage_cfg)
        fs.pop("type", None)
        self.dtype = dtype
        self.num_point = num_point
        self.freeze = bool(freeze)
        self.code_size = int(roi_head.get("code_size", 7))
        self.target_config = dict(roi_head["model_cfg"]["TARGET_CONFIG"])
        self.loss_config = dict(roi_head["model_cfg"]["LOSS_CONFIG"])
        self.point_loss_weight = (
            point_head["model_cfg"]["LOSS_CONFIG"]["LOSS_WEIGHTS"]
            ["point_cls_weight"] if point_head is not None else None)
        self.att_model = bool((point_head or {}).get("model_cfg", {})
                              .get("ATT_MODEL", False))
        self.single_det = PillarNet(**fs, train_cfg=train_cfg,
                                    test_cfg=test_cfg, dtype=dtype,
                                    device=device)
        bev_channels = self.single_det.neck_net.out_channels[-1]
        self.num_second_stage = len(second_stage_modules)
        for k, m in enumerate(second_stage_modules):
            if m.get("in_channels", bev_channels) != bev_channels:
                raise ValueError(
                    f"second stage {m['type']}: in_channels "
                    f"{m['in_channels']} != the neck's last map's "
                    f"{bev_channels}")
            setattr(self, f"second_stage_{k}",
                    self._second_stage_module(m, device))
        # a spatially sharded first stage gathers conv1 only for a second
        # stage that reads it
        self.single_det.spatial_conv1 = any(
            src == "conv1" for k in range(self.num_second_stage)
            for src, _ in getattr(getattr(self, f"second_stage_{k}"),
                                  "sources", ()))
        head_cls = ROI_HEAD.get(roi_head["type"])
        if ("in_features" in inspect.signature(head_cls).parameters
                and self.num_second_stage):
            # flax infers such a head's input width; torch is told it
            last = getattr(self, f"second_stage_{self.num_second_stage - 1}")
            roi_head = {"in_features": last.roi_feature_width(bev_channels),
                        **roi_head}
        self.roi_head_net = builder.build_roi_head(roi_head, device, dtype)
        self.point_head_net = (
            builder.build_point_head(point_head, device, dtype)
            if point_head is not None else None)

    def _second_stage_module(self, cfg, device):
        """A RoI-grid module, given the backbone's geometry."""
        backbone = self.single_det.backbone_net
        return builder.build_second_stage_module(
            cfg, backbone.backbone_channels, backbone.backbone_strides,
            device)

    def train(self, mode=True):
        """torch's train(); a frozen first stage stays in eval mode."""
        super().train(mode)
        if self.freeze:
            self.single_det.eval()
        return self

    def processed_test_cfg(self):
        return self.single_det.processed_test_cfg()

    def first_stage(self, points, points_mask, test_cfg=None):
        """(padded first-stage detections, the neck's maps, the backbone's
        dict, the head's per-task predictions). In training the detections
        come from the detached predictions, without a gradient."""
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze):
            preds, bev, feats = self.single_det.forward_two_stage(
                points, points_mask)
        with torch.no_grad():
            first = self.single_det.predict(
                {}, [{k: v.detach() for k, v in p.items()} for p in preds],
                test_cfg)
        return first, bev, feats, preds

    def rois(self, first):
        """The first stage's padded detections as RoIs: (rois (B, R,
        code_size), labels (B, R) 1-based with 0 at padded slots, scores
        (B, R)); a padded slot is the zero box."""
        boxes = first["box3d_lidar"]
        if self.code_size == 9 and boxes.shape[-1] == 9:  # yaw to slot 6
            boxes = torch.cat([boxes[..., :6], boxes[..., 8:],
                               boxes[..., 6:8]], dim=-1)
        elif boxes.shape[-1] > self.code_size:
            boxes = torch.cat([boxes[..., :6], boxes[..., -1:]], dim=-1)
        valid = first["mask"]
        return (boxes * valid[..., None], (first["label_preds"] + 1) * valid,
                first["scores"] * valid)

    def _pool(self, bev, feats, rois):
        """(roi features, point features, point coordinates) of `rois`:
        RoI-grid pooling over the neck's last map (the legacy
        `TwoStageDetector` pools at box centres instead)."""
        roi_feats = point_feats = point_coords = None
        for k in range(self.num_second_stage):
            roi_feats, point_feats, point_coords = getattr(
                self, f"second_stage_{k}")(bev[-1], feats, rois)
        return roi_feats, point_feats, point_coords

    def _refine(self, bev, feats, rois, roi_scores, out, generator=None):
        """Pooling, point head and RoI head over `rois`, into out (with
        `rcnn_iou` from a head with an IoU branch)."""
        with tracing.span("roi_pool"):
            roi_feats, point_feats, point_coords = self._pool(bev, feats,
                                                              rois)
        out["point_coords"] = point_coords
        if self.point_head_net is not None:
            with tracing.span("point_head"):
                out["point_logits"] = self.point_head_net(point_feats)
                if self.att_model:
                    point_feats = point_feats * torch.sigmoid(
                        out["point_logits"])
                    roi_feats = point_feats.reshape(roi_feats.shape)
        with tracing.span("roi_head"):
            head_out = self.roi_head_net(roi_feats, rois, roi_scores,
                                         generator)
        out["rcnn_cls"], out["rcnn_reg"] = head_out[:2]
        if len(head_out) == 3:
            out["rcnn_iou"] = head_out[2]
        return out

    def second_stage(self, first, bev, feats):
        """Refine the first stage's padded detections: RoIs -> grid
        pooling -> point head -> RoI head -> decoded boxes."""
        rois, labels, scores = self.rois(first)
        out = self._refine(bev, feats, rois, scores,
                           {"roi_labels": labels, "roi_scores": scores})
        out["batch_cls_preds"], out["batch_box_preds"] = \
            generate_predicted_boxes(rois, out["rcnn_cls"], out["rcnn_reg"])
        return out

    def second_stage_train(self, first, bev, feats, gt_boxes_and_cls, draws,
                           generator=None):
        """The training second stage: sample RoI targets from the first
        stage's detections (`draws`: `SamplerDraws`), canonicalize them,
        refine the sampled RoIs (dropout from `generator`). Returns the
        output dict with `targets`."""
        rois, labels, scores = self.rois(first)
        gt = gt_boxes_and_cls
        if self.code_size == 7 and gt.shape[-1] == 10:  # drop velocity
            gt = torch.cat([gt[..., :7], gt[..., 9:]], dim=-1)
        targets = canonicalize_roi_targets(proposal_target_layer(
            rois, scores, labels, gt, self.target_config, draws))
        out = self._refine(bev, feats, targets["rois"],
                           targets["roi_scores"], {"targets": targets},
                           generator)
        if "rcnn_iou" in out:  # the IoU loss's detached decoded boxes
            with torch.no_grad():
                out["batch_box_preds_det"] = generate_predicted_boxes(
                    targets["rois"], out["rcnn_cls"], out["rcnn_reg"])[1]
        return out

    def forward(self, points, points_mask, gt_boxes_and_cls=None,
                generator=None, test_cfg=None):
        """points (B, N, C) f32, points_mask (B, N) bool.

        Eval: the output dict of the JAX package (`one_stage_preds`,
        `roi_labels`, `roi_scores`, `point_coords`, `point_logits`,
        `rcnn_cls`, `rcnn_reg`, `batch_cls_preds`, `batch_box_preds`, and
        `rcnn_iou` from a head with an IoU branch);
        `test_cfg`: the first stage's, by default its processed config.
        Training: gt_boxes_and_cls (B, G, 8 or 10) and a `generator`
        (the sampler's draws, then dropout's) are required; the output
        carries `targets` in place of the decoded boxes (and, with an IoU
        branch, `batch_box_preds_det`, the detached decoded boxes)."""
        if self.training and (gt_boxes_and_cls is None or generator is None):
            raise ValueError("PillarRCNN training needs gt_boxes_and_cls "
                             "and a torch.Generator")
        first, bev, feats, preds = self.first_stage(points, points_mask,
                                                    test_cfg)
        if not self.training:
            out = self.second_stage(first, bev, feats)
        else:
            B, R = first["mask"].shape
            draws = sampler_draws(generator, B, R,
                                  int(self.target_config["ROI_PER_IMAGE"]),
                                  points.device)
            out = self.second_stage_train(first, bev, feats,
                                          gt_boxes_and_cls, draws, generator)
        out["one_stage_preds"] = preds
        return out

    def second_stage_losses(self, out):
        """(RCNN classification loss, RCNN regression loss, point loss or
        None) of a training output.

        The heads' outputs enter the losses in f32, as the CenterNet
        losses take their maps. The JAX package hands its RCNN and point
        losses a bf16 model's bf16 outputs: its sigmoid then rounds to
        bf16, the clip's 1 - 1e-7 is 1, and a logit above ~6 with a soft
        label below 1 gives log(0), an infinite loss (its fault, which
        stays there; a bf16 `pillarrcnn18_waymo` step on the card met
        it)."""
        targets = out["targets"]
        weights = self.loss_config["LOSS_WEIGHTS"]
        cls = box_cls_layer_loss(out["rcnn_cls"].float(),
                                 targets["rcnn_cls_labels"],
                                 weight=weights["rcnn_cls_weight"])
        reg = box_reg_layer_loss(out["rcnn_reg"].float(),
                                 targets["reg_valid_mask"],
                                 targets["gt_of_rois"],
                                 weights["code_weights"],
                                 weight=weights["rcnn_reg_weight"])
        point = None
        if "point_logits" in out:
            labels = assign_point_targets_2d(out["point_coords"],
                                             targets["gt_of_rois_src"])
            point = point_cls_loss(out["point_logits"].float(), labels,
                                   weight=self.point_loss_weight)
        return cls, reg, point

    def iou_loss(self, out):
        """The IoU branch's loss of a training output (None without one),
        weighted by LOSS_WEIGHTS' `rcnn_iou_weight` (1 by default); the
        branch's output in f32, as `second_stage_losses` takes the
        others."""
        if "rcnn_iou" not in out:
            return None
        targets = out["targets"]
        return box_iou_layer_loss(
            out["rcnn_iou"].float(), targets["reg_valid_mask"],
            targets["gt_of_rois_src"], out["batch_box_preds_det"],
            weight=self.loss_config["LOSS_WEIGHTS"].get("rcnn_iou_weight",
                                                        1.0))

    def loss(self, example, out, train_cfg=None):
        """The first stage's per-task CenterNet losses, with the RCNN, IoU
        and point losses added to task 0's `loss` and listed per task
        (`roi_cls_loss`, `roi_reg_loss`, `roi_iou_loss`, `point_loss`)."""
        losses = self.single_det.loss(example, out["one_stage_preds"],
                                      train_cfg)
        cls, reg, point = self.second_stage_losses(out)
        iou = self.iou_loss(out)
        n = len(losses["loss"])
        losses["roi_reg_loss"] = [reg] * n
        losses["roi_cls_loss"] = [cls] * n
        roi = cls + reg
        if iou is not None:
            losses["roi_iou_loss"] = [iou] * n
            roi = roi + iou
        total = losses["loss"][0] + roi
        if point is not None:
            losses["point_loss"] = [point] * n
            total = total + point
        losses["loss"][0] = total
        return losses

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
