"""PillarNet single-stage detector, eval path.

Port of `pillarnet_lts_tpu/models/detectors/pillarnet.py`:
reader -> backbone -> neck -> CenterHead, with the flax submodule names
(`reader_net`, `backbone_net`, `neck_net`, `head_net`). The forward is a
function of (points, points_mask); `predict` decodes and runs NMS.
`dtype` (f32 or bf16) is the compute dtype: the reader casts its features
to it and every later module computes in the dtype of its input, with f32
parameters, as the JAX package does.
"""

from typing import Optional

import torch
from torch import nn

from ...core.utils import set_by_task_cfg
from .. import builder
from ..registry import DETECTORS


@DETECTORS.register_module
class PillarNet(nn.Module):
    def __init__(self, reader, backbone, neck, bbox_head,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, pretrained=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        del pretrained  # weights come through runtime/convert.py
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.dtype = dtype
        self.reader_net = builder.build_reader(reader, device, dtype)
        self.backbone_net = builder.build_backbone(backbone, device)
        self.neck_net = builder.build_neck(
            neck, self.backbone_net.backbone_channels, device)
        self.head_net = builder.build_head(
            bbox_head, self.neck_net.out_channels, device)

    def processed_test_cfg(self):
        """The test config with per-class NMS params regrouped per task
        when `use_multi_class_nms` is set (the Waymo configs)."""
        cfg = dict(self.test_cfg)
        if cfg["nms"].get("use_multi_class_nms", False):
            num_classes = [len(t["class_names"]) for t in self.head_net.tasks]
            cfg = set_by_task_cfg(cfg, num_classes)
        return cfg

    def predict(self, example, preds, test_cfg=None):
        return self.head_net.predict(
            example, preds, test_cfg or self.processed_test_cfg())

    def extract_feat(self, points, points_mask):
        grid, occ = self.reader_net(points, points_mask)
        feats = self.backbone_net(grid, occ)
        return self.neck_net(feats), feats

    def forward(self, points, points_mask):
        """points (B, N, C) f32, points_mask (B, N) bool -> per-task
        prediction dicts of (B, H, W, *) maps."""
        bev, _ = self.extract_feat(points, points_mask)
        return self.head_net(bev)
