"""PillarNet single-stage detector.

Port of `pillarnet_lts_tpu/models/detectors/pillarnet.py`:
reader -> backbone -> neck -> CenterHead, with the flax submodule names
(`reader_net`, `backbone_net`, `neck_net`, `head_net`). The forward is a
function of (points, points_mask), in training (`module.train()`) or
eval mode; `loss` takes the collated targets, `predict` decodes and runs
NMS.
`dtype` (f32 or bf16) is the compute dtype: the reader casts its features
to it and every later module computes in the dtype of its input, with f32
parameters, as the JAX package does. An int8 model (`backbone.quant`)
runs its convs on K4 and, with `backbone.s2d_pallas`, its stride-1 stage
on K5, each in the compute dtype's variant (bf16 or f32).

`spatial_axis` (the JAX field: the name of the mesh axis that shards the
BEV grid's H axis) turns on spatial sharding over the process group
(`parallel/spatial.py`): every rank runs the reader on the whole cloud,
the stride-1 stage and conv2 on its band of grid rows, and the rest on
conv2's gathered map, so each rank's outputs are the whole frame's. The
group splits the grid and not the batch (`dist.split_grid`): only the
sharded stages' BNs sum over it. conv1 is gathered only when a consumer
reads it (`spatial_conv1`, which a second stage reading conv1 sets); else
`extract_feat`'s dict leaves it out. Without a group the forward is the
unsharded one. The compact reader has no H axis to shard, and raises.

Each layer's call is a span of the tracer (`runtime/tracing.py`):
`reader`, `backbone`, `neck`, `head`, and `predict`.
"""

from typing import Optional

import torch
from torch import nn

from ...core.utils import set_by_task_cfg
from ...parallel import dist
from ...parallel.spatial import row_bands
from ...runtime import tracing
from .. import builder
from ..registry import DETECTORS
from ..utils.norm import MaskedBatchNorm


@DETECTORS.register_module
class PillarNet(nn.Module):
    def __init__(self, reader, backbone, neck, bbox_head,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, pretrained=None,
                 dtype=torch.float32, spatial_axis: Optional[str] = None,
                 device=None):
        super().__init__()
        del pretrained  # weights come through runtime/convert.py
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.dtype = dtype
        self.spatial_axis = spatial_axis
        self.spatial_conv1 = False
        if spatial_axis and reader.get("compact_kmax", 0) > 0:
            raise ValueError(
                "spatial_axis sharding requires the dense reader path "
                "(reader.compact_kmax=0); the compact row table has no "
                "H axis to shard")
        self.reader_net = builder.build_reader(reader, device, dtype)
        self.backbone_net = builder.build_backbone(backbone, device)
        if spatial_axis:
            dist.split_grid()
            for stage in self.backbone_net.sharded_stages():
                for m in stage.modules():
                    if isinstance(m, MaskedBatchNorm):
                        m.over_ranks = True
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

    def loss(self, example, preds, train_cfg=None):
        return self.head_net.loss(example, preds,
                                  train_cfg or self.train_cfg)

    def predict(self, example, preds, test_cfg=None):
        with tracing.span("predict"):
            return self.head_net.predict(
                example, preds, test_cfg or self.processed_test_cfg())

    def extract_feat(self, points, points_mask):
        with tracing.span("reader"):
            grid, occ = self.reader_net(points, points_mask)
        with tracing.span("backbone"):
            if self.spatial_axis:
                feats = self.backbone_net(
                    grid, occ,
                    bands=row_bands(grid.shape[1], dist.process_count()),
                    conv1=self.spatial_conv1)
            else:
                feats = self.backbone_net(grid, occ)
        with tracing.span("neck"):
            return self.neck_net(feats), feats

    def forward(self, points, points_mask, gt_boxes_and_cls=None,
                generator=None):
        """points (B, N, C) f32, points_mask (B, N) bool -> per-task
        prediction dicts of (B, H, W, *) maps. gt_boxes_and_cls and
        generator are what the two-stage detector trains with; the single
        stage takes them, as the JAX package's, and uses neither."""
        del gt_boxes_and_cls, generator
        bev, _ = self.extract_feat(points, points_mask)
        with tracing.span("head"):
            return self.head_net(bev)

    def forward_two_stage(self, points, points_mask):
        """The forward that also returns what a second stage pools from:
        (per-task predictions, the neck's tuple of NCHW maps, the
        backbone's dict of (map, occupancy))."""
        bev, feats = self.extract_feat(points, points_mask)
        with tracing.span("head"):
            return self.head_net(bev), bev, feats
