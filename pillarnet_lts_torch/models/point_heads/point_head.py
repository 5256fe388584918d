"""Auxiliary per-grid-point foreground classification head.

Port of the forward of `pillarnet_lts_tpu/models/point_heads/
point_head.py::PointHead`: Dense + BN + ReLU layers (`cls_fc{k}`,
`cls_bn{k}`; the BN folded at eval) and a one-logit projection
(`cls_out`). The training half (`assign_point_targets_2d`,
`point_cls_loss`) is not ported yet.
"""

from torch import nn

from ..registry import POINT_HEAD
from ..utils.dense import Dense, dense_bn_relu
from ..utils.norm import MaskedBatchNorm


@POINT_HEAD.register_module
class PointHead(nn.Module):
    def __init__(self, in_channels, num_class, model_cfg, device=None):
        super().__init__()
        del num_class  # one logit, as the JAX package's (class-agnostic)
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
        """point_features (B, R, G, C) -> logits (B, R, G, 1)."""
        x = point_features
        for k in range(self.num_layers):
            x = dense_bn_relu(getattr(self, f"cls_fc{k}"),
                              getattr(self, f"cls_bn{k}"), x, self.training)
        return self.cls_out(x)
