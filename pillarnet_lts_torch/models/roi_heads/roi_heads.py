"""RoI refinement heads.

Port of `pillarnet_lts_tpu/models/roi_heads/roi_heads.py` (`_FCStack`,
`RoIMIXHead` with its optional token mixer, `RoIHead`, `_LNMLP`,
`RoIFFNHead`). Each stack is Dense + BN
+ ReLU layers (`fc{k}`, `bn{k}`; the BN folded at eval, batch statistics
over the B * R rows in training) with dropout, then an optional
projection with bias (`out`). Dropout runs only when the module's own
`training` flag is set, and draws from the generator the caller passes
(`dropout`: flax's `nn.Dropout`, keep mask and 1 / (1 - rate) scale);
nothing draws from torch's global generator.

`dtype` is the compute dtype: each RoI's row (its pooled features and,
with `add_box_param`, its box and score) is cast to it before the first
Dense, as flax's `Dense(dtype=...)` casts its input, and the layers run
in it with their f32 parameters cast (bf16 serving: bf16 outputs).

`RoIMIXHead(mixer_type="MLPMixer" | "ResMLP")` runs the token mixer of
`mlp_layers.py` (`mixer`) over the (B * R, num_patches, C) grid tokens
before they are flattened. `RoIFFNHead` is the FFN head: a feed-forward
block (ReLU expansions, a residual where the widths agree) and
`ffn_norm`, then Linear + LayerNorm + ReLU branches (`_LNMLP`) for the
classification, the regression and, with `num_iou_fcs > 0`, a third
output, the IoU, which `roi_head_template.py::box_iou_layer_loss` trains.
No config in `configs/` sets a mixer or `RoIFFNHead`; a config override
selects them.
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import rank_rows
from ..registry import ROI_HEAD
from ..utils.dense import Dense, dense_bn_relu
from ..utils.norm import LayerNorm, MaskedBatchNorm
from .mlp_layers import MLPMixer, ResMLPLayer

_MIXERS = {"MLPMixer": MLPMixer, "ResMLP": ResMLPLayer}


def dropout(x, rate, generator):
    """Zero each element with probability `rate` and scale the rest by
    1 / (1 - rate), as flax's `nn.Dropout`: keep = U < 1 - rate with U
    uniform on [0, 1) from `generator` (on its own device; the mask moves
    to x's). x's rows are its samples' RoIs, sample-major; in a
    data-parallel group U is drawn for the global batch's rows and each
    rank keeps its own (`parallel.mesh.rank_rows`). Raises without a
    generator: nothing draws from torch's global one."""
    if generator is None:
        raise ValueError("dropout in training draws from an explicit "
                         "torch.Generator; pass generator=")
    keep_prob = 1.0 - rate
    u = rank_rows(lambda size: torch.rand(size, generator=generator,
                                          device=generator.device),
                  *x.shape)
    keep = u.to(x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def _xavier_normal_std(fan_in, fan_out):
    return (2.0 / (fan_in + fan_out)) ** 0.5


class _FCStack(nn.Module):
    """`channels` Dense + BN + ReLU layers, dropout after every layer but
    the last (or only after the first, `dropout_after_first_only`), then
    an optional projection to `out_channels` with bias."""

    def __init__(self, in_features, channels: Sequence[int],
                 out_channels: Optional[int] = None, dropout=0.0,
                 dropout_after_first_only=False, final_std=None,
                 device=None):
        super().__init__()
        self.dropout = dropout
        self.num_layers = len(channels)
        self.drop_at = [(k == 0) if dropout_after_first_only
                        else (k != len(channels) - 1)
                        for k in range(len(channels))]
        c = in_features
        for k, ch in enumerate(channels):
            setattr(self, f"fc{k}", Dense(c, ch, use_bias=False,
                                          init_std=_xavier_normal_std(c, ch),
                                          device=device))
            setattr(self, f"bn{k}", MaskedBatchNorm(ch, device=device))
            c = ch
        self.out = None
        if out_channels is not None:
            std = (final_std if final_std is not None
                   else _xavier_normal_std(c, out_channels))
            self.out = Dense(c, out_channels, init_std=std, device=device)

    def forward(self, x, generator=None):
        """generator: the dropout draws' source, needed in training when
        dropout > 0."""
        for k in range(self.num_layers):
            x = dense_bn_relu(getattr(self, f"fc{k}"), getattr(self, f"bn{k}"),
                              x, self.training)
            if self.dropout > 0 and self.drop_at[k] and self.training:
                x = dropout(x, self.dropout, generator)
        return x if self.out is None else self.out(x)


class _RoIMLP(nn.Module):
    """Shared FC stack, then the cls and reg branches, over one row of F
    features per RoI; with `add_box_param` each row also carries its RoI's
    box and score."""

    def __init__(self, in_features, model_cfg, num_class, code_size,
                 add_box_param, device, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        cfg = dict(model_cfg)
        dp = cfg.get("DP_RATIO", 0.0)
        self.add_box_param = add_box_param
        if add_box_param:
            in_features += code_size + 1
        self.shared_fc = _FCStack(in_features, cfg["SHARED_FC"], dropout=dp,
                                  device=device)
        c = cfg["SHARED_FC"][-1]
        self.cls = _FCStack(c, cfg["CLS_FC"], num_class, dp, True,
                            device=device)
        self.reg = _FCStack(c, cfg["REG_FC"], code_size, dp, True,
                            final_std=0.001, device=device)

    def rows(self, roi_features):
        """(B, R, F) features -> (B * R, F) rows."""
        return roi_features.reshape(-1, roi_features.shape[-1])

    def forward(self, roi_features, rois=None, roi_scores=None,
                generator=None):
        """roi_features (B, R, F) -> (rcnn_cls (B * R, ncls), rcnn_reg
        (B * R, code_size)). generator: dropout's, in training."""
        B, R = roi_features.shape[:2]
        x = self.rows(roi_features)
        if self.add_box_param:
            x = torch.cat([x, rois.reshape(B * R, -1),
                           roi_scores.reshape(B * R, 1)], dim=-1)
        x = self.shared_fc(x.to(self.dtype), generator)
        return self.cls(x, generator), self.reg(x, generator)


@ROI_HEAD.register_module
class RoIMIXHead(_RoIMLP):
    """Grid-token head over (B, R, num_patches * in_channels) features:
    the token mixer (`mixer_type`, none by default) over the
    (B * R, num_patches, in_channels) tokens, then the MLP over them
    flattened (grid point major, channel minor)."""

    def __init__(self, in_channels, model_cfg, num_class=1, code_size=7,
                 add_box_param=False, test_cfg=None, mixer_type=None,
                 num_patches=49, dtype=torch.float32, device=None):
        del test_cfg
        if mixer_type and mixer_type not in _MIXERS:
            raise ValueError(f"RoIMIXHead: unknown mixer_type "
                             f"{mixer_type!r}")
        super().__init__(in_channels * num_patches, model_cfg, num_class,
                         code_size, add_box_param, device, dtype)
        self.num_patches = num_patches
        self.mixer = (_MIXERS[mixer_type](in_channels, num_patches,
                                          dtype=dtype, device=device)
                      if mixer_type else None)

    def rows(self, roi_features):
        x = roi_features.reshape(-1, self.num_patches,
                                 roi_features.shape[-1] // self.num_patches)
        if self.mixer is not None:
            x = self.mixer(x)
        return x.reshape(x.shape[0], -1)


@ROI_HEAD.register_module
class RoIHead(_RoIMLP):
    """Flattened-feature head: `input_channels` features per RoI."""

    def __init__(self, input_channels, model_cfg, num_class=1, code_size=7,
                 add_box_param=False, test_cfg=None, dtype=torch.float32,
                 device=None):
        del test_cfg
        super().__init__(input_channels, model_cfg, num_class, code_size,
                         add_box_param, device, dtype)


class _LNMLP(nn.Module):
    """Linear + LayerNorm + ReLU layers (`fc{k}` with xavier-uniform
    kernels, `ln{k}`), each in the compute dtype."""

    def __init__(self, in_features, channels: Sequence[int], device=None):
        super().__init__()
        self.num_layers = len(channels)
        c = in_features
        for k, ch in enumerate(channels):
            setattr(self, f"fc{k}", Dense(c, ch, kernel_init="xavier_uniform",
                                          device=device))
            setattr(self, f"ln{k}", LayerNorm(ch, device=device))
            c = ch

    def forward(self, x, dtype):
        for k in range(self.num_layers):
            y = getattr(self, f"fc{k}")(x.to(dtype))
            x = F.relu(getattr(self, f"ln{k}")(y, dtype))
        return x


@ROI_HEAD.register_module
class RoIFFNHead(nn.Module):
    """FFN refinement head over one row of features per RoI: the
    feed-forward block (`num_ffn_fcs - 1` ReLU expansions to
    `feedforward_channels`, `ffn_fc{k}`, with dropout from the caller's
    generator in training; `ffn_out` to `content_dim`; the row added back
    where its width is `content_dim`), `ffn_norm`, then the LN-MLP
    branches `cls_fcs` / `reg_fcs` (/ `iou_fcs`) and their projections
    `fc_cls` (bias `init_bias`), `fc_reg` and `fc_iou` (zero-initialised).
    Returns (rcnn_cls, rcnn_reg) or, with `num_iou_fcs > 0`, (rcnn_cls,
    rcnn_reg, rcnn_iou), each (B * R, *) in the compute dtype."""

    def __init__(self, model_cfg, in_features=None, num_cls_fcs=1,
                 num_reg_fcs=1, num_iou_fcs=1, feedforward_channels=2048,
                 content_dim=256, num_ffn_fcs=2, dropout=0.0, num_class=1,
                 code_size=7, test_cfg=None, init_bias=-2.19,
                 add_box_param=False, dtype=torch.float32, device=None):
        super().__init__()
        del model_cfg, test_cfg
        if in_features is None:
            raise ValueError("RoIFFNHead needs in_features, the width of a "
                             "RoI's feature row (flax infers it; "
                             "`PillarRCNN` passes its second stage's)")
        self.dtype = dtype
        self.dropout = dropout
        self.add_box_param = add_box_param
        self.content_dim = content_dim
        self.num_ffn_fcs = num_ffn_fcs
        c = in_features + (code_size + 1 if add_box_param else 0)
        self.residual = c == content_dim
        y = c
        for k in range(num_ffn_fcs - 1):
            setattr(self, f"ffn_fc{k}", Dense(y, feedforward_channels,
                                              device=device))
            y = feedforward_channels
        self.ffn_out = Dense(y, content_dim, device=device)
        self.ffn_norm = LayerNorm(content_dim, device=device)
        self.cls_fcs = _LNMLP(content_dim, (content_dim,) * num_cls_fcs,
                              device)
        self.reg_fcs = _LNMLP(content_dim, (content_dim,) * num_reg_fcs,
                              device)
        self.fc_cls = Dense(content_dim, num_class, bias_init=init_bias,
                            device=device)
        self.fc_reg = Dense(content_dim, code_size, kernel_init="zeros",
                            device=device)
        self.iou_fcs = self.fc_iou = None
        if num_iou_fcs > 0:
            self.iou_fcs = _LNMLP(content_dim, (content_dim,) * num_iou_fcs,
                                  device)
            self.fc_iou = Dense(content_dim, 1, kernel_init="zeros",
                                device=device)

    def forward(self, roi_features, rois=None, roi_scores=None,
                generator=None):
        """roi_features (B, R, F); generator: dropout's, in training."""
        B, R = roi_features.shape[:2]
        d = self.dtype
        x = roi_features.reshape(B * R, -1)
        if self.add_box_param:
            x = torch.cat([x, rois.reshape(B * R, -1),
                           roi_scores.reshape(B * R, 1)], dim=-1)
        y = x
        for k in range(self.num_ffn_fcs - 1):
            y = F.relu(getattr(self, f"ffn_fc{k}")(y.to(d)))
            if self.dropout > 0 and self.training:
                y = dropout(y, self.dropout, generator)
        y = self.ffn_out(y.to(d))
        if self.residual:
            y = y + x
        query = self.ffn_norm(y, d)
        cls_feat = self.cls_fcs(query, d)
        reg_feat = self.reg_fcs(query, d)
        out = (self.fc_cls(cls_feat), self.fc_reg(reg_feat))
        if self.iou_fcs is not None:
            out = out + (self.fc_iou(self.iou_fcs(query, d)),)
        return out
