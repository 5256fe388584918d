"""RoI refinement heads.

Port of `pillarnet_lts_tpu/models/roi_heads/roi_heads.py` (`_FCStack`,
`RoIMIXHead` without a token mixer, `RoIHead`). Each stack is Dense + BN
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

Not ported yet: the token mixers (`mixer_type` "MLPMixer" / "ResMLP",
`mlp_layers.py`) and `RoIFFNHead`; no config in `configs/` uses them, and
they raise.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from ...parallel.mesh import rank_rows
from ..registry import ROI_HEAD
from ..utils.dense import Dense, dense_bn_relu
from ..utils.norm import MaskedBatchNorm


def dropout(x, rate, generator):
    """Zero each element with probability `rate` and scale the rest by
    1 / (1 - rate), as flax's `nn.Dropout`: keep = U < 1 - rate with U
    uniform on [0, 1) from `generator` (on its own device; the mask moves
    to x's). x's rows are its samples' RoIs, sample-major; in a
    data-parallel group U is drawn for the global batch's rows and each
    rank keeps its own (`parallel.mesh.rank_rows`)."""
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
                if generator is None:
                    raise ValueError("dropout in training draws from an "
                                     "explicit torch.Generator; pass "
                                     "generator=")
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

    def forward(self, roi_features, rois=None, roi_scores=None,
                generator=None):
        """roi_features (B, R, F) -> (rcnn_cls (B * R, ncls), rcnn_reg
        (B * R, code_size)). generator: dropout's, in training."""
        B, R = roi_features.shape[:2]
        x = roi_features.reshape(B * R, -1)
        if self.add_box_param:
            x = torch.cat([x, rois.reshape(B * R, -1),
                           roi_scores.reshape(B * R, 1)], dim=-1)
        x = self.shared_fc(x.to(self.dtype), generator)
        return self.cls(x, generator), self.reg(x, generator)


@ROI_HEAD.register_module
class RoIMIXHead(_RoIMLP):
    """Grid-token head over (B, R, num_patches * in_channels) features;
    without a token mixer the tokens go to the MLP flattened as they
    come (grid point major, channel minor)."""

    def __init__(self, in_channels, model_cfg, num_class=1, code_size=7,
                 add_box_param=False, test_cfg=None, mixer_type=None,
                 num_patches=49, dtype=torch.float32, device=None):
        del test_cfg
        if mixer_type:
            raise NotImplementedError(
                f"RoIMIXHead mixer_type={mixer_type!r} is not ported yet")
        super().__init__(in_channels * num_patches, model_cfg, num_class,
                         code_size, add_box_param, device, dtype)


@ROI_HEAD.register_module
class RoIHead(_RoIMLP):
    """Flattened-feature head: `input_channels` features per RoI."""

    def __init__(self, input_channels, model_cfg, num_class=1, code_size=7,
                 add_box_param=False, test_cfg=None, dtype=torch.float32,
                 device=None):
        del test_cfg
        super().__init__(input_channels, model_cfg, num_class, code_size,
                         add_box_param, device, dtype)
