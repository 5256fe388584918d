"""Dense BEV FPN necks RPNV1, RPNV2, RPNG and RPNGV2, and the legacy RPN.

Port of `pillarnet_lts_tpu/models/necks/rpn.py`:

- RPNV1: conv5 -> block -> deconv x2 -> concat conv4 -> block; one output
  at stride 8.
- RPNV2: conv4 -> block -> deconv x2 -> concat conv3 -> block; one output
  at stride 4.
- RPNG: top-down 5 -> 4 -> 3; two outputs, at strides 8 and 4 (the FPN
  of the two-stage and `*_fpn_waymo` configs).
- RPNGV2: RPNG with 3x3 'reduce' convs on the lateral maps.
- RPN: the legacy generic multi-scale neck (`rpn.py:212-272`): strided
  stages on the backbone's last map, each stage's output upsampled (or
  kept, at up stride 1) and concatenated; one output.

Inputs are the backbone's NCHW maps; the conv input widths come from
`backbone_channels`, which the detector passes in (flax infers them from
the input). Submodule names mirror the flax ones (`block_5.conv0.Conv_0`,
`deblock_5.ConvTranspose_0`, `top_down_54.ConvTranspose_0`, ...). Convs
compute in the input's dtype; with `quant=True` the calibrated 3x3 convs
run the int8 core (K4 on CUDA) and the transposed convs stay in the
compute dtype, as in the JAX package.
In training (`module.train()`) every BN, the deconv branches' too, takes
batch statistics over all sites (`models/utils/norm.py`).
"""

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..backbones.base import MaskedConv, conv_bn_act
from ..registry import NECKS
from ..utils.init import xavier_uniform_
from ..utils.norm import MaskedBatchNorm


class _ConvBNReLU(nn.Module):
    """3x3 conv + BN (folded at eval) + ReLU."""

    def __init__(self, in_features, features, quant=False, device=None):
        super().__init__()
        self.Conv_0 = MaskedConv(in_features, features, use_bias=False,
                                 init="xavier", quant=quant, device=device)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, device=device)

    def convs(self):
        return [(self.Conv_0, self.MaskedBatchNorm_0)]

    def forward(self, x):
        return conv_bn_act(self.Conv_0, self.MaskedBatchNorm_0, x, None,
                           self.training)


class _Block(nn.Module):
    """1 + num_blocks conv+BN+ReLU units (`conv0`, `conv1`, ...)."""

    def __init__(self, in_features, features, num_blocks, quant=False,
                 device=None):
        super().__init__()
        self.num_convs = num_blocks + 1
        for i in range(self.num_convs):
            setattr(self, f"conv{i}",
                    _ConvBNReLU(in_features if i == 0 else features,
                                features, quant, device))

    def forward(self, x):
        for i in range(self.num_convs):
            x = getattr(self, f"conv{i}")(x)
        return x


class ConvTranspose(nn.Module):
    """Bias-free ConvTranspose2d(k, s=k) (k = `size`, 2 in the necks).
    `weight` is torch's (in, out, kh, kw); from flax's (kh, kw, in, out) it
    is transposed and spatially flipped (`runtime/convert.py`)."""

    def __init__(self, in_features, features, size=2, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(in_features, features, size, size, device=device))

    @torch.no_grad()
    def init_weights(self, generator):
        i, o, k, _ = self.weight.shape
        xavier_uniform_(self.weight, k * k * i, k * k * o, generator)

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype),
                                  stride=self.weight.shape[-1])


class _DeBlock(nn.Module):
    """ConvTranspose2d(k=2, s=2) + BN + ReLU."""

    def __init__(self, in_features, features, device=None):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(in_features, features,
                                             device=device)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, device=device)

    def forward(self, x):
        return _conv_bn_relu_f32(self.ConvTranspose_0, self.MaskedBatchNorm_0,
                                 x)


def _conv_bn_relu_f32(conv, bn, x):
    """A bias-free conv (`MaskedConv`) or `ConvTranspose` + BN + ReLU with
    the BN unfolded: the x.dtype operands accumulate in f32, the f32 BN
    reads the sums unrounded (batch statistics in training, running ones
    at eval), one rounding to x.dtype after it, then the ReLU. That is what
    the JAX package computes under jit, where XLA folds the conv output's
    bf16 round trip into the BN's f32 convert."""
    w = conv.weight.to(x.dtype).float()
    if isinstance(conv, ConvTranspose):
        y = F.conv_transpose2d(x.float(), w, stride=w.shape[-1])
    else:
        y = F.conv2d(x.float(), w, stride=conv.stride, padding=conv.padding)
    return F.relu(bn(y).to(x.dtype))


class _TopDownNeck(nn.Module):
    """Shared body of RPNV1/RPNV2: block on the coarse map, upsample x2,
    concat the finer map, block."""

    coarse: str
    fine: str

    def __init__(self, layer_nums, in_channels, num_filters,
                 backbone_channels: Dict[str, int], quant=False, device=None):
        super().__init__()
        cc = backbone_channels[self.coarse]
        cf = backbone_channels[self.fine]
        top = f"block_{self.coarse[-1]}"
        self._names = (top, f"deblock_{self.coarse[-1]}",
                       f"block_{self.fine[-1]}")
        setattr(self, self._names[0],
                _Block(cc, in_channels[0], layer_nums[0], quant, device))
        setattr(self, self._names[1],
                _DeBlock(in_channels[0], in_channels[1], device))
        setattr(self, self._names[2],
                _Block(cf + in_channels[1], num_filters, layer_nums[1],
                       quant, device))
        self.out_channels = (num_filters,)

    def forward(self, feats):
        """feats: the backbone dict of (NCHW map, occupancy) pairs."""
        top, deblock, out = (getattr(self, n) for n in self._names)
        up = deblock(top(feats[self.coarse][0]))
        x = torch.cat([feats[self.fine][0], up], dim=1)
        return (out(x),)


@NECKS.register_module
class RPNV1(_TopDownNeck):
    coarse, fine = "conv5", "conv4"

    def __init__(self, layer_nums: Sequence[int], num_filters: int,
                 in_channels: Sequence[int], backbone_channels, quant=False,
                 device=None):
        super().__init__(layer_nums, in_channels, num_filters,
                         backbone_channels, quant, device)


@NECKS.register_module
class RPNV2(_TopDownNeck):
    coarse, fine = "conv4", "conv3"

    def __init__(self, layer_nums: Sequence[int], in_channels: Sequence[int],
                 num_filters: int, backbone_channels, quant=False,
                 device=None):
        super().__init__(layer_nums, in_channels, num_filters,
                         backbone_channels, quant, device)


@NECKS.register_module
class RPNG(nn.Module):
    """Two-scale top-down FPN: block on conv5, upsample, concat conv4,
    block (the stride-8 output `x4b`), upsample, concat conv3, block (the
    stride-4 output `x3b`). Returns (x4b, x3b)."""

    def __init__(self, layer_nums: Sequence[int], in_channels: Sequence[int],
                 num_filters: Sequence[int], backbone_channels, quant=False,
                 device=None):
        super().__init__()
        c3, c4, c5 = (backbone_channels[k] for k in ("conv3", "conv4",
                                                     "conv5"))
        f4, f3 = num_filters
        self.block_5 = _Block(c5, in_channels[0], layer_nums[0], quant,
                              device)
        self.top_down_54 = _DeBlock(in_channels[0], in_channels[1], device)
        self.block_4 = _Block(c4 + in_channels[1], f4, layer_nums[0], quant,
                              device)
        self.top_down_43 = _DeBlock(f4, in_channels[2], device)
        self.block_3 = _Block(c3 + in_channels[2], f3, layer_nums[1], quant,
                              device)
        self.out_channels = (f4, f3)

    def forward(self, feats):
        """feats: the backbone dict of (NCHW map, occupancy) pairs."""
        up54 = self.top_down_54(self.block_5(feats["conv5"][0]))
        x4b = self.block_4(torch.cat([feats["conv4"][0], up54], dim=1))
        up43 = self.top_down_43(x4b)
        x3b = self.block_3(torch.cat([feats["conv3"][0], up43], dim=1))
        return (x4b, x3b)


@NECKS.register_module
class RPNGV2(nn.Module):
    """RPNG whose lateral maps first pass a 3x3 conv + BN + ReLU to half
    of their output block's width (`reduce_4`, `reduce_3`); the upsampled
    maps are that wide too."""

    def __init__(self, layer_nums: Sequence[int], in_channels: Sequence[int],
                 num_filters: Sequence[int], backbone_channels, quant=False,
                 device=None):
        super().__init__()
        c3, c4, c5 = (backbone_channels[k] for k in ("conv3", "conv4",
                                                     "conv5"))
        f4, f3 = num_filters
        self.reduce_4 = _ConvBNReLU(c4, f4 // 2, quant, device)
        self.block_5 = _Block(c5, in_channels[0], layer_nums[0], quant,
                              device)
        self.top_down_54 = _DeBlock(in_channels[0], f4 // 2, device)
        self.block_4 = _Block(f4 // 2 * 2, f4, layer_nums[0], quant, device)
        self.reduce_3 = _ConvBNReLU(c3, f3 // 2, quant, device)
        self.top_down_43 = _DeBlock(f4, f3 // 2, device)
        self.block_3 = _Block(f3 // 2 * 2, f3, layer_nums[1], quant, device)
        self.out_channels = (f4, f3)

    def forward(self, feats):
        r4 = self.reduce_4(feats["conv4"][0])
        up54 = self.top_down_54(self.block_5(feats["conv5"][0]))
        x4b = self.block_4(torch.cat([r4, up54], dim=1))
        r3 = self.reduce_3(feats["conv3"][0])
        x3b = self.block_3(torch.cat([r3, self.top_down_43(x4b)], dim=1))
        return (x4b, x3b)


@NECKS.register_module
class RPN(nn.Module):
    """The legacy generic multi-scale neck (`det3d/models/necks/rpn.py:
    15-134`; JAX `rpn.py:212-272`), kept for the reference's legacy
    configs. Stage i: a 3x3 conv of stride `ds_layer_strides[i]` + BN +
    ReLU (`block{i}_conv0`, `block{i}_bn0`), then `layer_nums[i]`
    conv + BN + ReLU units (`block{i}_conv{j}`, int8 through K4 per
    tensor with `quant`). The last `len(us_layer_strides)` stages each
    feed an up path: a bias-free `ConvTranspose` of kernel and stride
    `us_layer_strides[k]` (> 1) or a 1x1 conv (stride 1) (`deblock{k}`),
    + BN (`deblock{k}_bn`) + ReLU; the up paths' maps are concatenated
    (else the last stage's map is the output). Reads the last key of the
    backbone's dict (sorted, as `_feat` does: `conv5` of a PillarResNet).
    Up strides are integers, as the JAX module takes them (the reference's
    fractional strides are not).

    The entry conv and the up path compute as `_DeBlock` (f32 sums, the
    BN unfolded); the units as `_ConvBNReLU`."""

    def __init__(self, layer_nums: Sequence[int],
                 ds_layer_strides: Sequence[int],
                 ds_num_filters: Sequence[int],
                 us_layer_strides: Sequence[int],
                 us_num_filters: Sequence[int], in_channels: int,
                 backbone_channels=None, quant=False, device=None):
        super().__init__()
        n = len(layer_nums)
        if len(ds_layer_strides) != n or len(ds_num_filters) != n \
                or len(us_layer_strides) != len(us_num_filters) \
                or len(us_layer_strides) > n:
            raise ValueError("RPN: layer_nums, ds_layer_strides and "
                             "ds_num_filters must have one entry a stage, "
                             "us_layer_strides and us_num_filters one an "
                             "up path, at most one a stage")
        for st in list(ds_layer_strides) + list(us_layer_strides):
            if int(st) != st or st < 1:
                raise ValueError(f"RPN: strides must be integers >= 1, got "
                                 f"{st}")
        self.layer_nums = [int(k) for k in layer_nums]
        self.up_start = n - len(us_layer_strides)
        cin = (in_channels if not backbone_channels
               else backbone_channels[sorted(backbone_channels)[-1]])
        for i, feats in enumerate(ds_num_filters):
            setattr(self, f"block{i}_conv0", MaskedConv(
                cin, feats, 3, int(ds_layer_strides[i]), use_bias=False,
                init="xavier", device=device))
            setattr(self, f"block{i}_bn0",
                    MaskedBatchNorm(feats, device=device))
            for j in range(self.layer_nums[i]):
                setattr(self, f"block{i}_conv{j + 1}",
                        _ConvBNReLU(feats, feats, quant, device))
            if i >= self.up_start:
                k = i - self.up_start
                st, uf = int(us_layer_strides[k]), us_num_filters[k]
                up = (ConvTranspose(feats, uf, size=st, device=device)
                      if st > 1 else MaskedConv(
                          feats, uf, 1, use_bias=False, init="xavier",
                          device=device))
                setattr(self, f"deblock{k}", up)
                setattr(self, f"deblock{k}_bn",
                        MaskedBatchNorm(uf, device=device))
            cin = feats
        self.out_channels = ((sum(us_num_filters),) if us_num_filters
                             else (ds_num_filters[-1],))

    def forward(self, feats):
        """feats: the backbone's dict of (NCHW map, occupancy) pairs (its
        last key's map is read), a pair, or a map -> (map,)."""
        x = feats[sorted(feats)[-1]] if isinstance(feats, dict) else feats
        if isinstance(x, tuple):
            x = x[0]
        ups = []
        for i, n in enumerate(self.layer_nums):
            x = _conv_bn_relu_f32(getattr(self, f"block{i}_conv0"),
                                  getattr(self, f"block{i}_bn0"), x)
            for j in range(n):
                x = getattr(self, f"block{i}_conv{j + 1}")(x)
            if i >= self.up_start:
                k = i - self.up_start
                ups.append(_conv_bn_relu_f32(
                    getattr(self, f"deblock{k}"),
                    getattr(self, f"deblock{k}_bn"), x))
        return (torch.cat(ups, dim=1) if ups else x,)
