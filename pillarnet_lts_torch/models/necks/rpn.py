"""Dense BEV FPN necks RPNV1, RPNV2, RPNG and RPNGV2.

Port of `pillarnet_lts_tpu/models/necks/rpn.py`:

- RPNV1: conv5 -> block -> deconv x2 -> concat conv4 -> block; one output
  at stride 8.
- RPNV2: conv4 -> block -> deconv x2 -> concat conv3 -> block; one output
  at stride 4.
- RPNG: top-down 5 -> 4 -> 3; two outputs, at strides 8 and 4 (the FPN
  of the two-stage and `*_fpn_waymo` configs).
- RPNGV2: RPNG with 3x3 'reduce' convs on the lateral maps.

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
        # the transposed conv accumulates the x.dtype operands in f32 and
        # feeds the f32 BN unrounded; one rounding to x.dtype after the BN.
        # That is what the JAX package computes under jit, where XLA folds
        # the conv output's bf16 round trip into the BN's f32 convert.
        w = self.ConvTranspose_0.weight.to(x.dtype).float()
        y = F.conv_transpose2d(x.float(), w, stride=2)
        return F.relu(self.MaskedBatchNorm_0(y).to(x.dtype))


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
