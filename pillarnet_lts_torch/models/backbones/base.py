"""Masked-dense building blocks with exact spconv semantics, eval path.

Port of `pillarnet_lts_tpu/models/backbones/base.py` in the plain layout:

- SubMConv2d: a dense 3x3 conv over a map whose inactive sites are exactly
  0 gives the submanifold sum, provided the output is re-zeroed at inactive
  sites before the next conv reads it. Every conv here re-zeroes by
  multiplying with the {0, 1} occupancy, so inactive sites are exactly 0
  between convs. (The JAX package's additive -inf re-zero gives the same
  values after the following ReLU; the multiply needs no such ordering.)
- SparseConv2d (strided): the occupancy dilates; the new mask is a 3x3
  max-pool of the old one with padding 1, spconv's output-site rule.
- Eval BatchNorm is folded into the conv weights and bias.

The TPU layout recasts (space-to-depth, H-packing, W-chunking, fused Pallas
int8 stages) rearrange the same math for the MXU and are not ported; the
JAX package's own tests pin them equal to this plain layout.

Layout: feature maps are contiguous NCHW tensors; masks are (B, 1, H, W)
{0, 1} floats; occupancies handed between stages are (B, H, W) bool, as in
the JAX package.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.init import normal_, xavier_uniform_
from ..utils.norm import MaskedBatchNorm


def dilate_mask(mask, stride: int = 2):
    """spconv SparseConv2d(k=3, stride, pad=1) output-site rule on a
    (B, H, W) bool occupancy."""
    m = F.max_pool2d(mask[:, None].to(torch.float32), kernel_size=3,
                     stride=stride, padding=1)
    return m[:, 0] > 0.5


def site_mask(occ, dtype):
    """(B, H, W) bool occupancy -> (B, 1, H, W) {0, 1} multiplier."""
    return occ[:, None].to(dtype)


class MaskedConv(nn.Module):
    """kxk conv over a masked-dense map; caller guarantees inactive sites are
    zero. `init` is 'kaiming' (He-normal over fan-out, the backbone and
    head) or 'xavier' (uniform, the neck)."""

    def __init__(self, in_features, features, kernel_size=3, stride=1,
                 use_bias=True, init="kaiming", bias_init=0.0, device=None):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.padding = (k - 1) // 2
        self.init = init
        self.bias_init = bias_init
        self.weight = nn.Parameter(
            torch.empty(features, in_features, k, k, device=device))
        self.bias = (nn.Parameter(torch.empty(features, device=device))
                     if use_bias else None)

    @torch.no_grad()
    def init_weights(self, generator):
        o, i, kh, kw = self.weight.shape
        if self.init == "xavier":
            xavier_uniform_(self.weight, kh * kw * i, kh * kw * o, generator)
        else:
            normal_(self.weight, (2.0 / (kh * kw * o)) ** 0.5, generator)
        if self.bias is not None:
            self.bias.fill_(self.bias_init)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)

    def folded_params(self, inv, shift):
        """Weight and bias with the following BN's affine folded in:
        BN(conv(x) + cb) = conv(x) * inv + (cb * inv + shift)."""
        b = self.bias * inv + shift if self.bias is not None else shift
        return self.weight * inv[:, None, None, None], b

    def folded(self, x, inv, shift):
        w, b = self.folded_params(inv, shift)
        return F.conv2d(x, w, b, self.stride, self.padding)


def conv_bn_act(conv: MaskedConv, bn: MaskedBatchNorm, x, mask, act=True):
    """conv -> folded BN -> re-zero at inactive sites -> optional ReLU.
    mask: (B, 1, H, W) {0, 1} multiplier or None (dense)."""
    inv, shift = bn.fold_factors()
    y = conv.folded(x, inv, shift)
    if mask is not None:
        y = y * mask
    return F.relu(y) if act else y


class Sparse2DBasicBlock(nn.Module):
    """Residual block of two SubM convs."""

    def __init__(self, planes, device=None):
        super().__init__()
        self.conv1 = MaskedConv(planes, planes, device=device)
        self.bn1 = MaskedBatchNorm(planes, device=device)
        self.conv2 = MaskedConv(planes, planes, device=device)
        self.bn2 = MaskedBatchNorm(planes, device=device)

    def forward(self, x, mask):
        out = conv_bn_act(self.conv1, self.bn1, x, mask)
        out = conv_bn_act(self.conv2, self.bn2, out, mask, act=False)
        return F.relu(out + x)


class Sparse2DBasicBlockV(nn.Module):
    """Entry block: an extra SubM conv + BN before the residual pair."""

    def __init__(self, planes, device=None):
        super().__init__()
        self.conv0 = MaskedConv(planes, planes, device=device)
        self.bn0 = MaskedBatchNorm(planes, device=device)
        self.conv1 = MaskedConv(planes, planes, device=device)
        self.bn1 = MaskedBatchNorm(planes, device=device)
        self.conv2 = MaskedConv(planes, planes, device=device)
        self.bn2 = MaskedBatchNorm(planes, device=device)

    def forward(self, x, mask):
        x = conv_bn_act(self.conv0, self.bn0, x, mask, act=False)
        out = conv_bn_act(self.conv1, self.bn1, x, mask)
        out = conv_bn_act(self.conv2, self.bn2, out, mask, act=False)
        return F.relu(out + x)


class SparseDownStage(nn.Module):
    """Strided SparseConv2d + BN + ReLU followed by N residual blocks
    (`block0`, `block1`, ...)."""

    def __init__(self, in_channels, channels, num_blocks, stride=2,
                 device=None):
        super().__init__()
        self.stride = stride
        self.num_blocks = num_blocks
        self.down_conv = MaskedConv(in_channels, channels, stride=stride,
                                    use_bias=False, device=device)
        self.down_bn = MaskedBatchNorm(channels, device=device)
        for i in range(num_blocks):
            setattr(self, f"block{i}", Sparse2DBasicBlock(channels, device))

    def forward(self, x, occ):
        """x (B, C, H, W) with zeros at inactive sites; occ (B, H, W) bool
        -> (y, new occupancy)."""
        new_occ = dilate_mask(occ, self.stride)
        mask = site_mask(new_occ, x.dtype)
        y = conv_bn_act(self.down_conv, self.down_bn, x, mask)
        for i in range(self.num_blocks):
            y = getattr(self, f"block{i}")(y, mask)
        return y, new_occ


class DenseConvBNReLU(nn.Module):
    """Dense conv + BN + ReLU (the conv5 stage)."""

    def __init__(self, features, stride=1, device=None):
        super().__init__()
        self.conv = MaskedConv(features, features, 3, stride,
                               use_bias=False, device=device)
        self.bn = MaskedBatchNorm(features, device=device)

    def forward(self, x):
        return conv_bn_act(self.conv, self.bn, x, None)
