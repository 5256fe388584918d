"""Masked-dense building blocks with exact spconv semantics.

Port of `pillarnet_lts_tpu/models/backbones/base.py` in the plain layout:

- SubMConv2d: a dense 3x3 conv over a map whose inactive sites are exactly
  0 gives the submanifold sum, provided the output is re-zeroed at inactive
  sites before the next conv reads it. Every conv here re-zeroes by
  multiplying with the {0, 1} occupancy, so inactive sites are exactly 0
  between convs. (The JAX package's additive -inf re-zero gives the same
  values after the following ReLU; the multiply needs no such ordering.)
- SparseConv2d (strided): the occupancy dilates; the new mask is a 3x3
  max-pool of the old one with padding 1, spconv's output-site rule.
- Eval BatchNorm is folded into the conv weights and bias. In training
  (`module.train()`) the conv runs unfolded with its bias, and the masked
  BatchNorm takes its statistics over the active sites and re-zeroes the
  rest (`models/utils/norm.py`), as the JAX package's fine training path.
- `remat` runs a unit under `torch.utils.checkpoint` (non-reentrant): its
  activations are recomputed in the backward, the counterpart of the JAX
  package's `nn.remat`; the replay leaves the BN running statistics alone.
- Compact execution (`.compact(...)` of the blocks and the down stage):
  the same parameters over an active-site row table
  (`compact_exec.py`), the path `reader.compact_kmax` selects.
- int8 deploy (`quant=True`, calibrated): the conv core runs int8 through
  `ops/quant.py::int8_conv_bn_act` (the K4 kernel on CUDA, its bf16 or f32
  variant by the model's compute dtype), with the BN fold riding the
  dequant vector and the re-zero, residual and ReLU fused into its
  epilogue. Uncalibrated, a quant conv runs the bf16/f32 path.

The TPU layout recasts (space-to-depth, H-packing, W-chunking) rearrange
the same math for the MXU and are not ported; the JAX package's own tests
pin them equal to this plain layout.

Layout: feature maps are NCHW tensors, contiguous in f32 and channels_last
(NHWC in memory) in bf16, where the int8 kernels and cuDNN's bf16 convs
read NHWC; masks are (B, 1, H, W) {0, 1} multipliers in the map dtype;
occupancies handed between stages are (B, H, W) bool, as in the JAX
package.
"""

import contextlib

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ...ops.quant import (activation_scale, int8_conv_bn_act, kernel_int8,
                          pack_kernel, weight_scale)
from ..utils.init import normal_, xavier_uniform_
from ..utils.norm import MaskedBatchNorm, recomputing
from ..utils.quant import Calibrated
from .compact_exec import (basic_block_compact, basic_block_v_compact,
                           down_stage_compact)


def _replay_context():
    return contextlib.nullcontext(), recomputing()


def remat(enabled, fn, *args):
    """fn(*args), with its activations recomputed in the backward
    (`torch.utils.checkpoint`, non-reentrant) when `enabled` and autograd
    records; the replay runs under `norm.recomputing()`, so BN running
    statistics move once per step."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, context_fn=_replay_context)


def dilate_mask(mask, stride: int = 2):
    """spconv SparseConv2d(k=3, stride, pad=1) output-site rule on a
    (B, H, W) bool occupancy."""
    m = F.max_pool2d(mask[:, None].to(torch.float32), kernel_size=3,
                     stride=stride, padding=1)
    return m[:, 0] > 0.5


def site_mask(occ, dtype):
    """(B, H, W) bool occupancy -> (B, 1, H, W) {0, 1} multiplier."""
    return occ[:, None].to(dtype)


def nhwc(x):
    """NCHW tensor -> contiguous NHWC (a view of a channels_last map)."""
    return x.permute(0, 2, 3, 1).contiguous()


def state_key(*tensors):
    """Identity, storage and in-place version of each tensor: it changes
    whenever one is replaced, moved or written in place (a weight load,
    `init_weights`, a calibration)."""
    return tuple((id(t), t.data_ptr(), t._version) for t in tensors
                 if t is not None)


class MaskedConv(Calibrated, nn.Module):
    """kxk conv over a masked-dense map; caller guarantees inactive sites are
    zero. `init` is 'kaiming' (He-normal over fan-out, the backbone and
    head) or 'xavier' (uniform, the neck). `padding` defaults to
    (k - 1) // 2 on each side; a k x k conv of stride k (the second
    stage's down-path) takes 0, as flax's 'SAME' does there. `quant=True`
    adds the int8 deploy mode (calibrated input absmax buffer
    `in_absmax`)."""

    def __init__(self, in_features, features, kernel_size=3, stride=1,
                 use_bias=True, init="kaiming", bias_init=0.0, quant=False,
                 padding=None, device=None):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.padding = (k - 1) // 2 if padding is None else padding
        self.init = init
        self.bias_init = bias_init
        self.weight = nn.Parameter(
            torch.empty(features, in_features, k, k, device=device))
        self.bias = (nn.Parameter(torch.empty(features, device=device))
                     if use_bias else None)
        self._init_quant(quant, "in_absmax", (), device)
        self._int8 = (None, None)  # (state_key, int8_params)

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
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride,
                        self.padding)

    def folded_params(self, inv, shift):
        """Weight and bias with the following BN's affine folded in:
        BN(conv(x) + cb) = conv(x) * inv + (cb * inv + shift)."""
        b = self.bias * inv + shift if self.bias is not None else shift
        return self.weight * inv[:, None, None, None], b

    def folded(self, x, inv, shift):
        """The float path: folded conv in x.dtype (observed when
        calibrating)."""
        if self.observing:
            self.observe(x.abs().amax().float())
        w, b = self.folded_params(inv, shift)
        return F.conv2d(x, w.to(x.dtype), b.to(x.dtype), self.stride,
                        self.padding)

    def int8_params(self, bn):
        """(w_q HWIO int8, 1 / s_x, dq, shift, w_pack) of the int8 core
        with the following BN folded (`base.py:685-705`): the
        per-output-channel weight scale is taken over the raw kernel, and
        the BN factor rides dq = s_x * s_w * inv (multiplied left to
        right); w_pack is w_q in the CUDA kernel's layout
        (`ops.quant.pack_kernel`). Computed once per state of the weights,
        the scale and the BN (`state_key`)."""
        key = state_key(self.weight, self.bias, self.in_absmax, bn.weight,
                        bn.bias, bn.running_mean, bn.running_var)
        if self._int8[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                inv, shift = bn.fold_factors()
                s_x = activation_scale(self.in_absmax)
                s_w = weight_scale(self.weight)
                b = self.bias * inv + shift if self.bias is not None \
                    else shift
                w_q = kernel_int8(self.weight, s_w)
                params = (w_q, 1.0 / s_x, s_x * s_w * inv, b,
                          pack_kernel(w_q))
            self._int8 = (key, params)
        return self._int8[1]

    def int8(self, x, bn, mask=None, residual=None, act=True):
        """The int8 core with `bn` folded and the fused epilogue; NCHW in
        and out."""
        w_q, inv_s, dq, b, w_pack = self.int8_params(bn)
        y = int8_conv_bn_act(
            nhwc(x), w_q, inv_s, dq, b, self.stride,
            mask=None if mask is None else mask[:, 0],
            residual=None if residual is None else nhwc(residual), act=act,
            w_pack=w_pack)
        return y.permute(0, 3, 1, 2)


def conv_bn_act(conv: MaskedConv, bn: MaskedBatchNorm, x, mask, train,
                act=True, residual=None):
    """conv -> folded BN -> re-zero at inactive sites [-> + residual]
    -> optional ReLU. mask: (B, 1, H, W) {0, 1} multiplier or None (dense);
    train: the calling module's `training` flag.

    The residual is zero at inactive sites, so relu(y * m + r) here and the
    int8 epilogue's relu(y + r) * m agree. In training the BN is not
    folded: conv with its bias, then the masked BN with batch statistics
    (which re-zeroes)."""
    if train:
        y = bn(conv(x), mask)
    elif conv.quant_ready():
        return conv.int8(x, bn, mask, residual, act)
    else:
        y = conv.folded(x, *bn.fold_factors())
        if mask is not None:
            y = y * mask
    if residual is not None:
        y = y + residual
    return F.relu(y) if act else y


class Sparse2DBasicBlock(nn.Module):
    """Residual block of two SubM convs."""

    def __init__(self, planes, quant=False, device=None):
        super().__init__()
        self.conv1 = MaskedConv(planes, planes, quant=quant, device=device)
        self.bn1 = MaskedBatchNorm(planes, device=device)
        self.conv2 = MaskedConv(planes, planes, quant=quant, device=device)
        self.bn2 = MaskedBatchNorm(planes, device=device)

    def convs(self):
        """(conv, bn) pairs in execution order."""
        return [(self.conv1, self.bn1), (self.conv2, self.bn2)]

    def forward(self, x, mask):
        out = conv_bn_act(self.conv1, self.bn1, x, mask, self.training)
        return conv_bn_act(self.conv2, self.bn2, out, mask, self.training,
                           residual=x)

    def compact(self, rows, nbr, valid):
        """The block over compact active-site rows (`compact_exec.py`)."""
        return basic_block_compact(self, rows, nbr, valid, self.training)


class Sparse2DBasicBlockV(nn.Module):
    """Entry block: an extra SubM conv + BN before the residual pair."""

    def __init__(self, planes, quant=False, device=None):
        super().__init__()
        for i in range(3):
            setattr(self, f"conv{i}",
                    MaskedConv(planes, planes, quant=quant, device=device))
            setattr(self, f"bn{i}", MaskedBatchNorm(planes, device=device))

    def convs(self):
        return [(self.conv0, self.bn0), (self.conv1, self.bn1),
                (self.conv2, self.bn2)]

    def forward(self, x, mask):
        x = conv_bn_act(self.conv0, self.bn0, x, mask, self.training,
                        act=False)
        out = conv_bn_act(self.conv1, self.bn1, x, mask, self.training)
        return conv_bn_act(self.conv2, self.bn2, out, mask, self.training,
                           residual=x)

    def compact(self, rows, nbr, valid):
        return basic_block_v_compact(self, rows, nbr, valid, self.training)


class SparseDownStage(nn.Module):
    """Strided SparseConv2d + BN + ReLU followed by N residual blocks
    (`block0`, `block1`, ...). `remat`: the down conv unit and each block
    recompute their activations in the backward."""

    def __init__(self, in_channels, channels, num_blocks, stride=2,
                 quant=False, remat=False, device=None):
        super().__init__()
        self.stride = stride
        self.num_blocks = num_blocks
        self.remat = remat
        self.down_conv = MaskedConv(in_channels, channels, stride=stride,
                                    use_bias=False, quant=quant, device=device)
        self.down_bn = MaskedBatchNorm(channels, device=device)
        for i in range(num_blocks):
            setattr(self, f"block{i}",
                    Sparse2DBasicBlock(channels, quant, device))

    def forward(self, x, occ):
        """x (B, C, H, W) with zeros at inactive sites; occ (B, H, W) bool
        -> (y, new occupancy)."""
        new_occ = dilate_mask(occ, self.stride)
        mask = site_mask(new_occ, x.dtype)
        y = remat(self.remat, conv_bn_act, self.down_conv, self.down_bn, x,
                  mask, self.training)
        for i in range(self.num_blocks):
            y = remat(self.remat, getattr(self, f"block{i}"), y, mask)
        return y, new_occ

    def compact(self, rows_fine, nbr_down, nbr_coarse, valid_coarse):
        """The stage over compact rows: the strided conv gathers from the
        fine rows, the blocks run at the coarse level (no remat, as in the
        JAX package's compact path)."""
        return down_stage_compact(self, rows_fine, nbr_down, nbr_coarse,
                                  valid_coarse, self.training)


class DenseConvBNReLU(nn.Module):
    """Dense conv + BN + ReLU (the conv5 stage)."""

    def __init__(self, features, stride=1, quant=False, device=None):
        super().__init__()
        self.conv = MaskedConv(features, features, 3, stride,
                               use_bias=False, quant=quant, device=device)
        self.bn = MaskedBatchNorm(features, device=device)

    def forward(self, x):
        return conv_bn_act(self.conv, self.bn, x, None, self.training)
