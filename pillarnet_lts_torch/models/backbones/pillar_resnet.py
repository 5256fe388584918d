"""PillarResNet BEV backbones (masked-dense).

Port of `pillarnet_lts_tpu/models/backbones/pillar_resnet.py` on the dense
grid branch, plain layout:

  conv1 @ stride 1 (C),  conv2 @ 2 (2C),  conv3 @ 4 (4C),  conv4 @ 8 (8C)
  [+ dense conv5 @ 16 (8C) for the non-'S' variants]

Block counts: 18 -> (2, 2, 2, 2) + conv5(1+2 dense); 34 -> (3, 4, 6, 3).
Takes the reader's NHWC grid and (B, H, W) occupancy; returns a dict
{'conv1'...'conv5'} of (NCHW features, (B, H, W) bool occupancy) pairs,
conv5 with occupancy None (it is dense).

int8 deploy (`quant=True`): every conv runs int8 once calibrated. With
`s2d_pallas=True` (the JAX key of the fused Pallas stage) the calibrated
32-channel stride-1 stage runs as one fused kernel
(`ops/int8_stage.py::int8_stage`, K5), the counterpart of
`pallas_s2d_gate` + `_fused_conv_params` + `s2d_fused_stage`
(`pillarnet_lts_tpu/models/backbones/base.py:554-619`); otherwise each of
its convs runs on the per-conv int8 kernel.

Training (`module.train()`) runs every conv unfolded with masked batch
statistics (`base.py::conv_bn_act`). `remat=True` (the flagship config)
recomputes each stage-1 block, each down conv unit and residual block of
conv2-conv4 and each conv5 layer in the backward (`base.py::remat`), the
units the JAX package wraps in `nn.remat` (`pillar_resnet.py:180-190`,
`base.py:934-938`).
"""

from typing import Tuple

import torch
from torch import nn

from ...ops.int8_stage import CHANNELS as _STAGE_CHANNELS
from ...ops.int8_stage import int8_stage
from ..registry import BACKBONES
from .base import (
    DenseConvBNReLU,
    Sparse2DBasicBlock,
    Sparse2DBasicBlockV,
    SparseDownStage,
    nhwc,
    remat,
    site_mask,
)


class _PillarResNetBase(nn.Module):
    conv1_blocks: int = 2
    stage_blocks: Tuple[int, int, int] = (2, 2, 2)
    with_conv5: bool = False

    def __init__(self, in_channels=32, quant=False, s2d_pallas=False,
                 remat=False, device=None):
        super().__init__()
        c = self.in_channels = in_channels
        self.s2d_pallas = s2d_pallas
        self.remat = remat
        self._fused = (None, None)  # (state keys, stacked stage params)
        self.conv1_block0 = Sparse2DBasicBlockV(c, quant, device)
        for i in range(1, self.conv1_blocks):
            setattr(self, f"conv1_block{i}",
                    Sparse2DBasicBlock(c, quant, device))
        self.conv2 = SparseDownStage(c, c * 2, self.stage_blocks[0],
                                     quant=quant, remat=remat,
                                     device=device)
        self.conv3 = SparseDownStage(c * 2, c * 4, self.stage_blocks[1],
                                     quant=quant, remat=remat,
                                     device=device)
        self.conv4 = SparseDownStage(c * 4, c * 8, self.stage_blocks[2],
                                     quant=quant, remat=remat,
                                     device=device)
        if self.with_conv5:
            self.conv5_down = DenseConvBNReLU(c * 8, stride=2, quant=quant,
                                              device=device)
            self.conv5_block0 = DenseConvBNReLU(c * 8, quant=quant,
                                                device=device)
            self.conv5_block1 = DenseConvBNReLU(c * 8, quant=quant,
                                                device=device)

    def _stage1_blocks(self):
        return [getattr(self, f"conv1_block{i}")
                for i in range(self.conv1_blocks)]

    def fused_stage1_params(self):
        """Stacked int8 params of the stride-1 stage for the fused kernel
        (w_q, inv_s, dq, shift and the packed kernels, each stacked over the
        convs), or None unless `s2d_pallas` is set, the stage is 32 channels
        wide and every one of its convs is calibrated."""
        if not self.s2d_pallas or self.in_channels != _STAGE_CHANNELS:
            return None
        pairs = [p for blk in self._stage1_blocks() for p in blk.convs()]
        if not all(conv.quant_ready() for conv, _ in pairs):
            return None
        params = [conv.int8_params(bn) for conv, bn in pairs]
        key = tuple(conv._int8[0] for conv, _ in pairs)
        if self._fused[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                self._fused = (key, [torch.stack(p) for p in zip(*params)])
        return self._fused[1]

    @property
    def backbone_channels(self):
        c = self.in_channels
        out = {"conv1": c, "conv2": c * 2, "conv3": c * 4, "conv4": c * 8}
        if self.with_conv5:
            out["conv5"] = c * 8
        return out

    @property
    def backbone_strides(self):
        out = {"conv1": 1, "conv2": 2, "conv3": 4, "conv4": 8}
        if self.with_conv5:
            out["conv5"] = 16
        return out

    def forward(self, grid, occ):
        x = grid.permute(0, 3, 1, 2)
        if x.dtype == torch.float32:
            # contiguous NCHW: cuDNN's f32 conv kernels are NCHW, and a
            # channels_last view of the NHWC grid makes every conv of every
            # stage transpose its input and output (~7.5 ms per flagship
            # frame on an H100); one copy of the grid here avoids all of
            # them. bf16 keeps the channels_last view: the int8 kernels and
            # cuDNN's bf16 convs read NHWC.
            x = x.contiguous()
        mask = site_mask(occ, x.dtype)
        fused = self.fused_stage1_params()
        if fused is not None:
            w_q, inv_s, dq, shift, w_pack = fused
            x = int8_stage(nhwc(x), w_q, inv_s, dq, shift, mask[:, 0],
                           w_pack=w_pack).permute(0, 3, 1, 2)
        else:
            for blk in self._stage1_blocks():
                x = remat(self.remat, blk, x, mask)
        out = {"conv1": (x, occ)}
        x2, m2 = self.conv2(x, occ)
        x3, m3 = self.conv3(x2, m2)
        x4, m4 = self.conv4(x3, m3)
        out.update(conv2=(x2, m2), conv3=(x3, m3), conv4=(x4, m4))
        if self.with_conv5:
            y = x4
            for layer in (self.conv5_down, self.conv5_block0,
                          self.conv5_block1):
                y = remat(self.remat, layer, y)
            out["conv5"] = (y, None)
        return out


@BACKBONES.register_module
class PillarResNet18S(_PillarResNetBase):
    conv1_blocks = 2
    stage_blocks = (2, 2, 2)
    with_conv5 = False


@BACKBONES.register_module
class PillarResNet18(_PillarResNetBase):
    conv1_blocks = 2
    stage_blocks = (2, 2, 2)
    with_conv5 = True


@BACKBONES.register_module
class PillarResNet34S(_PillarResNetBase):
    conv1_blocks = 3
    stage_blocks = (4, 6, 3)
    with_conv5 = False


@BACKBONES.register_module
class PillarResNet34(_PillarResNetBase):
    conv1_blocks = 3
    stage_blocks = (4, 6, 3)
    with_conv5 = True
