"""PillarResNet BEV backbones (masked-dense), eval path.

Port of `pillarnet_lts_tpu/models/backbones/pillar_resnet.py` on the dense
grid branch, plain layout:

  conv1 @ stride 1 (C),  conv2 @ 2 (2C),  conv3 @ 4 (4C),  conv4 @ 8 (8C)
  [+ dense conv5 @ 16 (8C) for the non-'S' variants]

Block counts: 18 -> (2, 2, 2, 2) + conv5(1+2 dense); 34 -> (3, 4, 6, 3).
Takes the reader's NHWC grid and (B, H, W) occupancy; returns a dict
{'conv1'...'conv5'} of (contiguous NCHW features, (B, H, W) bool
occupancy) pairs, conv5 with occupancy None (it is dense).
"""

from typing import Tuple

from torch import nn

from ..registry import BACKBONES
from .base import (
    DenseConvBNReLU,
    Sparse2DBasicBlock,
    Sparse2DBasicBlockV,
    SparseDownStage,
    site_mask,
)


class _PillarResNetBase(nn.Module):
    conv1_blocks: int = 2
    stage_blocks: Tuple[int, int, int] = (2, 2, 2)
    with_conv5: bool = False

    def __init__(self, in_channels=32, device=None):
        super().__init__()
        c = self.in_channels = in_channels
        self.conv1_block0 = Sparse2DBasicBlockV(c, device=device)
        for i in range(1, self.conv1_blocks):
            setattr(self, f"conv1_block{i}", Sparse2DBasicBlock(c, device))
        self.conv2 = SparseDownStage(c, c * 2, self.stage_blocks[0],
                                     device=device)
        self.conv3 = SparseDownStage(c * 2, c * 4, self.stage_blocks[1],
                                     device=device)
        self.conv4 = SparseDownStage(c * 4, c * 8, self.stage_blocks[2],
                                     device=device)
        if self.with_conv5:
            self.conv5_down = DenseConvBNReLU(c * 8, stride=2, device=device)
            self.conv5_block0 = DenseConvBNReLU(c * 8, device=device)
            self.conv5_block1 = DenseConvBNReLU(c * 8, device=device)

    @property
    def backbone_channels(self):
        c = self.in_channels
        out = {"conv1": c, "conv2": c * 2, "conv3": c * 4, "conv4": c * 8}
        if self.with_conv5:
            out["conv5"] = c * 8
        return out

    def forward(self, grid, occ):
        # contiguous NCHW: cuDNN's f32 conv kernels are NCHW, and a
        # channels_last view of the NHWC grid makes every conv of every
        # stage transpose its input and output (~7.5 ms per flagship frame
        # on an H100); one copy of the grid here avoids all of them
        x = grid.permute(0, 3, 1, 2).contiguous()
        mask = site_mask(occ, x.dtype)
        for i in range(self.conv1_blocks):
            x = getattr(self, f"conv1_block{i}")(x, mask)
        out = {"conv1": (x, occ)}
        x2, m2 = self.conv2(x, occ)
        x3, m3 = self.conv3(x2, m2)
        x4, m4 = self.conv4(x3, m3)
        out.update(conv2=(x2, m2), conv3=(x3, m3), conv4=(x4, m4))
        if self.with_conv5:
            y = self.conv5_block1(self.conv5_block0(self.conv5_down(x4)))
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
