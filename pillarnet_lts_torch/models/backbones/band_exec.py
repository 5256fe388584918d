"""Band execution of the sparse ResNet blocks under spatial sharding.

The same modules (`Sparse2DBasicBlock[V]`, `SparseDownStage`), the same
parameters and the same BN statistics as the masked-dense forward, run on
this rank's band of map rows (`parallel/spatial.py`). Each 3x3 conv reads
its input with one halo row on each side (`halo_exchange_h`) and runs as
`base.py::conv_bn_act` over the halo'd rows, every path of it unchanged
(the folded f32 / bf16 conv, K4's fused int8 epilogue, the training conv
and masked BN): the mask and the residual take a zero row on each side,
and the output's halo rows are cropped. The zero mask rows keep the halo
sites out of the BN's statistics, which the sharded stages sum over the
group; the two extra rows cost 2 / h of a band of h rows.

The stride-2 conv: output row i reads input rows 2i - 1 .. 2i + 1, so a
band that starts at even row r0 needs the row above it and none below.
A conv that pads 1 on each side (K4 as `F.conv2d`) is fed a zero row,
the row r0 - 1 and the band, and its first output row (global row
r0 / 2 - 1) is dropped: the others then sit on the unsharded conv's
stride grid.

Every rank holds the reader's whole grid and occupancy (it runs the
reader on the whole cloud): the first conv's halo rows and every
occupancy (conv2's is `dilate_mask` of the whole one) are sliced from
them without a collective.
"""

import torch.nn.functional as F

from ...parallel import dist
from ...parallel.spatial import halo_exchange_h
from .base import conv_bn_act, dilate_mask, remat, site_mask


def band_rows(x, bands, rows=1):
    """This rank's band of a whole (replicated) NCHW map with `rows` halo
    rows on each side, zeros past the map's edge."""
    start, stop = bands[dist.rank()]
    height = x.shape[2]
    a, b = max(start - rows, 0), min(stop + rows, height)
    return F.pad(x[:, :, a:b], (0, 0, rows - (start - a), rows - (b - stop)))


def halo_mask(occ, band, dtype, above=1, below=1):
    """The band's {0, 1} multiplier (B, 1, rows, W) of a whole (B, H, W)
    occupancy, with zero rows above and below (the halo's)."""
    start, stop = band
    return F.pad(site_mask(occ[:, start:stop], dtype), (0, 0, above, below))


def halo_conv_bn_act(conv, bn, xh, mask_h, act=True, residual=None):
    """`conv_bn_act` of a band on its halo'd rows xh (one halo row on each
    side; `mask_h` from `halo_mask`) -> the band's rows. residual: the
    band's (no halo) or None."""
    if residual is not None:
        residual = F.pad(residual, (0, 0, 1, 1))
    y = conv_bn_act(conv, bn, xh, mask_h, bn.training, act, residual)
    return y[:, :, 1:-1]


def basic_block_band(block, x, mask_h, bands):
    """`Sparse2DBasicBlock.forward` on this rank's band x."""
    out = halo_conv_bn_act(block.conv1, block.bn1,
                           halo_exchange_h(x, bands), mask_h)
    return halo_conv_bn_act(block.conv2, block.bn2,
                            halo_exchange_h(out, bands), mask_h,
                            residual=x)


def basic_block_v_band(block, xh, mask_h, bands):
    """`Sparse2DBasicBlockV.forward` on this rank's band, given its input
    with the first conv's halo rows (`band_rows` of the reader's grid)."""
    x = halo_conv_bn_act(block.conv0, block.bn0, xh, mask_h, act=False)
    out = halo_conv_bn_act(block.conv1, block.bn1,
                           halo_exchange_h(x, bands), mask_h)
    return halo_conv_bn_act(block.conv2, block.bn2,
                            halo_exchange_h(out, bands), mask_h,
                            residual=x)


def _down_conv(stage, xin, mask_h):
    """The strided conv unit on [zero row, row r0 - 1, band], its first
    output row dropped."""
    y = conv_bn_act(stage.down_conv, stage.down_bn, xin, mask_h,
                    stage.training)
    return y[:, :, 1:]


def down_stage_band(stage, x, occ, bands, coarse):
    """`SparseDownStage.forward` (stride 2) on this rank's band x of its
    input, given the input's whole occupancy occ (B, H, W); `coarse` the
    output's bands (`spatial.coarse_bands`). Returns (the output's band,
    the output's whole occupancy)."""
    if stage.stride != 2:
        raise ValueError("band execution takes stride-2 stages")
    new_occ = dilate_mask(occ, stage.stride)
    band = coarse[dist.rank()]
    xin = F.pad(halo_exchange_h(x, bands, above=1, below=0),
                (0, 0, 1, 0))
    y = remat(stage.remat, _down_conv, stage, xin,
              halo_mask(new_occ, band, x.dtype, above=1, below=0))
    mask_h = halo_mask(new_occ, band, x.dtype)
    for i in range(stage.num_blocks):
        y = remat(stage.remat, basic_block_band, getattr(stage, f"block{i}"),
                  y, mask_h, coarse)
    return y, new_occ
