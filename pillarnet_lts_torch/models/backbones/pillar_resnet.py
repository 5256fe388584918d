"""PillarResNet BEV backbones (masked-dense, or compact in conv1/conv2).

Port of `pillarnet_lts_tpu/models/backbones/pillar_resnet.py` in the
plain layout:

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
(`pillarnet_lts_tpu/models/backbones/base.py:554-619`), in the compute
dtype's variant (bf16 or f32 activations, as the JAX kernel computes in
`x.dtype`); otherwise each of its convs runs on the per-conv int8 kernel.

Training (`module.train()`) runs every conv unfolded with masked batch
statistics (`base.py::conv_bn_act`). `remat=True` (the flagship config)
recomputes each stage-1 block, each down conv unit and residual block of
conv2-conv4 and each conv5 layer in the backward (`base.py::remat`), the
units the JAX package wraps in `nn.remat` (`pillar_resnet.py:180-190`,
`base.py:934-938`).

Spatial sharding (`bands`, the detector's `spatial_axis`): each rank runs
the stride-1 stage and conv2 on its band of grid rows, with halo rows
from the ranks that own them (`band_exec.py`, `parallel/spatial.py`);
conv2's output is gathered into the whole map on every rank, and conv3
onward run on it replicated, as the JAX package pins them
(`pillarnet_lts_tpu/models/detectors/pillarnet.py:91-130`). The fused
stage (K5) takes an n-row halo of the grid and the occupancy, since it
re-zeroes with the mask after each of its n convs, and its halo rows are
cropped. conv1 is gathered only for a consumer that reads it (`conv1`).

Compact execution: when the reader hands a `CompactPillars` table
(`reader.compact_kmax > 0`), conv1 and conv2 run as gather convs over the
active sites (`compact_exec.py`), with `compact_kmax2` coarse sites for
conv2 (0: 5/8 of the reader's budget, rounded up to a multiple of 8);
the conv1 and conv2 outputs are densified and conv3+ run as above. The
coarse sites past that budget drop out (the JAX package's semantics);
each eager forward keeps their count over the batch in
`dropped_coarse_sites`, a 0-d int64 tensor on the device. Not
with int8 (it raises, as the JAX package does); remat covers conv3+
only there.
"""

from typing import Tuple

import torch
from torch import nn

from ...ops.compact import (Neighbors, compact_to_dense,
                            down_conv_neighbor_table, down_conv_reverse,
                            downsample_site_ids, subm_neighbor_table,
                            subm_reverse)
from ...ops.int8_stage import CHANNELS as _STAGE_CHANNELS
from ...ops.int8_stage import int8_stage
from ...parallel import dist
from ...parallel.spatial import coarse_bands, gather_rows
from ..registry import BACKBONES
from .band_exec import (band_rows, basic_block_band, basic_block_v_band,
                        down_stage_band, halo_mask)
from .base import (
    DenseConvBNReLU,
    Sparse2DBasicBlock,
    Sparse2DBasicBlockV,
    SparseDownStage,
    nhwc,
    remat,
    site_mask,
)
from .compact_exec import CompactPillars, _ext


def _nchw(grid):
    """(B, H, W, C) map -> the NCHW map the convs take: contiguous in f32
    (cuDNN's f32 conv kernels are NCHW, and a channels_last view makes
    every conv of every stage transpose its input and output, ~7.5 ms per
    flagship frame on an H100; one copy here avoids all of them), the
    channels_last view in bf16 (the int8 kernels and cuDNN's bf16 convs
    read NHWC)."""
    x = grid.permute(0, 3, 1, 2)
    return x.contiguous() if x.dtype == torch.float32 else x


# the fused stage's frozen params (`freeze_int8`), in `int8_params` order
_FUSED_BUFFERS = ("fused_w_q", "fused_inv_s", "fused_dq", "fused_shift",
                  "fused_w_pack")


class _PillarResNetBase(nn.Module):
    conv1_blocks: int = 2
    stage_blocks: Tuple[int, int, int] = (2, 2, 2)
    with_conv5: bool = False

    def __init__(self, in_channels=32, quant=False, s2d_pallas=False,
                 remat=False, compact_kmax2=0, device=None):
        super().__init__()
        c = self.in_channels = in_channels
        self._quant = quant  # not `quant`: that marks a calibrated module
        self.s2d_pallas = s2d_pallas
        self.remat = remat
        self.compact_kmax2 = compact_kmax2
        self.dropped_coarse_sites = None
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
        if _FUSED_BUFFERS[0] in self._buffers:
            return [getattr(self, name) for name in _FUSED_BUFFERS]
        pairs = [p for blk in self._stage1_blocks() for p in blk.convs()]
        if not all(conv.quant_ready() for conv, _ in pairs):
            return None
        params = [conv.int8_params(bn) for conv, bn in pairs]
        key = tuple(conv._int8[0] for conv, _ in pairs)
        if self._fused[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                self._fused = (key, [torch.stack(p) for p in zip(*params)])
        return self._fused[1]

    def freeze_int8(self):
        """Register the fused stage's stacked params as non-persistent
        buffers (`MaskedConv.freeze_int8`'s step for K5; call it after the
        stage's convs are frozen), or drop them when the stage does not
        fuse."""
        self.thaw_int8()
        for name, t in zip(_FUSED_BUFFERS, self.fused_stage1_params() or ()):
            self.register_buffer(name, t, persistent=False)

    def thaw_int8(self):
        for name in _FUSED_BUFFERS:
            self._buffers.pop(name, None)

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

    def sharded_stages(self):
        """The modules that run on a rank's band under spatial sharding:
        the stride-1 stage's blocks and conv2."""
        return self._stage1_blocks() + [self.conv2]

    def forward(self, grid, occ, bands=None, conv1=True):
        """grid (B, H, W, C) and occ (B, H, W) from the dense reader, or a
        `CompactPillars` table (and occ None) from the compact one. With
        `bands` (`parallel.spatial.row_bands` of H), conv1 and conv2 run
        on this rank's band and are gathered (conv1 only with `conv1`;
        else it is left out of the dict)."""
        if bands is None:
            out = self.conv12(grid, occ)
        else:
            out = self._conv12_sharded(grid, occ, bands, conv1)
        x2, m2 = out["conv2"]
        x3, m3 = self.conv3(x2, m2)
        x4, m4 = self.conv4(x3, m3)
        out.update(conv3=(x3, m3), conv4=(x4, m4))
        if self.with_conv5:
            y = x4
            for layer in (self.conv5_down, self.conv5_block0,
                          self.conv5_block1):
                y = remat(self.remat, layer, y)
            out["conv5"] = (y, None)
        return out

    def conv12(self, grid, occ):
        """The stride-1 stage and conv2 alone: {'conv1': ..., 'conv2': ...}
        as `forward` returns them, on either reader's output."""
        if isinstance(grid, CompactPillars):
            return self._conv12_compact(grid)
        x = _nchw(grid)
        mask = site_mask(occ, x.dtype)
        fused = self.fused_stage1_params()
        if fused is not None:
            w_q, inv_s, dq, shift, w_pack = fused
            x = int8_stage(nhwc(x), w_q, inv_s, dq, shift, mask[:, 0],
                           w_pack=w_pack).permute(0, 3, 1, 2)
        else:
            for blk in self._stage1_blocks():
                x = remat(self.remat, blk, x, mask)
        return {"conv1": (x, occ), "conv2": self.conv2(x, occ)}

    def _conv12_sharded(self, grid, occ, bands, conv1):
        """conv1 and conv2 on this rank's band of the whole grid and
        occupancy, which every rank holds (`band_exec.py`), gathered."""
        height = grid.shape[1]
        band = bands[dist.rank()]
        x = _nchw(grid)
        fused = self.fused_stage1_params()
        if fused is not None:
            w_q, inv_s, dq, shift, w_pack = fused
            n = w_q.shape[0]
            xh = band_rows(x, bands, n)
            # the halo rows' true occupancy: the stage re-zeroes with it
            mask = band_rows(site_mask(occ, x.dtype), bands, n)
            y = int8_stage(nhwc(xh), w_q, inv_s, dq, shift, mask[:, 0],
                           w_pack=w_pack)
            x1 = y[:, n:-n].permute(0, 3, 1, 2)
        else:
            mask_h = halo_mask(occ, band, x.dtype)
            blocks = self._stage1_blocks()
            x1 = remat(self.remat, basic_block_v_band, blocks[0],
                       band_rows(x, bands), mask_h, bands)
            for blk in blocks[1:]:
                x1 = remat(self.remat, basic_block_band, blk, x1, mask_h,
                           bands)
        coarse = coarse_bands(bands, height)
        x2, m2 = down_stage_band(self.conv2, x1, occ, bands, coarse)
        out = {"conv2": (gather_rows(x2, coarse), m2)}
        if conv1:
            out["conv1"] = (gather_rows(x1, bands), occ)
        return out

    def coarse_budget(self, kmax):
        """conv2's coarse-site budget on the compact path for a reader
        budget of `kmax` sites: `compact_kmax2`, or 5/8 of `kmax` rounded
        up to a multiple of 8 (JAX :299)."""
        return self.compact_kmax2 or max(8, (kmax * 5 // 8 + 7) // 8 * 8)

    def _conv12_compact(self, cp):
        """conv1 + conv2 over the compact active-site table (gather convs),
        densified at the conv1 and conv2 outputs for conv3+ (the JAX
        package's `_forward_compact`, `pillar_resnet.py:278-350`): the
        reference's sparse execution (`PillarResNet.py:73-108`)."""
        if self._quant:
            raise NotImplementedError(
                "the int8 deploy path requires the dense reader "
                "(reader.compact_kmax=0); the compact gather execution "
                "reads conv kernels directly and would silently run "
                "full-precision")
        H, W = cp.height, cp.width
        kmax = cp.site_ids.shape[1]
        k2max = self.coarse_budget(kmax)
        dev = cp.rows.device
        grad = torch.is_grad_enabled()  # the reverse tables: training
        valid1 = (torch.arange(kmax, device=dev)[None, :]
                  < cp.k_valid[:, None])
        # the gathers index with int64: convert each table once
        nbr1 = subm_neighbor_table(cp.site_ids, cp.k_valid, H, W,
                                   kmax).long()
        nbr1 = Neighbors(nbr1, subm_reverse(nbr1, cp.k_valid) if grad
                         else None)
        x = cp.rows
        for blk in self._stage1_blocks():
            x = blk.compact(x, nbr1, valid1)

        H2, W2 = H // 2, W // 2
        ids2, k2, dropped = downsample_site_ids(cp.site_ids, cp.k_valid, H, W,
                                                k2max)
        if not torch.compiler.is_compiling():
            self.dropped_coarse_sites = dropped
        nbr_down = Neighbors(
            down_conv_neighbor_table(ids2, k2, cp.site_ids, cp.k_valid, H, W,
                                     kmax).long(),
            down_conv_reverse(cp.site_ids, cp.k_valid, ids2, k2, H, W, k2max)
            if grad else None)
        nbr2 = subm_neighbor_table(ids2, k2, H2, W2, k2max).long()
        nbr2 = Neighbors(nbr2, subm_reverse(nbr2, k2) if grad else None)
        valid2 = torch.arange(k2max, device=dev)[None, :] < k2[:, None]
        x2c = self.conv2.compact(x, nbr_down, nbr2, valid2)
        # densified for conv3+, which run dense as in the JAX package
        x2, m2 = compact_to_dense(_ext(x2c), ids2, k2, H2, W2)
        x1, m1 = compact_to_dense(_ext(x), cp.site_ids, cp.k_valid, H, W)
        return {"conv1": (_nchw(x1), m1), "conv2": (_nchw(x2), m2)}


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
