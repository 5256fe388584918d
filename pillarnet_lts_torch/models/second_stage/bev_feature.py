"""Second-stage BEV feature extraction: RoI-grid and box-centre bilinear
pooling.

Port of `pillarnet_lts_tpu/models/second_stage/bev_feature.py`:
`roi_grid_points`, `BEVStrideFeature` and `BEVFeature` fuse the neck's
last map with lateral backbone maps at `out_stride` (anchored at conv3
and at conv4), lay a rotated grid_size x grid_size grid of points over
each RoI and bilinear-sample the fused map at them; `BEVFeatureExtractor`
(the legacy `TwoStageDetector`'s) bilinear-samples the neck map at given
box-centre points.

Maps are NCHW, as everywhere in the port; the fused map is copied once to
channels-last so that every sample gathers contiguous rows of
`share_channels` floats (`ops/bilinear.py`). Outputs keep the JAX layout:
point features (B, R, G^2, C) grid point major, channel minor, and RoI
features (B, R, G^2 * C), the order the RoI head's first kernel rows
follow.

At eval the BN of each plain conv is folded into it
(`backbones/base.py::conv_bn_act`); after a transposed conv it runs
unfolded, as in the necks. The down-path (a source finer than
`out_stride`) is a k x k conv of stride k whose BN re-zeroes the sites
outside the max-pooled occupancy.

The convs compute in the dtype of the maps they are given, which is the
detector's compute dtype (bf16 maps: bf16 convs, BN folded in f32 and
cast); the grid follows the RoIs' dtype (f32: predict decodes in f32), so
the bilinear weights and sums are f32 and the sampled features come out
in f32 from a bf16 map too, as in the JAX package (an f32 weight times a
bf16 corner promotes).
"""

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.utils import device_constant, f32_reciprocal
from ...ops.bilinear import bilinear_interpolate
from ..backbones.base import MaskedConv, conv_bn_act
from ..necks.rpn import ConvTranspose
from ..registry import SECOND_STAGE
from ..utils.norm import MaskedBatchNorm

_SOURCES = ("conv1", "conv2", "conv3", "conv4")


def grid_fractions(grid_size):
    """(G^2, 2) f32 values (idx + 0.5) / G of the (x_idx, y_idx) pairs,
    row-major over x_idx (the `nonzero` order of a (G, G) grid). The
    division is a multiply by the f32 reciprocal of G, as XLA compiles
    the JAX package's (for G = 7 a true division differs in 56 of the 98
    values)."""
    g = grid_size
    ii = np.arange(g, dtype=np.float32)
    idx = np.stack([np.repeat(ii, g), np.tile(ii, g)], axis=-1)
    return (idx + np.float32(0.5)) * np.float32(f32_reciprocal(g))


def roi_grid_points(rois, grid_size):
    """(..., 7+) rois -> (..., grid^2, 2) rotated BEV grid points: cell
    centres in the box frame (l = (idx + 0.5) / G * dim - dim / 2), turned
    by the yaw (x = l_x cos - l_y sin, y = l_x sin + l_y cos) and shifted
    to the box centre."""
    center = rois[..., 0:2]
    dim = rois[..., 3:5]
    angle = rois[..., -1]
    frac = device_constant(grid_fractions(grid_size).reshape(-1).tolist(),
                           rois.device, rois.dtype).view(-1, 2)
    local = frac * dim[..., None, :] - dim[..., None, :] * 0.5
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    gx = local[..., 0] * c - local[..., 1] * s
    gy = local[..., 0] * s + local[..., 1] * c
    return torch.stack([gx, gy], dim=-1) + center[..., None, :]


def bev_cells(pts, pc_range, inv_cell):
    """(..., 2) metric BEV points -> (x, y) continuous cell coordinates of
    a map whose cells are 1 / inv_cell wide. Multiplies by the f32
    reciprocal, as XLA compiles the JAX package's division by the cell
    size (out_stride * pillar_size; 0.4 m on Waymo, inexact)."""
    return ((pts[..., 0] - pc_range[0]) * inv_cell,
            (pts[..., 1] - pc_range[1]) * inv_cell)


class _BEVFusion(nn.Module):
    """The fusion and RoI-grid pooling that `BEVStrideFeature` and
    `BEVFeature` share; they differ in the map the top-down path starts
    from (`anchor`), the widths per out_stride and which lateral ratios
    take the up path (`_up(ratio, out_stride)`)."""

    anchor = "conv3"
    out_channels = {1: 32, 2: 64, 4: 128}

    @staticmethod
    def _up(ratio, out_stride):
        return ratio >= 1

    def __init__(self, feature_sources: Sequence[str], pillar_size,
                 pc_range: Sequence[float], out_stride=4, grid_size=7,
                 in_channels=128, share_channels=64,
                 backbone_channels: Optional[Dict[str, int]] = None,
                 backbone_strides: Optional[Dict[str, int]] = None,
                 device=None):
        super().__init__()
        if out_stride not in self.out_channels:
            raise ValueError(f"out_stride {out_stride} not in "
                             f"{sorted(self.out_channels)}")
        out_ch = self.out_channels[out_stride]
        strides = backbone_strides or {self.anchor: 2 ** (
            _SOURCES.index(self.anchor))}
        self.grid_size = grid_size
        self.share_channels = share_channels
        self.pc_range = list(pc_range)
        self.inv_cell = f32_reciprocal(out_stride * pillar_size)

        def lateral(c_in, ratio, up):
            """(conv, stride of the down-path or 0)."""
            if up:
                k = int(ratio)
                if k > 1:
                    return ConvTranspose(c_in, out_ch, k, device=device), 0
                return MaskedConv(c_in, out_ch, 1, use_bias=False,
                                  init="xavier", device=device), 0
            k = int(round(1 / ratio))
            return MaskedConv(c_in, out_ch, k, stride=k, use_bias=True,
                              init="xavier", padding=0, device=device), k

        self.top_down_conv, _ = lateral(
            in_channels, strides[self.anchor] / out_stride, True)
        self.top_down_bn = MaskedBatchNorm(out_ch, device=device)
        self.sources = []
        for src in feature_sources:
            if src not in _SOURCES:
                continue
            if backbone_channels is None:
                raise ValueError(f"{type(self).__name__} needs "
                                 "backbone_channels for its lateral sources")
            ratio = strides[src] / out_stride
            conv, down = lateral(backbone_channels[src], ratio,
                                 self._up(ratio, out_stride))
            setattr(self, f"lat_{src}", conv)
            setattr(self, f"lat_bn_{src}", MaskedBatchNorm(out_ch,
                                                           device=device))
            self.sources.append((src, down))
        self.fusion_conv = MaskedConv(out_ch * (1 + len(self.sources)),
                                      share_channels, 3, use_bias=True,
                                      init="xavier", device=device)
        self.fusion_bn = MaskedBatchNorm(share_channels, device=device)

    def _branch(self, conv, bn, x, mask=None):
        if isinstance(conv, ConvTranspose):
            return F.relu(bn(conv(x)))
        return conv_bn_act(conv, bn, x, mask, self.training)

    def fuse(self, bev_feature, backbone_features):
        """The fused (B, share_channels, H', W') map at `out_stride`."""
        feats = [self._branch(self.top_down_conv, self.top_down_bn,
                              bev_feature)]
        for src, down in self.sources:
            x = backbone_features[src]
            x, occ = x if isinstance(x, tuple) else (x, None)
            mask = None
            if down and occ is not None:
                mask = (F.max_pool2d(occ[:, None].to(torch.float32), down,
                                     down) > 0.5).to(x.dtype)
            feats.append(self._branch(getattr(self, f"lat_{src}"),
                                      getattr(self, f"lat_bn_{src}"), x,
                                      mask))
        return conv_bn_act(self.fusion_conv, self.fusion_bn,
                           torch.cat(feats, dim=1), None, self.training)

    def roi_feature_width(self, bev_channels):
        """The width of a RoI's feature row: G^2 grid points of the fused
        map's channels."""
        del bev_channels
        return self.grid_size ** 2 * self.share_channels

    def forward(self, bev_feature, backbone_features, rois):
        """bev_feature: (B, C, H, W) NCHW neck map at the anchor's scale;
        backbone_features: the backbone's dict of (map, occupancy);
        rois: (B, R, 7+).

        Returns (roi_features (B, R, G^2 * C'), point_features
        (B, R, G^2, C'), point_coords (B, R, G^2, 2))."""
        fused = self.fuse(bev_feature, backbone_features)
        B, R = rois.shape[:2]
        pts = roi_grid_points(rois, self.grid_size)
        xs, ys = bev_cells(pts, self.pc_range, self.inv_cell)
        im = fused.permute(0, 2, 3, 1).contiguous()
        point_feats = bilinear_interpolate(
            im, xs.reshape(B, -1), ys.reshape(B, -1)).reshape(
                B, R, pts.shape[-2], -1)
        return point_feats.reshape(B, R, -1), point_feats, pts


@SECOND_STAGE.register_module
class BEVStrideFeature(_BEVFusion):
    """Top-down from the neck's conv3-scale map. `in_channels`: channels
    of the BEV map it is given (the neck's last output);
    `backbone_channels` / `backbone_strides`: the backbone's, which the
    detector passes in."""


@SECOND_STAGE.register_module
class BEVFeature(_BEVFusion):
    """The conv4-anchored variant (reference `bev_interpolation.py:18-158`):
    the top-down path starts from the stride-8 neck map, out_stride may be
    8, and a lateral source at the out_stride itself takes the down path
    (a 1 x 1 conv with bias, masked BN over its occupancy) unless
    out_stride is 8."""

    anchor = "conv4"
    out_channels = {1: 32, 2: 64, 4: 128, 8: 256}

    @staticmethod
    def _up(ratio, out_stride):
        return ratio > 1 or (out_stride == 8 and ratio == 1)

    def __init__(self, feature_sources: Sequence[str], pillar_size,
                 pc_range: Sequence[float], out_stride=4, grid_size=7,
                 in_channels=256, share_channels=64,
                 backbone_channels: Optional[Dict[str, int]] = None,
                 backbone_strides: Optional[Dict[str, int]] = None,
                 device=None):
        super().__init__(feature_sources, pillar_size, pc_range, out_stride,
                         grid_size, in_channels, share_channels,
                         backbone_channels, backbone_strides, device)


@SECOND_STAGE.register_module
class BEVFeatureExtractor(nn.Module):
    """Box-centre BEV pooling (reference `bird_eye_view.py:11-40`):
    bilinear-sample the neck map at given points. Has no parameters.

    The continuous cell coordinate is (p - pc_start) times the f32
    reciprocal of voxel_size[0] * out_stride (the x voxel size on both
    axes, as the JAX package), XLA's compiled division by that constant.
    With `num_point` > 1 the points come as num_point sections of K
    (`legacy.box_center_points`: centres, then the four edge midpoints),
    and each RoI's sections are laid side by side along the channels:
    (B, K, num_point * C)."""

    def __init__(self, pc_start: Sequence[float], voxel_size, out_stride,
                 num_point=1, device=None):
        super().__init__()
        del device
        self.pc_start = list(pc_start)
        self.inv_cell = f32_reciprocal(voxel_size[0] * out_stride)
        self.num_point = num_point

    def roi_feature_width(self, bev_channels):
        """The width of a RoI's feature row: num_point samples of the
        map's channels."""
        return self.num_point * bev_channels

    def forward(self, bev_feature, batch_centers):
        """bev_feature (B, C, H, W) NCHW; batch_centers (B, N, 2) ->
        (B, N / num_point, num_point * C) in the promotion of the map's
        dtype with the points' (f32 points: f32)."""
        xs, ys = bev_cells(batch_centers, self.pc_start, self.inv_cell)
        im = bev_feature.permute(0, 2, 3, 1).contiguous()
        feats = bilinear_interpolate(im, xs, ys)
        if self.num_point > 1:
            sec = feats.shape[1] // self.num_point
            feats = torch.cat([feats[:, i * sec:(i + 1) * sec]
                               for i in range(self.num_point)], dim=-1)
        return feats
