"""Second-stage BEV feature extraction (RoI-grid bilinear pooling).

Port of `pillarnet_lts_tpu/models/second_stage/bev_feature.py`
(`roi_grid_points`, `BEVStrideFeature`): fuse the neck's last map with
lateral backbone maps at `out_stride`, lay a rotated grid_size x grid_size
grid of points over each RoI and bilinear-sample the fused map at them.

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
outside the max-pooled occupancy. `BEVFeature` and `BEVFeatureExtractor`
(served by no config outside the legacy two-stage detector) are not
ported yet.
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
_OUT_CHANNELS = {1: 32, 2: 64, 4: 128}


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


@SECOND_STAGE.register_module
class BEVStrideFeature(nn.Module):
    """`in_channels`: channels of the BEV map it is given (the neck's last
    output); `backbone_channels` / `backbone_strides`: the backbone's, which
    the detector passes in."""

    def __init__(self, feature_sources: Sequence[str], pillar_size,
                 pc_range: Sequence[float], out_stride=4, grid_size=7,
                 in_channels=128, share_channels=64,
                 backbone_channels: Optional[Dict[str, int]] = None,
                 backbone_strides: Optional[Dict[str, int]] = None,
                 device=None):
        super().__init__()
        if out_stride not in _OUT_CHANNELS:
            raise ValueError(f"out_stride {out_stride} not in "
                             f"{sorted(_OUT_CHANNELS)}")
        out_ch = _OUT_CHANNELS[out_stride]
        strides = backbone_strides or {"conv3": 4}
        self.grid_size = grid_size
        self.pc_range = list(pc_range)
        self.inv_cell = f32_reciprocal(out_stride * pillar_size)

        def lateral(c_in, ratio):
            """(conv, stride of the down-path or 0)."""
            if ratio >= 1:
                k = int(ratio)
                if k > 1:
                    return ConvTranspose(c_in, out_ch, k, device=device), 0
                return MaskedConv(c_in, out_ch, 1, use_bias=False,
                                  init="xavier", device=device), 0
            k = int(round(1 / ratio))
            return MaskedConv(c_in, out_ch, k, stride=k, use_bias=True,
                              init="xavier", padding=0, device=device), k

        self.top_down_conv, _ = lateral(in_channels,
                                        strides["conv3"] / out_stride)
        self.top_down_bn = MaskedBatchNorm(out_ch, device=device)
        self.sources = []
        for src in feature_sources:
            if src not in _SOURCES:
                continue
            if backbone_channels is None:
                raise ValueError("BEVStrideFeature needs backbone_channels "
                                 "for its lateral sources")
            conv, down = lateral(backbone_channels[src],
                                 strides[src] / out_stride)
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

    def forward(self, bev_feature, backbone_features, rois):
        """bev_feature: (B, C, H3, W3) NCHW neck map at the conv3 scale;
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
