"""Dynamic pillar voxelization with static shapes, and the plain scatter-max.

Port of `pillarnet_lts_tpu/ops/voxelize.py`: points come padded to (B, N, C)
with a validity mask, per-point pillar ids are computed elementwise, and the
max-pool scatters straight into the dense (B, H, W, C) BEV grid.
`scatter_max_to_grid` is the plain PyTorch version of the pillar scatter-max
kernel (`csrc/pillar_scatter_max.cu`); `ops/scatter.py::pillar_scatter_max`
picks between the two by device.
"""

from typing import NamedTuple, Tuple

import torch


class PillarSpec(NamedTuple):
    """Static grid geometry."""

    pillar_size: float
    pc_range: Tuple[float, float, float, float, float, float]

    @property
    def width(self) -> int:
        return int(round((self.pc_range[3] - self.pc_range[0]) / self.pillar_size))

    @property
    def height(self) -> int:
        return int(round((self.pc_range[4] - self.pc_range[1]) / self.pillar_size))

    @property
    def x_offset(self) -> float:
        return self.pillar_size / 2.0 + self.pc_range[0]

    @property
    def y_offset(self) -> float:
        return self.pillar_size / 2.0 + self.pc_range[1]


def voxelize_points(points, points_mask, spec: PillarSpec):
    """Per-point pillar ids + PFE input features.

    Args:
      points: (B, N, C) padded points; channels [x, y, z, ...extra].
      points_mask: (B, N) bool validity.
      spec: grid geometry.

    Returns:
      feats: (B, N, 2 + C) [dx_center, dy_center, original C...]
      flat_ids: (B, N) int32 pillar id y*W + x; invalid points -> H*W.
      valid: (B, N) bool (mask AND in-range).
    """
    H, W = spec.height, spec.width
    x = points[..., 0]
    y = points[..., 1]
    # divide, not multiply by 1/size: a reciprocal moves points that sit on
    # pillar boundaries into the neighbouring pillar
    cx = torch.floor((x - spec.pc_range[0]) / spec.pillar_size).to(torch.int32)
    cy = torch.floor((y - spec.pc_range[1]) / spec.pillar_size).to(torch.int32)
    in_range = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
    valid = points_mask & in_range

    cx_c = cx.clamp(0, W - 1)
    cy_c = cy.clamp(0, H - 1)
    flat = torch.where(valid, cy_c * W + cx_c, H * W).to(torch.int32)

    center_x = cx_c.to(points.dtype) * spec.pillar_size + spec.x_offset
    center_y = cy_c.to(points.dtype) * spec.pillar_size + spec.y_offset
    rel = torch.stack([x - center_x, y - center_y], dim=-1)
    feats = torch.cat([rel, points], dim=-1)
    # zero padded rows so downstream masked reductions are clean
    feats = feats * valid[..., None].to(feats.dtype)
    return feats, flat, valid


def scatter_max_to_grid(point_feats, flat_ids, valid, height, width):
    """Segment-max point features into the dense BEV grid (plain version).

    Empty pillars come out 0; occupied pillars hold the per-channel max over
    their valid points.

    Args:
      point_feats: (B, N, C) features (float, or the int8 deploy's codes).
      flat_ids: (B, N) int32; an id outside [0, H*W) drops its point (H*W
        is what `voxelize_points` gives a dropped point), as in the kernels
        and in JAX's `segment_max`.
      valid: (B, N) bool.
    Returns:
      grid: (B, H, W, C) in point_feats.dtype; occupancy: (B, H, W) bool.
    """
    B, N, C = point_feats.shape
    hw = height * width
    dtype = point_feats.dtype
    if dtype.is_floating_point:
        feats, neg = point_feats, torch.finfo(dtype).min
    else:  # int8 codes: the max runs in int32
        feats = point_feats.to(torch.int32)
        neg = torch.iinfo(torch.int32).min
    feats = torch.where(valid[..., None], feats, neg)
    ids = flat_ids.long()
    ids = torch.where((ids >= 0) & (ids < hw), ids, hw)
    grid = torch.full((B, hw + 1, C), neg, dtype=feats.dtype,
                      device=feats.device)
    grid.scatter_reduce_(1, ids[..., None].expand(B, N, C), feats,
                         reduce="amax", include_self=True)
    occ = torch.zeros((B, hw + 1), dtype=torch.int32, device=ids.device)
    occ.scatter_reduce_(1, ids, valid.to(torch.int32), reduce="amax",
                        include_self=True)
    occ = occ[:, :hw] > 0
    grid = torch.where(occ[..., None], grid[:, :hw], 0).to(dtype)
    return grid.reshape(B, height, width, C), occ.reshape(B, height, width)
