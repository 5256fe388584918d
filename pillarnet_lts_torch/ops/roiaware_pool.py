"""RoI-aware 3D voxel pooling and point-in-box indices.

Port of `pillarnet_lts_tpu/ops/roiaware_pool.py`, the counterpart of the
reference's `roiaware_pool3d_cuda` surface (`det3d/ops/roiaware_pool3d/
roiaware_pool3d_utils.py:42-150`): each point is assigned to a voxel of
every RoI's canonical (out_x, out_y, out_z) grid, and the point features
are max- or average-pooled per voxel. The JAX package computes this with
XLA (broadcast math and one segment reduction over flattened (roi, voxel)
ids), not with a Pallas kernel; so does this module with torch ops on
either device.

Semantics kept from the JAX package:

- det3d boxes (x, y, z, w, l, h, yaw), z the box centre, converted to
  pcdet (dx, dy, dz, heading): w and l swap, heading = -yaw - pi / 2
  (`_to_pcdet`);
- the z test is strict (|lz| <= dz / 2), x and y carry the reference's
  1e-5 margin (|lx| < dx / 2 + 1e-5);
- a point in several boxes belongs to the first (`points_in_boxes_index`);
- an empty voxel pools to 0, `avg` divides by max(count, 1), and every
  point is pooled (the reference drops a voxel's points past
  `max_pts_each_voxel`);
- the RoIs are pooled in chunks of 32, so the (P, chunk, C) table of
  features stays bounded.

The max's gradient in `point_feats` is JAX's `segment_max` gradient: a
voxel's gradient is split evenly among the points that tie for its max
(`scatter_reduce`'s amax backward does the same).
"""

import math

import torch

_MARGIN = 1e-5
# RoIs pooled at once: the broadcast (P, chunk, C) feature table stays
# bounded (~64 MB at P = 262k, C = 16 f32)
_ROI_CHUNK = 32


def _to_pcdet(boxes):
    """det3d (x, y, z, w, l, h, yaw) -> pcdet (x, y, z, dx, dy, dz,
    heading): w and l swap, heading = -yaw - pi / 2."""
    out = boxes[..., (0, 1, 2, 4, 3, 5, 6)]
    return torch.cat([out[..., :6], -boxes[..., 6:7] - math.pi / 2], -1)


def _canonical_coords(points, boxes_pcdet):
    """points (..., P, 3), boxes (..., N, 7) pcdet -> the points in each
    box's frame, (..., P, N) each of x, y, z, and the in-box mask."""
    rel = points[..., :, None, :3] - boxes_pcdet[..., None, :, :3]
    rz = boxes_pcdet[..., 6]
    cosa = torch.cos(-rz)[..., None, :]
    sina = torch.sin(-rz)[..., None, :]
    lx = rel[..., 0] * cosa - rel[..., 1] * sina
    ly = rel[..., 0] * sina + rel[..., 1] * cosa
    lz = rel[..., 2]
    half = (boxes_pcdet[..., 3:6] * 0.5)[..., None, :, :]
    inside = ((lz.abs() <= half[..., 2]) & (lx.abs() < half[..., 0] + _MARGIN)
              & (ly.abs() < half[..., 1] + _MARGIN))
    return lx, ly, lz, inside


def _first_box(inside):
    """(..., P, N) bool -> (..., P) int32 index of the first True, -1
    where none."""
    first = inside.to(torch.uint8).argmax(-1)
    return torch.where(inside.any(-1), first, -1).to(torch.int32)


def points_in_boxes_index(points, boxes):
    """The first box that contains each point, -1 for none: points (P,
    3+), boxes (N, 7) det3d -> (P,) int32 (`points_in_boxes_gpu` of one
    sample)."""
    *_, inside = _canonical_coords(points[:, :3], _to_pcdet(boxes))
    return _first_box(inside)


def points_in_boxes_batch(points, boxes):
    """Batched `points_in_boxes_index`: (B, M, 3+), (B, T, 7) -> (B, M)."""
    *_, inside = _canonical_coords(points[..., :3], _to_pcdet(boxes))
    return _first_box(inside)


def roiaware_pool3d(rois, points, point_feats, out_size, pool="max"):
    """Pool point features into each RoI's canonical voxel grid.

    rois (N, 7) det3d boxes, points (P, 3), point_feats (P, C), out_size
    an int or (out_x, out_y, out_z) -> (N, out_x, out_y, out_z, C)
    (`RoIAwarePool3dFunction.forward`). Empty voxels pool to 0.
    Differentiable in `point_feats`."""
    if pool not in ("max", "avg"):
        raise ValueError(f"pool {pool!r}: 'max' or 'avg'")
    if isinstance(out_size, int):
        out_size = (out_size,) * 3
    n = rois.shape[0]
    if n <= _ROI_CHUNK:
        return _pool_chunk(rois, points, point_feats, out_size, pool)
    pad = (-n) % _ROI_CHUNK
    # degenerate zero-size pad boxes hold no point but one at a pad box's
    # centre, and their blocks are dropped
    rois_p = torch.cat([rois, rois.new_zeros((pad, rois.shape[-1]))])
    pooled = [_pool_chunk(chunk, points, point_feats, out_size, pool)
              for chunk in rois_p.split(_ROI_CHUNK)]
    return torch.cat(pooled)[:n]


def _pool_chunk(rois, points, point_feats, out_size, pool):
    ox, oy, oz = out_size
    boxes = _to_pcdet(rois)
    lx, ly, lz, inside = _canonical_coords(points[:, :3], boxes)
    n, p, c = rois.shape[0], points.shape[0], point_feats.shape[-1]
    dims = boxes[:, 3:6]

    # voxel index: floor((local + d / 2) * out / d), clamped
    def vidx(local, d, out):
        safe = torch.where(d > 0, d, torch.ones_like(d))
        i = torch.floor((local + d[None, :] * 0.5) * out / safe[None, :])
        return i.clamp(0, out - 1).to(torch.int64)

    vox = ((vidx(lx, dims[:, 0], ox) * oy + vidx(ly, dims[:, 1], oy)) * oz
           + vidx(lz, dims[:, 2], oz))
    nvox = ox * oy * oz
    roi = torch.arange(n, device=rois.device)[None, :]
    seg = torch.where(inside, roi * nvox + vox, n * nvox).reshape(-1)
    flat = point_feats[:, None, :].expand(p, n, c).reshape(-1, c)
    index = seg[:, None].expand(-1, c)
    count = torch.zeros(n * nvox + 1, dtype=point_feats.dtype,
                        device=rois.device).index_add_(
        0, seg, torch.ones_like(seg, dtype=point_feats.dtype))
    if pool == "max":
        init = torch.full((n * nvox + 1, c), -math.inf,
                          dtype=point_feats.dtype, device=rois.device)
        pooled = init.scatter_reduce(0, index, flat, "amax")
        pooled = torch.where((count > 0)[:, None], pooled,
                             torch.zeros((), dtype=pooled.dtype,
                                         device=pooled.device))
    else:
        total = torch.zeros((n * nvox + 1, c), dtype=point_feats.dtype,
                            device=rois.device).index_add(0, seg, flat)
        pooled = total / count.clamp_min(1.0)[:, None]
    return pooled[:n * nvox].reshape(n, ox, oy, oz, c)
