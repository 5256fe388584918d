"""Point-in-rotated-box test on either device.

Port of `pillarnet_lts_tpu/ops/point_in_box.py::points_in_rbbox_device`,
the counterpart of the reference's `roiaware_pool3d_cuda` point kernels
(`roiaware_pool3d_kernel.cu:328-354`) as broadcast math in each box's
frame: closed on every side, without the pooling's margin. The JAX
package computes it with XLA, not with a Pallas kernel.
"""

import torch


def points_in_rbbox_device(points, boxes):
    """points (P, 3+), boxes (N, 7) det3d (x, y, z, w, l, h, yaw) -> bool
    (P, N)."""
    rel = points[:, None, :3] - boxes[None, :, :3]
    ang = boxes[:, -1]
    cos_t = torch.cos(ang)
    sin_t = torch.sin(ang)
    lx = rel[..., 0] * cos_t - rel[..., 1] * sin_t
    ly = rel[..., 0] * sin_t + rel[..., 1] * cos_t
    lz = rel[..., 2]
    half = boxes[:, 3:6] * 0.5
    return ((lx.abs() <= half[None, :, 0]) & (ly.abs() <= half[None, :, 1])
            & (lz.abs() <= half[None, :, 2]))
