"""Numpy box geometry of the host data pipeline.

The port's own copy of `pillarnet_lts_tpu/core/bbox/box_np_ops.py`: boxes
are (x, y, z, w, l, h, [vx, vy,] yaw); yaw turns the corners by the
`rotation_2d` matrix; lidar boxes have origin (0.5, 0.5, 0.5) and turn
about z. `points_in_rbbox` (centred boxes) and `box_collision_test`
dispatch as the JAX package's do: to the host C++ library
(`pillarnet_lts_torch/native`) when it is built, else to the numpy route
here. The C++ computes in f32 with a `fabs` test, so at box faces it
need not equal numpy; the JAX package's library and the port's, built
from one source on one machine, give the same answers.

`points_in_rbbox`'s numpy route works through the cloud in chunks of
`_CHUNK` points, so a full Waymo frame against a few dozen boxes keeps its
temporaries to a few MB; every element is computed as in the unchunked
route.
"""

import numpy as np

from ... import native

_CHUNK = 16384


def limit_period(val, offset=0.5, period=np.pi):
    """Wrap angles into one period."""
    return val - np.floor(val / period + offset) * period


def corners_nd(dims, origin=0.5):
    """Box corners relative to the centre from per-axis lengths (N, ndim)
    -> (N, 2^ndim, ndim); in 2-D clockwise from the least corner:
    x0y0, x0y1, x1y1, x1y0."""
    ndim = int(dims.shape[1])
    corners_norm = np.stack(
        np.unravel_index(np.arange(2 ** ndim), [2] * ndim), axis=1
    ).astype(dims.dtype)
    if ndim == 2:
        corners_norm = corners_norm[[0, 1, 3, 2]]
    elif ndim == 3:
        corners_norm = corners_norm[[0, 1, 3, 2, 4, 5, 7, 6]]
    corners_norm = corners_norm - np.array(origin, dtype=dims.dtype)
    return (dims.reshape([-1, 1, ndim])
            * corners_norm.reshape([1, 2 ** ndim, ndim]))


def rotation_2d(points, angles):
    """Turn 2-D corner sets (N, P, 2) by per-set angles (N,): p @ [[cos,
    -sin], [sin, cos]]."""
    rot_sin = np.sin(angles)
    rot_cos = np.cos(angles)
    rot_mat_t = np.stack([np.stack([rot_cos, -rot_sin]),
                          np.stack([rot_sin, rot_cos])])
    return np.einsum("aij,jka->aik", points, rot_mat_t)


def _rotation_3d_rows(rot_sin, rot_cos, one, zero, axis):
    if axis == 1:
        return [[rot_cos, zero, -rot_sin], [zero, one, zero],
                [rot_sin, zero, rot_cos]]
    if axis in (2, -1):
        return [[rot_cos, -rot_sin, zero], [rot_sin, rot_cos, zero],
                [zero, zero, one]]
    if axis == 0:
        return [[one, zero, zero], [zero, rot_cos, -rot_sin],
                [zero, rot_sin, rot_cos]]
    raise ValueError("axis should be in range")


def rotation_3d_in_axis(points, angles, axis=0):
    """Turn point sets (N, P, 3) about one axis by per-set angles (N,)."""
    rot_sin = np.sin(angles)
    rot_cos = np.cos(angles)
    rows = _rotation_3d_rows(rot_sin, rot_cos, np.ones_like(rot_cos),
                             np.zeros_like(rot_cos), axis)
    rot_mat_t = np.stack([np.stack(r) for r in rows])
    return np.einsum("aij,jka->aik", points, rot_mat_t)


def rotation_points_single_angle(points, angle, axis=0):
    """Turn points (N, 3) by one angle: points @ R, with R in
    `points.dtype` (an f32 cloud turns in f32)."""
    rot_sin = np.sin(angle)
    rot_cos = np.cos(angle)
    rot_mat_t = np.array(_rotation_3d_rows(rot_sin, rot_cos, 1, 0, axis),
                         dtype=points.dtype)
    return points @ rot_mat_t


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    """(x, y), (w, l), yaw -> (N, 4, 2) BEV corners."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_2d(corners, angles)
    corners += centers.reshape([-1, 1, 2])
    return corners


def center_to_corner_box3d(centers, dims, angles=None,
                           origin=(0.5, 0.5, 0.5), axis=2):
    """3-D boxes -> (N, 8, 3) corners."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_3d_in_axis(corners, angles, axis=axis)
    corners += centers.reshape([-1, 1, 3])
    return corners


def corner_to_standup_nd(boxes_corner):
    """Corners (N, P, ndim) -> axis-aligned boxes (N, 2 ndim): mins, maxes."""
    return np.concatenate([boxes_corner.min(axis=1),
                           boxes_corner.max(axis=1)], axis=1)


def points_in_rbbox(points, rbbox, z_axis=2, origin=(0.5, 0.5, 0.5)):
    """(num_points, num_boxes) bool: point p lies in box b, faces
    included. Each point moves into each box's frame (its offset from the
    centre turned by -yaw) and is tested against the box's extent."""
    points = np.asarray(points)
    rbbox = np.asarray(rbbox)
    if rbbox.shape[0] == 0:
        return np.zeros((points.shape[0], 0), dtype=bool)
    if z_axis != 2:
        raise ValueError("only lidar (z-up) boxes are supported")
    if tuple(origin) == (0.5, 0.5, 0.5):
        out = native.points_in_rbbox(points, rbbox)
        if out is not None:
            return out
    centers = rbbox[:, :3]
    dims = rbbox[:, 3:6]
    angles = rbbox[:, -1]
    cos_t = np.cos(angles)
    sin_t = np.sin(angles)
    origin = np.array(origin, dtype=points.dtype)
    lo = -origin * dims
    hi = (1.0 - origin) * dims
    out = np.empty((points.shape[0], rbbox.shape[0]), dtype=bool)
    for s in range(0, points.shape[0], _CHUNK):
        rel = points[s:s + _CHUNK, None, :3] - centers[None, :, :]
        local_x = rel[..., 0] * cos_t - rel[..., 1] * sin_t
        local_y = rel[..., 0] * sin_t + rel[..., 1] * cos_t
        local_z = rel[..., 2]
        out[s:s + _CHUNK] = (
            (local_x >= lo[None, :, 0]) & (local_x <= hi[None, :, 0])
            & (local_y >= lo[None, :, 1]) & (local_y <= hi[None, :, 1])
            & (local_z >= lo[None, :, 2]) & (local_z <= hi[None, :, 2]))
    return out


def points_count_rbbox(points, rbbox, z_axis=2, origin=(0.5, 0.5, 0.5)):
    """Points in each box, (num_boxes,)."""
    return points_in_rbbox(points, rbbox, z_axis=z_axis,
                           origin=origin).sum(axis=0)


def _cross2d(o, a, b):
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
            - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))


def _segments_intersect(a0, a1, b0, b1):
    """Proper (strict) intersection of segments a0-a1 and b0-b1."""
    d1 = _cross2d(a0, a1, b0)
    d2 = _cross2d(a0, a1, b1)
    d3 = _cross2d(b0, b1, a0)
    d4 = _cross2d(b0, b1, a1)
    return ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))


_NEXT = np.array([1, 2, 3, 0])


def _contains(polys, pts, clockwise):
    """polys (A, 4, 2) convex quads, pts (B, 4, 2): (A, B), every corner of
    pts[b] strictly inside polys[a] (a cross product >= 0 is outside)."""
    vec = polys[:, _NEXT, :] - polys
    if not clockwise:
        vec = -vec
    dx = polys[:, None, :, None, 0] - pts[None, :, None, :, 0]
    dy = polys[:, None, :, None, 1] - pts[None, :, None, :, 1]
    cross = vec[:, None, :, None, 1] * dx - vec[:, None, :, None, 0] * dy
    return (cross < 0).all(axis=2).all(axis=2)


def box_collision_test(boxes, qboxes, clockwise=True):
    """(N, K) bool: BEV corner quads boxes[n] (N, 4, 2) and qboxes[k] (K,
    4, 2) collide, i.e. their standup boxes overlap and an edge of one
    crosses an edge of the other, or one holds all corners of the other."""
    n, k = boxes.shape[0], qboxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), dtype=bool)
    out = native.box_collision_test(boxes, qboxes)
    if out is not None:
        return out
    b_su = corner_to_standup_nd(boxes)
    q_su = corner_to_standup_nd(qboxes)
    iw = (np.minimum(b_su[:, None, 2], q_su[None, :, 2])
          - np.maximum(b_su[:, None, 0], q_su[None, :, 0]))
    ih = (np.minimum(b_su[:, None, 3], q_su[None, :, 3])
          - np.maximum(b_su[:, None, 1], q_su[None, :, 1]))
    candidates = (iw > 0) & (ih > 0)
    edge_hit = _segments_intersect(
        boxes[:, None, :, None, :], boxes[:, _NEXT, :][:, None, :, None, :],
        qboxes[None, :, None, :, :], qboxes[:, _NEXT, :][None, :, None, :, :],
    ).any(axis=(2, 3))
    qin_b = _contains(boxes, qboxes, clockwise)
    bin_q = _contains(qboxes, boxes, clockwise).T
    return candidates & (edge_hit | qin_b | bin_q)
