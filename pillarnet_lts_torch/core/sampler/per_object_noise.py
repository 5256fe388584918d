"""Per-object noise augmentation (numpy, host).

The port's own copy of `pillarnet_lts_tpu/core/sampler/per_object_noise.py`
(no config turns it on): for each box, up to `num_try` drawn (translation,
yaw) perturbations, the first whose footprint collides with no other
current box is taken and applied to the box and to the points inside it.
Group ids and per-object global rotation are not supported, as in the JAX
package. Draws come from `rng`, which the caller owns.
"""

import numpy as np

from ..bbox import box_np_ops


def _box_bev_corners(boxes5):
    """(N, 5) [x, y, w, l, yaw] -> (N, 4, 2) corners."""
    return box_np_ops.center_to_corner_box2d(boxes5[:, :2], boxes5[:, 2:4],
                                             boxes5[:, 4])


def noise_per_object_(gt_boxes, points, rng, valid_mask=None,
                      rotation_perturb=np.pi / 4, center_noise_std=1.0,
                      num_try=5):
    """In place: gt_boxes (N, 7+) with yaw last, points (M, C) with xyz
    first (or None). Returns (gt_boxes, points)."""
    num_boxes = gt_boxes.shape[0]
    if num_boxes == 0:
        return gt_boxes, points
    if not isinstance(rotation_perturb, (list, tuple, np.ndarray)):
        rotation_perturb = [-rotation_perturb, rotation_perturb]
    if not isinstance(center_noise_std, (list, tuple, np.ndarray)):
        center_noise_std = [center_noise_std] * 3
    if valid_mask is None:
        valid_mask = np.ones(num_boxes, bool)

    loc_noises = rng.normal(scale=np.asarray(center_noise_std),
                            size=[num_boxes, num_try, 3])
    rot_noises = rng.uniform(rotation_perturb[0], rotation_perturb[1],
                             size=[num_boxes, num_try])

    # accept or reject each box's tries in turn against the current boxes
    bev = np.concatenate([gt_boxes[:, 0:2], gt_boxes[:, 3:5],
                          gt_boxes[:, -1:]], axis=1)
    current_corners = _box_bev_corners(bev)
    chosen = np.full(num_boxes, -1, np.int64)
    for i in range(num_boxes):
        if not valid_mask[i]:
            continue
        others = np.delete(current_corners, i, axis=0)
        for t in range(num_try):
            cand = bev[i].copy()
            cand[:2] += loc_noises[i, t, :2]
            cand[4] += rot_noises[i, t]
            cand_c = _box_bev_corners(cand[None])
            if others.shape[0] == 0 or not box_np_ops.box_collision_test(
                    cand_c, others).any():
                chosen[i] = t
                current_corners[i] = cand_c[0]
                break

    # the taken transforms: first the points inside each box, then the box
    if points is not None and points.shape[0] > 0:
        inside = box_np_ops.points_in_rbbox(points, gt_boxes)
        for i in range(num_boxes):
            t = chosen[i]
            if t < 0:
                continue
            m = inside[:, i]
            if m.any():
                local = points[m, :3] - gt_boxes[i, :3]
                local[:, :2] = box_np_ops.rotation_points_single_angle(
                    np.concatenate([local[:, :2], np.zeros((m.sum(), 1))],
                                   axis=1),
                    rot_noises[i, t], axis=2)[:, :2]
                points[m, :3] = local + gt_boxes[i, :3] + loc_noises[i, t]
    for i in range(num_boxes):
        t = chosen[i]
        if t >= 0:
            gt_boxes[i, :3] += loc_noises[i, t]
            gt_boxes[i, -1] += rot_noises[i, t]
    return gt_boxes, points
