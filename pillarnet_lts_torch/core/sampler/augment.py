"""Global training augmentations (numpy, host).

The port's own copy of `pillarnet_lts_tpu/core/sampler/augment.py`, with
the reference's quirks: `global_scaling_v2` scales every box column but
yaw (velocities included), `global_translate_` draws the z offset from
std[0], and the flips negate velocities. Each function changes `gt_boxes`
and `points` in place and returns them.

Every draw comes from `rng`, a `np.random.RandomState` the caller owns
(the sample's generator, `res["rng"]`); the JAX package draws from
numpy's global state unless given one.
"""

import numpy as np

from ..bbox import box_np_ops


def random_flip_both(gt_boxes, points, rng, probability=0.5,
                     flip_coor=None):
    """Flip y (y -> -y), then x (x -> -x, or about `flip_coor`), each with
    `probability`; yaw and velocity follow."""
    if rng.rand() < probability:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, -1] = -gt_boxes[:, -1] + np.pi
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7] = -gt_boxes[:, 7]
    if rng.rand() < probability:
        if flip_coor is None:
            gt_boxes[:, 0] = -gt_boxes[:, 0]
            points[:, 0] = -points[:, 0]
        else:
            gt_boxes[:, 0] = flip_coor * 2 - gt_boxes[:, 0]
            points[:, 0] = flip_coor * 2 - points[:, 0]
        gt_boxes[:, -1] = -gt_boxes[:, -1] + 2 * np.pi
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 6] = -gt_boxes[:, 6]
    return gt_boxes, points


def global_rotation(gt_boxes, points, rng, rotation=np.pi / 4):
    """Turn the scene about z by an angle drawn uniformly from `rotation`
    ([lo, hi], or +-rotation)."""
    if not isinstance(rotation, (list, tuple, np.ndarray)):
        rotation = [-rotation, rotation]
    noise_rotation = rng.uniform(rotation[0], rotation[1])
    points[:, :3] = box_np_ops.rotation_points_single_angle(
        points[:, :3], noise_rotation, axis=2)
    gt_boxes[:, :3] = box_np_ops.rotation_points_single_angle(
        gt_boxes[:, :3], noise_rotation, axis=2)
    if gt_boxes.shape[1] > 7:
        gt_boxes[:, 6:8] = box_np_ops.rotation_points_single_angle(
            np.hstack([gt_boxes[:, 6:8], np.zeros((gt_boxes.shape[0], 1))]),
            noise_rotation, axis=2)[:, :2]
    gt_boxes[:, -1] += noise_rotation
    return gt_boxes, points


def global_scaling_v2(gt_boxes, points, rng, min_scale=0.95,
                      max_scale=1.05):
    """Scale the scene by a factor drawn from [min_scale, max_scale):
    point xyz and every box column but yaw."""
    noise_scale = rng.uniform(min_scale, max_scale)
    points[:, :3] *= noise_scale
    gt_boxes[:, :-1] *= noise_scale
    return gt_boxes, points


def global_translate_(gt_boxes, points, rng, noise_translate_std):
    """Shift the scene by N(0, std) per axis, z with std[0]; no draw when
    every std is 0."""
    if not isinstance(noise_translate_std, (list, tuple, np.ndarray)):
        noise_translate_std = np.array([noise_translate_std] * 3)
    if all(e == 0 for e in noise_translate_std):
        return gt_boxes, points
    noise_translate = np.array([
        rng.normal(0, noise_translate_std[0], 1),
        rng.normal(0, noise_translate_std[1], 1),
        rng.normal(0, noise_translate_std[0], 1),
    ]).T
    points[:, :3] += noise_translate
    gt_boxes[:, :3] += noise_translate
    return gt_boxes, points
