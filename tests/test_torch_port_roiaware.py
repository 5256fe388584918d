"""PyTorch port, the box ops without a Pallas kernel
(`pillarnet_lts_torch/ops/roiaware_pool.py`, `ops/point_in_box.py`) against
the JAX package's, on `tests/test_roiaware_pool.py`'s shapes (400 points,
5 or 40 RoIs: one chunk and the 32-RoI chunked path).

Integer outputs are equal. Pooled features are bit-equal: the max takes
one of the inputs, and the average's sums run in the points' order in
both (XLA's CPU scatter-add and `index_add` on the CPU). Gradients in the
point features: JAX's `segment_max` splits a voxel's gradient evenly among
the points that tie for its max, as `scatter_reduce`'s amax backward does;
a point's gradient sums its RoIs' shares in another order than XLA's
transposed gather, so they are held within 1e-6 (about 8 f32 ulps of the
largest), and the tie split exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillarnet_lts_tpu.ops import point_in_box as jpib
from pillarnet_lts_tpu.ops import roiaware_pool as jpool
from pillarnet_lts_torch import ops
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_roiaware_pool import _data

OUT = (4, 4, 2)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("pool", ["max", "avg"])
@pytest.mark.parametrize("n", [5, 40])
def test_pool_equals_jax(n, pool):
    points, rois, feats = _data(0, n=n)
    want = np.asarray(jpool.roiaware_pool3d(
        jnp.asarray(rois), jnp.asarray(points), jnp.asarray(feats), OUT,
        pool=pool))
    got = ops.roiaware_pool3d(*_t(rois, points, feats), OUT, pool=pool)
    assert got.shape == (n, *OUT, 4) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).any(axis=-1).sum() > 10


def test_pool_takes_an_int_out_size():
    points, rois, feats = _data(3, n=3)
    got = ops.roiaware_pool3d(*_t(rois, points, feats), 3)
    want = np.asarray(jpool.roiaware_pool3d(
        jnp.asarray(rois), jnp.asarray(points), jnp.asarray(feats), 3))
    np.testing.assert_array_equal(got.numpy(), want)


def test_points_in_boxes_equal_jax():
    """The first containing box of each point, one sample and a batch of
    two (the second with other boxes)."""
    points, rois, _ = _data(1)
    points2, rois2, _ = _data(4)
    want = np.asarray(jpool.points_in_boxes_index(jnp.asarray(points),
                                                  jnp.asarray(rois)))
    got = ops.points_in_boxes_index(*_t(points, rois))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 10
    pb, bb = np.stack([points, points2]), np.stack([rois, rois2])
    want_b = np.asarray(jpool.points_in_boxes_batch(jnp.asarray(pb),
                                                    jnp.asarray(bb)))
    np.testing.assert_array_equal(
        ops.points_in_boxes_batch(*_t(pb, bb)).numpy(), want_b)


def test_points_in_rbbox_device_equals_jax():
    points, rois, _ = _data(2, p=600, n=12)
    want = np.asarray(jpib.points_in_rbbox_device(jnp.asarray(points),
                                                  jnp.asarray(rois)))
    got = ops.points_in_rbbox_device(*_t(points, rois))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 10


def _grads(rois, points, feats, weights, pool):
    """d(sum(pooled * weights)) / d(point_feats) in both packages."""
    want = np.asarray(jax.grad(lambda f: (jpool.roiaware_pool3d(
        jnp.asarray(rois), jnp.asarray(points), f, OUT, pool=pool)
        * jnp.asarray(weights)).sum())(jnp.asarray(feats)))
    f = torch.from_numpy(feats.copy()).requires_grad_(True)
    r, p, w = _t(rois, points, weights)
    (ops.roiaware_pool3d(r, p, f, OUT, pool=pool) * w).sum().backward()
    return f.grad.numpy(), want


@pytest.mark.parametrize("pool", ["max", "avg"])
@pytest.mark.parametrize("n", [5, 40])
def test_pool_gradients_equal_jax(n, pool):
    points, rois, feats = _data(2, p=120, n=n)
    weights = np.random.RandomState(9).randn(n, *OUT, 4).astype(np.float32)
    got, want = _grads(rois, points, feats, weights, pool)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(want).sum() > 0


def test_max_gradient_splits_tied_maxima_as_jax():
    """Points copied onto others (same place, same features) tie for their
    voxels' max: both packages give each of k tied points 1/k of the
    voxel's gradient, and a point that ties in several RoIs sums its
    shares."""
    points, rois, feats = _data(5, p=200, n=6)
    rng = np.random.RandomState(6)
    inside = np.flatnonzero(np.asarray(jpool.points_in_boxes_index(
        jnp.asarray(points), jnp.asarray(rois))) >= 0)
    src = rng.permutation(inside)
    half = src[:len(src) // 2]  # three copies: ties of three
    points = np.concatenate([points, points[src], points[half]])
    feats = np.concatenate([feats, feats[src], feats[half]])
    # a shared value: points of one voxel tie across different places too
    feats[::7, 0] = 3.0
    weights = np.ones((6, *OUT, 4), np.float32)
    got, want = _grads(rois, points, feats, weights, "max")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    shares = np.unique(np.round(want[want > 0], 6))
    assert np.any(np.isclose(shares, 1 / 3)) and np.any(np.isclose(shares,
                                                                   0.5))
