"""PyTorch port: rotated-BEV overlap and rotated NMS against the JAX package,
on the same numpy inputs.

Tolerances: intersection areas and IoUs 1e-4 (what `tests/test_pallas_iou.py`
holds the TPU kernel to; both sides round products of ~20 m coordinates);
corners 1e-5; NMS keep sets equal, on inputs whose kept-pair IoUs keep a
1e-4 margin from the threshold. The CUDA kernel against the plain version
is in `test_torch_port_cuda.py` (needs a card).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pillarnet_lts_tpu.ops import iou3d as jiou
from pillarnet_lts_tpu.ops import nms as jnms
from pillarnet_lts_tpu.ops.pallas.iou_kernel import (
    convex_intersection_area_pallas,
)
from pillarnet_lts_torch.ops import _kernels
from pillarnet_lts_torch.ops import iou3d as tiou
from pillarnet_lts_torch.ops import nms as tnms
import test_torch_port_threads  # noqa: F401  (one torch thread)


def _bev(n, seed, span=20.0):
    """pcdet BEV boxes with identical and edge-touching pairs appended."""
    rng = np.random.RandomState(seed)
    b = np.zeros((n, 5), np.float32)
    b[:, 0:2] = rng.uniform(-span, span, (n, 2))
    b[:, 2:4] = rng.uniform(0.3, 6, (n, 2))
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    special = np.array(
        [
            [0.0, 0.0, 2.0, 4.0, 0.3],
            [0.0, 0.0, 2.0, 4.0, 0.3],  # identical
            [2.0, 0.0, 2.0, 4.0, 0.0],
            [0.0, 0.0, 2.0, 4.0, 0.0],  # shares an edge with the previous
            [0.0, 4.0, 2.0, 4.0, 0.0],  # shares an edge with the previous
        ],
        np.float32,
    )
    return np.concatenate([special, b])


def _det_boxes(k, seed):
    """det3d (K, 9) boxes in clusters, so NMS has work to do."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(-30, 30, (12, 2))
    b = np.zeros((k, 9), np.float32)
    b[:, 0:2] = centres[rng.randint(0, 12, k)] + rng.randn(k, 2) * 1.2
    b[:, 2] = rng.uniform(-2, 0, k)
    b[:, 3:6] = rng.uniform(0.5, 5, (k, 3))
    b[:, 6:8] = rng.randn(k, 2)
    b[:, 8] = rng.uniform(-np.pi, np.pi, k)
    return b


def test_corners_match_jax():
    b = _bev(64, 0)
    np.testing.assert_allclose(
        tiou.box_corners_bev(torch.from_numpy(b)).numpy(),
        np.asarray(jiou.box_corners_bev(jnp.asarray(b))), rtol=0, atol=1e-5)
    d = _det_boxes(32, 1)
    np.testing.assert_allclose(
        tiou.to_pcdet_bev(torch.from_numpy(d)).numpy(),
        np.asarray(jiou.to_pcdet_bev(jnp.asarray(d))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_area_matches_jax(seed):
    b = _bev(59, seed)
    ca_j = jiou.box_corners_bev(jnp.asarray(b))
    pa, pb = jnp.broadcast_arrays(ca_j[:, None], ca_j[None, :])
    want = np.asarray(jax.jit(jiou._convex_intersection_area)(pa, pb))

    c = torch.from_numpy(np.array(ca_j))  # identical corners on both sides
    got = tiou.convex_intersection_area(c, c).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # identical boxes overlap fully, edge-touching ones not at all
    np.testing.assert_allclose(got[0, 1], 8.0, atol=1e-4)
    assert abs(got[2, 3]) < 1e-4 and abs(got[3, 4]) < 1e-4


def test_plain_area_matches_pallas_interpret():
    a = _bev(11, 2)
    b = _bev(131, 3)
    ca = jiou.box_corners_bev(jnp.asarray(a))
    cb = jiou.box_corners_bev(jnp.asarray(b))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(convex_intersection_area_pallas(ca, cb))
    got = tiou.convex_intersection_area(
        torch.from_numpy(np.array(ca)), torch.from_numpy(np.array(cb)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_rotated_iou_matches_jax_batched():
    # the port batches tasks along a leading dim; the JAX package vmaps
    b = np.stack([_bev(40, s) for s in (4, 5, 6)])
    jiou_bev = jax.jit(jiou.rotated_iou_bev)
    want = np.stack([np.asarray(jiou_bev(jnp.asarray(x), jnp.asarray(x)))
                     for x in b])
    got = tiou.rotated_iou_bev(torch.from_numpy(b), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed,thresh", [(2, 0.2), (3, 0.5), (6, 0.1)])
def test_rotated_nms_keep_set_matches_jax(seed, thresh):
    T, K, post = 3, 96, 80
    boxes = np.stack([_det_boxes(K, seed + 10 * t) for t in range(T)])
    valid = np.random.RandomState(seed).rand(T, K) > 0.1
    scores = np.zeros((T, K), np.float32)

    idx, mask = tnms.rotated_nms(torch.from_numpy(boxes),
                                 torch.from_numpy(scores),
                                 torch.from_numpy(valid), thresh, post)
    bev = tiou.to_pcdet_bev(torch.from_numpy(boxes))
    iou = tiou.rotated_iou_bev(bev, bev).numpy()
    later = np.arange(K)[None, :] > np.arange(K)[:, None]
    for t in range(T):
        # the decisions the keep set rests on (kept row j against every later
        # valid candidate) keep a margin from the threshold
        kept = idx[t].numpy()[mask[t].numpy()]
        pairs = later[kept] & valid[t][None, :]
        assert np.abs(iou[t][kept][pairs] - thresh).min() > 1e-4

        j_idx, j_mask = jax.jit(jnms.rotated_nms, static_argnums=(3, 4))(
            jnp.asarray(boxes[t]), jnp.asarray(scores[t]),
            jnp.asarray(valid[t]), thresh, post)
        np.testing.assert_array_equal(mask[t].numpy(), np.asarray(j_mask))
        m = mask[t].numpy()
        np.testing.assert_array_equal(idx[t].numpy()[m], np.asarray(j_idx)[m])
    # NMS suppressed some valid candidates and kept others
    assert 0 < mask.sum() < valid.sum()


def test_greedy_suppress_is_sequential_greedy():
    rng = np.random.RandomState(3)
    K = 48
    iou = rng.rand(2, K, K).astype(np.float32)
    iou = (iou + iou.transpose(0, 2, 1)) / 2
    valid = rng.rand(2, K) > 0.2
    got = tnms._greedy_suppress(torch.from_numpy(iou), torch.from_numpy(valid),
                                0.8, sweeps=K)
    for t in range(2):
        want = jnms._greedy_suppress_sequential(
            jnp.asarray(iou[t]), jnp.asarray(valid[t]), 0.8)
        np.testing.assert_array_equal(got[t].numpy(), np.asarray(want))


def test_overlap_takes_plain_version_on_cpu_and_raises_elsewhere():
    c = tiou.box_corners_bev(torch.from_numpy(_bev(20, 12)))
    before = dict(_kernels.LAUNCHES)
    got = tiou.convex_intersection_area(c[None], c[None, :7])
    assert got.shape == (1, 25, 7)
    assert _kernels.LAUNCHES == before  # no kernel launched for CPU tensors
    with pytest.raises(ValueError, match="CUDA"):
        tiou.convex_intersection_area(c.to("meta"), c.to("meta"))


@pytest.mark.parametrize("seed,span", [(0, 20.0), (1, 54.0)])
def test_plain_area_is_plus_zero_where_pairs_cannot_meet(seed, span):
    # the overlap kernel writes +0.0 without clipping wherever the
    # separation test says the pair cannot meet; so must plain and JAX
    b = _bev(120, seed, span)
    ca_j = jiou.box_corners_bev(jnp.asarray(b))
    pa, pb = jnp.broadcast_arrays(ca_j[:, None], ca_j[None, :])
    want = np.asarray(jax.jit(jiou._convex_intersection_area)(pa, pb))
    c = torch.from_numpy(np.array(ca_j))
    far = ~tiou.pairs_may_meet(c, c)
    got = tiou.convex_intersection_area(c, c)
    assert far.any() and (~far).any()
    assert not bool(got[far].any()) and not bool(torch.signbit(got[far]).any())
    assert not want[far.numpy()].any()


def test_overlap_wrapper_raises_past_its_grid():
    # one block per 32 x 128 pair tile, fewer than 2^31 of them
    a = torch.empty((2**16, 2**16, 4, 2), device="meta")
    b = torch.empty((2**16, 2**17, 4, 2), device="meta")
    with pytest.raises(ValueError, match="pair tiles"):
        tiou.convex_intersection_area(a, b)
    assert tiou.pair_tiles(2**16, 2**16, 2**17) >= 2**31
