"""PyTorch port: the separation test of the pair kernels K2 and K3
(`ops/iou3d.py::pairs_may_meet`, the PyTorch copy of
`csrc/rotated_pairs.cuh::may_meet`), and predict without host syncs.

The kernels write a pair that "cannot meet" without clipping it: +0.0 for
the overlap area (K2), the value of an intersection of +0 for the
suppression mask (K3, `(j < i) & (0 > thresh)`). These tests pin that the
plain versions (`_pairwise_area_plain`, `_suppression_matrix_plain`) and
the JAX package (`iou3d._convex_intersection_area`) give exactly those
values wherever the predicate says so: bit +0.0 (sign bit clear) for the
area, equality for the mask. Inputs: NMS-like candidate sets (those of
`chip_smoke.py`), near misses placed at the cull distance and 1e-3 m
either side of it at 0 m and +-54 m under 8 headings, zero-size padding
boxes, identical and shared-edge boxes.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import det3d_from_bev, nms_like_boxes
from pillarnet_lts_tpu.ops import iou3d as jiou
from pillarnet_lts_torch.core.utils import device_constant
from pillarnet_lts_torch.models.bbox_heads import center_head
from pillarnet_lts_torch.models.bbox_heads.center_head import CenterHeadMath
from pillarnet_lts_torch.ops import iou3d as tiou
from pillarnet_lts_torch.ops import nms as tnms
from test_multiclass_nms_grouping import _cfg, _head_and_preds
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_torch_port_int8 import jit_nofma

THRESHOLDS = (0.2, 0.0, -0.1)
JAX_PAIRS = 4096
CENTRES = ((0.0, 0.0), (54.0, 54.0), (-54.0, 54.0), (54.0, -54.0))
HEADINGS = tuple(k * math.pi / 4 + 0.1 for k in range(8))


def _check_far_pairs(bev):
    """bev (T, K, 5) pcdet boxes: wherever `pairs_may_meet` is False, the
    plain area is bit +0.0, JAX's area 0, and the plain suppression mask
    (same boxes as det3d) the zero-intersection value at every threshold.
    Returns the share of pairs that may meet."""
    corners = tiou.box_corners_bev(bev)
    near = tiou.pairs_may_meet(corners, corners)
    far = ~near
    area = tiou.convex_intersection_area(corners, corners)
    assert not bool(area[far].any()), "a far pair overlaps"
    assert not bool(torch.signbit(area[far]).any()), "-0.0 on a far pair"

    # JAX on the JAX_PAIRS far pairs whose circles come closest (one
    # compiled shape for every test), unfused: XLA's fusion contracts the
    # shoelace products to FMAs, which gives a zero-size box a rounding
    # residue of area
    (ma, ra), (mb, rb) = (tiou._bounding_circle(q) for q in (
        corners, tiou._scale_quad(corners, 1.0 + tiou._ENLARGE)))
    gap = ((ma[..., :, None, :] - mb[..., None, :, :]).norm(dim=-1)
           - ra[..., :, None] - rb[..., None, :])
    t, i, j = torch.nonzero(far, as_tuple=True)
    pick = torch.argsort(gap[far])[:JAX_PAIRS]
    pick = pick[torch.arange(JAX_PAIRS) % len(pick)]
    jarea = jit_nofma(jiou._convex_intersection_area,
                      jnp.asarray(corners[t[pick], i[pick]].numpy()),
                      jnp.asarray(corners[t[pick], j[pick]].numpy()))
    assert not np.asarray(jarea).any()

    boxes = det3d_from_bev(torch, bev)
    ca, cb = tnms.mask_kernel_corners(boxes)
    T, K = bev.shape[:2]
    upper = torch.ones((K, K), dtype=torch.bool).triu(1).expand(T, K, K)
    near_k3 = tiou.pairs_may_meet(ca, ca)
    for th in THRESHOLDS:
        m = tnms._suppression_matrix_plain(ca, cb, torch.full((T,), th))
        want = (upper & torch.tensor(0.0 > th)).float()
        assert torch.equal(m[~near_k3], want[~near_k3]), th
    return float(near.float().mean())


@pytest.mark.parametrize("seed", [1, 2])
def test_far_pairs_of_nms_like_sets_are_exact(seed):
    share = _check_far_pairs(nms_like_boxes(torch, seed, T=2, K=300))
    # most candidate pairs are culled, some are not
    assert 0.005 < share < 0.2


def _near_miss_boxes(offset, mode):
    """Pairs (A, B) at the cull distance + `offset`, under 8 headings of A
    at each centre of CENTRES. "corner": B's corner mean that far beyond
    the circles' reach, B's corner pointing back at A (the circles' bound
    is then tight: corners touch at offset -1e-3); "turned": the same with
    B turned by 0.7 rad; "edge": B beside A with A's heading, its edge that
    far from A's along A's edge 1 (the circles then overlap: the pair is
    always clipped, and the set adds parallel near misses to the far
    pairs of its other boxes). Returns (1, 2n, 5) pcdet boxes: A0, B0, A1,
    B1, ..."""
    dims = ((4.5, 1.9), (0.6, 0.6), (12.0, 2.9))
    out = []
    for cx, cy in CENTRES:
        for h in HEADINGS:
            for dx, dy in dims:
                a = torch.tensor([[cx, cy, dx, dy, h]])
                ca = tiou.box_corners_bev(a)
                ma, ra = tiou._bounding_circle(ca)
                bdx, bdy = dims[(dims.index((dx, dy)) + 1) % 3]
                if mode == "edge":
                    u = (ca[0, 2] - ca[0, 1]) / (ca[0, 2] - ca[0, 1]).norm()
                    b = torch.tensor([[0.0, 0.0, bdx, bdy, h]])
                    dist = (dy / 2 + bdy / 2 * (1.0 + tiou._ENLARGE)
                            + tiou._CULL_MARGIN + offset)
                else:
                    # A's first corner sets the direction towards B
                    u = (ca[0, 0] - ma[0]) / (ca[0, 0] - ma[0]).norm()
                    corner = math.atan2(bdy, bdx)  # B's first corner
                    hb = math.atan2(-u[1], -u[0]) - corner
                    if mode == "turned":
                        hb += 0.7
                    b = torch.tensor([[0.0, 0.0, bdx, bdy, hb]])
                    _, rb = tiou._bounding_circle(tiou._scale_quad(
                        tiou.box_corners_bev(b), 1.0 + tiou._ENLARGE))
                    dist = (float(ra[0]) + float(rb[0]) + tiou._CULL_MARGIN
                            + offset)
                b[0, 0:2] = ma[0] + u * dist
                out += [a[0], b[0]]
    return torch.stack(out)[None]


@pytest.mark.parametrize("offset", [-1e-3, 0.0, 1e-3])
@pytest.mark.parametrize("mode", ["corner", "turned", "edge"])
def test_far_pairs_at_the_cull_distance_are_exact(offset, mode):
    bev = _near_miss_boxes(offset, mode)
    _check_far_pairs(bev)
    corners = tiou.box_corners_bev(bev)
    near = tiou.pairs_may_meet(corners, corners)[0]
    pairs = near[0::2, 1::2].diagonal()  # A_k against its own B_k
    if mode == "edge":
        # clipped (and there, as for any pair, the kernels repeat the plain
        # version: touching parallel edges 1e-5 m apart at 54 m are within
        # a few ulp of collinear, where the clip itself is not accurate)
        assert bool(pairs.all())
    elif offset > 0:
        assert not bool(pairs.any())
    elif offset < 0:
        assert bool(pairs.all())
    if offset < 0 and mode == "corner":
        area = tiou.convex_intersection_area(corners, corners)[0]
        assert float(area[0::2, 1::2].diagonal().max()) < 1e-3


def test_zero_size_identical_and_shared_edge_boxes():
    rng = np.random.RandomState(3)
    real = nms_like_boxes(torch, 5, T=1, K=60)[0]
    pad = torch.zeros((20, 5))  # padding: zero size at the origin
    pad[10:, 0:2] = torch.from_numpy(rng.uniform(-54, 54, (10, 2)).astype(
        np.float32))  # zero size elsewhere
    special = torch.tensor([
        [0.0, 0.0, 2.0, 4.0, 0.3], [0.0, 0.0, 2.0, 4.0, 0.3],  # identical
        [2.0, 0.0, 2.0, 4.0, 0.0], [0.0, 0.0, 2.0, 4.0, 0.0],  # shared edge
        [0.0, 4.0, 2.0, 4.0, 0.0], [54.0, 54.0, 2.0, 4.0, 1.0],
        [54.0, 54.0, 2.0, 4.0, 1.0]])
    bev = torch.cat([special, pad, real])[None]
    _check_far_pairs(bev)
    corners = tiou.box_corners_bev(bev)
    near = tiou.pairs_may_meet(corners, corners)[0]
    # identical and shared-edge boxes may meet; so does padding at the
    # origin with every box that reaches it
    assert bool(near[0, 1] and near[2, 3] and near[3, 4] and near[5, 6])
    area = tiou.convex_intersection_area(corners, corners)[0]
    assert float(area[0, 1]) == pytest.approx(8.0, abs=1e-4)
    # a zero-size box overlaps nothing, far or near: +0.0
    zero = area[7:27]
    assert not bool(zero.any()) and not bool(torch.signbit(zero).any())


def test_pairs_may_meet_is_a_pairwise_broadcast():
    bev = nms_like_boxes(torch, 7, T=2, K=50)
    a = tiou.box_corners_bev(bev)
    b = tiou.box_corners_bev(bev[:, :13])
    got = tiou.pairs_may_meet(a, b)
    assert got.shape == (2, 50, 13) and got.dtype == torch.bool
    for i in (0, 17, 49):
        one = tiou.pairs_may_meet(a[:, i:i + 1], b)
        assert torch.equal(got[:, i:i + 1], one)
    assert tiou.pair_tiles(6, 1000, 1000) == 6 * 32 * 8


def _nusc_like_math_and_preds(seed):
    """Two tasks with equal NMS settings (one grouped rotated NMS)."""
    math_ = CenterHeadMath(
        [dict(stride=8, class_names=["car"]),
         dict(stride=8, class_names=["ped", "cone"])],
        pillar_size=0.5, point_cloud_range=[-16, -16, -5, 16, 16, 3])
    rng = np.random.RandomState(seed)
    preds = [{
        "hm": rng.randn(2, 12, 12, n).astype(np.float32),
        "reg": rng.rand(2, 12, 12, 2).astype(np.float32),
        "height": rng.randn(2, 12, 12, 1).astype(np.float32),
        "dim": rng.randn(2, 12, 12, 3).astype(np.float32) * 0.2,
        "rot": rng.randn(2, 12, 12, 2).astype(np.float32),
        "vel": rng.randn(2, 12, 12, 2).astype(np.float32),
    } for n in (1, 2)]
    cfg = dict(nms=dict(use_rotate_nms=True, nms_pre_max_size=64,
                        nms_post_max_size=16, nms_iou_threshold=0.2),
               score_threshold=0.1,
               post_center_limit_range=[-20, -20, -10, 20, 20, 10])
    return math_, preds, cfg


def _multiclass_math_and_preds(seed):
    jmath, jpreds = _head_and_preds(seed)
    math_ = CenterHeadMath(jmath.tasks, jmath.pillar_size,
                           jmath.point_cloud_range)
    return math_, [{k: np.array(v) for k, v in p.items()} for p in jpreds], \
        _cfg(True)


@pytest.mark.parametrize("route", ["grouped", "multiclass", "multiclass_mask",
                                   "grouped_mask"])
def test_second_predict_builds_no_tensor_from_a_list(monkeypatch, route):
    """Predict's constants from test_cfg are made once: a second predict
    with the same test_cfg builds no tensor from a python list (on the
    card, each such tensor was a pageable copy ended by a stream sync)."""
    make = (_nusc_like_math_and_preds if route.startswith("grouped")
            else _multiclass_math_and_preds)
    math_, preds, cfg = make(4)
    cfg["nms"]["use_mask_kernel"] = route.endswith("_mask")
    preds = [{k: torch.from_numpy(v) for k, v in p.items()} for p in preds]
    first = math_.predict({}, preds, cfg)
    assert first["mask"].any()

    calls = []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def counting(*args, _real=real, _name=name, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(torch, name, counting)
    assert center_head.torch.tensor is torch.tensor
    assert tnms.torch.as_tensor is torch.as_tensor
    second = math_.predict({}, preds, cfg)
    assert calls == []
    for key in first:
        assert torch.equal(first[key], second[key])


def test_device_constant_is_made_once():
    a = device_constant([0.8, 0.55, 0.55], "cpu")
    b = device_constant((0.8, 0.55, 0.55), torch.device("cpu"))
    assert a is b and a.dtype == torch.float32
    assert torch.equal(a, torch.tensor([0.8, 0.55, 0.55]))
    c = device_constant([64, 32], "cpu", torch.int64)
    assert c.dtype == torch.int64 and c.tolist() == [64, 32]
