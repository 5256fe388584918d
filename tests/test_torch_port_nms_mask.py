"""PyTorch port: the NMS suppression mask (plain version of
`csrc/suppression_mask.cu`) and the mask-kernel NMS routes against the JAX
package, on the same numpy inputs.

The JAX side is `nms_kernel.py::suppression_matrix_pallas` in interpret
mode, as `tests/test_pallas_nms.py` runs it. Tolerances: masks equal except
on pairs whose IoU lies within MASK_EPS of the threshold (corner means are
summed in another order on the two sides, so such a pair may flip); keep
sets equal. The kernel against its plain version is in
`test_torch_port_cuda.py` (needs a card).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pillarnet_lts_tpu.ops import iou3d as jiou
from pillarnet_lts_tpu.ops import nms as jnms
from pillarnet_lts_tpu.ops.pallas.nms_kernel import suppression_matrix_pallas
from pillarnet_lts_torch.ops import _kernels
from pillarnet_lts_torch.ops import nms as tnms

MASK_EPS = 1e-4


def _boxes(n, seed, span=20.0):
    """det3d (n, 7) boxes in clusters, an identical pair and an
    edge-touching pair first, so the mask has work to do."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(-span, span, (8, 2))
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = centres[rng.randint(0, 8, n)] + rng.randn(n, 2)
    b[:, 2] = rng.uniform(-2, 0, n)
    b[:, 3:6] = rng.uniform(0.5, 5, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[1] = b[0]
    b[2:4] = [[0, 0, 0, 2, 4, 1.5, 0], [2, 0, 0, 2, 4, 1.5, 0]]
    return b


def _jax_iou(b):
    bev = jiou.to_pcdet_bev(jnp.asarray(b))
    return np.asarray(jax.jit(jiou.rotated_iou_bev)(bev, bev))


@pytest.mark.parametrize("n,thresh,seed", [
    (96, 0.2, 0),    # nuScenes threshold; K not a multiple of any tile
    (200, 0.55, 1),  # Waymo pedestrian / cyclist
    (256, 0.8, 2),   # Waymo vehicle
])
def test_plain_mask_matches_pallas_interpret(n, thresh, seed):
    b = _boxes(n, seed)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(suppression_matrix_pallas(jnp.asarray(b), thresh))
    got = tnms.suppression_matrix(torch.from_numpy(b)[None], thresh)[0]
    got = got.numpy()
    assert got.shape == want.shape == (n, n) and got.dtype == np.float32
    assert want.sum() > 0, "degenerate: nothing suppresses anything"
    flips = got != want
    if flips.any():
        assert np.abs(_jax_iou(b)[flips] - thresh).max() < MASK_EPS
    assert not np.tril(got).any()  # only j < i


def test_plain_mask_takes_per_row_thresholds():
    b = np.stack([_boxes(64, s) for s in (3, 4, 5)])
    th = np.array([0.8, 0.55, 0.1], np.float32)
    got = tnms.suppression_matrix(torch.from_numpy(b), torch.from_numpy(th))
    for r in range(3):
        one = tnms.suppression_matrix(torch.from_numpy(b[r:r + 1]),
                                      float(th[r]))
        assert torch.equal(got[r], one[0])
    assert got[2].sum() > got[0].sum()


@pytest.mark.parametrize("seed,thresh", [(7, 0.2), (8, 0.55)])
def test_mask_kernel_nms_matches_jax_use_pallas(seed, thresh):
    n, post = 64, 16
    b = _boxes(n, seed)
    scores = np.linspace(1, 0, n, dtype=np.float32)
    valid = np.ones(n, bool)
    valid[5] = False
    with pltpu.force_tpu_interpret_mode():
        j_idx, j_mask = jnms.rotated_nms(
            jnp.asarray(b), jnp.asarray(scores), jnp.asarray(valid), thresh,
            post, use_pallas=True)
    idx, mask = tnms.rotated_nms(
        torch.from_numpy(b), torch.from_numpy(scores),
        torch.from_numpy(valid), thresh, post, use_mask_kernel=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    m = mask.numpy()
    np.testing.assert_array_equal(idx.numpy()[m], np.asarray(j_idx)[m])
    assert 0 < m.sum() < valid.sum()


def test_rotated_nms_dynamic_matches_jax_per_row():
    R, n, post = 3, 80, 24
    b = np.stack([_boxes(n, 10 + r) for r in range(R)])
    th = np.array([0.8, 0.55, 0.55], np.float32)
    valid = np.random.RandomState(0).rand(R, n) > 0.1
    scores = np.zeros((R, n), np.float32)
    args = (torch.from_numpy(b), torch.from_numpy(scores),
            torch.from_numpy(valid), torch.from_numpy(th), post)
    idx, mask = tnms.rotated_nms_dynamic(*args)
    idx_m, mask_m = tnms.rotated_nms_dynamic(*args, use_mask_kernel=True)
    for r in range(R):
        j_idx, j_mask = jnms.rotated_nms_dynamic(
            jnp.asarray(b[r]), jnp.asarray(scores[r]), jnp.asarray(valid[r]),
            jnp.float32(th[r]), post)
        m = np.asarray(j_mask)
        np.testing.assert_array_equal(mask[r].numpy(), m)
        np.testing.assert_array_equal(idx[r].numpy()[m], np.asarray(j_idx)[m])
        # the mask route decides every pair alike here (no IoU within
        # MASK_EPS of a threshold among these boxes)
        iou = _jax_iou(b[r])
        assert np.abs(iou - th[r]).min() > MASK_EPS
        np.testing.assert_array_equal(mask_m[r].numpy(), m)
        np.testing.assert_array_equal(idx_m[r].numpy()[m],
                                      np.asarray(j_idx)[m])


def test_greedy_suppress_mask_is_greedy_suppress():
    rng = np.random.RandomState(4)
    K = 40
    iou = rng.rand(2, K, K).astype(np.float32)
    valid = torch.from_numpy(rng.rand(2, K) > 0.2)
    m = np.triu((iou > 0.7), 1).astype(np.float32)
    want = tnms._greedy_suppress(torch.from_numpy(iou), valid, 0.7, sweeps=K)
    got = tnms._greedy_suppress_mask(torch.from_numpy(m), valid, sweeps=K)
    assert torch.equal(got, want)
    j = jnms._greedy_suppress_mask(jnp.asarray(m[0]), jnp.asarray(valid[0]),
                                   sweeps=K)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(j))


def test_suppression_matrix_takes_plain_version_on_cpu_and_raises_elsewhere():
    b = torch.from_numpy(_boxes(20, 6))[None]
    before = dict(_kernels.LAUNCHES)
    assert tnms.suppression_matrix(b, 0.3).shape == (1, 20, 20)
    assert _kernels.LAUNCHES == before  # no kernel launched for CPU tensors
    with pytest.raises(ValueError, match="CUDA"):
        tnms.suppression_matrix(b.to("meta"), 0.3)
    with pytest.raises(ValueError, match="R, K"):
        tnms.suppression_matrix(b[0], 0.3)
