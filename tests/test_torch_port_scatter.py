"""PyTorch port: voxelization and the pillar scatter-max against the JAX
package, on the same numpy inputs.

Tolerances: pillar ids, validity, occupancy and the scatter-max are
bit-equal (integer math and a max); the PFE input features allow 1e-6 (one
f32 rounding of the pillar-centre offsets). The CUDA kernel against the
plain version is in `test_torch_port_cuda.py` (needs a card).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pillarnet_lts_tpu.ops import voxelize as jvox
from pillarnet_lts_tpu.ops.pallas.voxelize_kernel import pillar_scatter_max_mxu
from pillarnet_lts_torch.ops import _kernels
from pillarnet_lts_torch.ops import voxelize as tvox
from pillarnet_lts_torch.ops.scatter import pillar_scatter_max


def _points(seed, B=2, N=3000):
    rng = np.random.RandomState(seed)
    pts = np.zeros((B, N, 5), np.float32)
    pts[..., 0] = rng.uniform(-18, 18, (B, N))
    pts[..., 1] = rng.uniform(-18, 18, (B, N))
    pts[..., 2] = rng.uniform(-4, 2, (B, N))
    pts[..., 3] = rng.uniform(0, 255, (B, N))
    pts[..., 4] = rng.uniform(0, 0.45, (B, N))
    # points exactly on pillar boundaries and on the range edges
    pts[:, :200, 0] = rng.randint(-64, 65, (B, 200)) * 0.25
    pts[:, :200, 1] = rng.randint(-64, 65, (B, 200)) * 0.25
    mask = rng.rand(B, N) > 0.05
    return pts, mask


def _scatter_inputs(seed, nonneg, B=2, N=700, C=8, H=16, W=16):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, N, C).astype(np.float32)
    if nonneg:
        feats = np.maximum(feats, 0.0)
    else:
        # a pillar whose points are all negative
        feats[0, :40] = -1.0 - np.abs(feats[0, :40])
    ids = rng.randint(0, H * W, (B, N)).astype(np.int32)
    ids[0, :40] = 3
    valid = rng.rand(B, N) > 0.3
    ids = np.where(valid, ids, H * W).astype(np.int32)
    # invalid points that still carry an in-range id must not count
    valid[1, :30] = False
    return feats, ids, valid, H, W


@pytest.mark.parametrize("seed", [0, 1])
def test_voxelize_points_matches_jax(seed):
    pts, mask = _points(seed)
    spec_args = (0.25, (-16.0, -16.0, -4.0, 16.0, 16.0, 2.0))
    want = jvox.voxelize_points(jnp.asarray(pts), jnp.asarray(mask),
                                jvox.PillarSpec(*spec_args))
    got = tvox.voxelize_points(torch.from_numpy(pts), torch.from_numpy(mask),
                               tvox.PillarSpec(*spec_args))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[1].dtype == torch.int32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("nonneg", [True, False])
def test_plain_scatter_matches_jax_and_pallas(nonneg):
    feats, ids, valid, H, W = _scatter_inputs(3, nonneg)
    grid, occ = tvox.scatter_max_to_grid(
        torch.from_numpy(feats), torch.from_numpy(ids),
        torch.from_numpy(valid), H, W)

    jargs = (jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(valid), H, W)
    want_grid, want_occ = jvox.scatter_max_to_grid(*jargs)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want_occ))
    np.testing.assert_array_equal(grid.numpy(), np.asarray(want_grid))

    with pltpu.force_tpu_interpret_mode():
        mxu_grid, mxu_occ = pillar_scatter_max_mxu(*jargs, 4, nonneg)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(mxu_occ))
    np.testing.assert_array_equal(grid.numpy(), np.asarray(mxu_grid))


@pytest.mark.parametrize("nonneg", [True, False])
def test_pillar_scatter_max_takes_plain_version_on_cpu(nonneg):
    feats, ids, valid, H, W = _scatter_inputs(4, nonneg)
    args = (torch.from_numpy(feats), torch.from_numpy(ids),
            torch.from_numpy(valid), H, W)
    before = dict(_kernels.LAUNCHES)
    got = pillar_scatter_max(*args, nonneg=nonneg)
    want = tvox.scatter_max_to_grid(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _kernels.LAUNCHES == before  # no kernel launched for CPU tensors


def test_pillar_scatter_max_raises_off_cpu_and_cuda():
    feats = torch.empty(1, 4, 8, device="meta")
    ids = torch.empty(1, 4, dtype=torch.int32, device="meta")
    valid = torch.empty(1, 4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pillar_scatter_max(feats, ids, valid, 2, 2, nonneg=True)

