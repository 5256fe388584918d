"""PyTorch port: voxelization and the pillar scatter-max against the JAX
package, on the same numpy inputs.

Tolerances: pillar ids, validity, occupancy and the scatter-max are
bit-equal (integer math and a max; the sorted-run route is compared by
value, as -0.0 and +0.0 may trade places); the PFE input features allow
1e-6 (one f32 rounding of the pillar-centre offsets). The port's synthetic
cloud equals the JAX package's drivers' bit for bit. The CUDA kernels
against their plain versions are in `test_torch_port_cuda.py` (needs a
card).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pillarnet_lts_tpu.ops import voxelize as jvox
from pillarnet_lts_tpu.ops.pallas.voxelize_kernel import (
    pillar_scatter_max_mxu,
    pillar_scatter_max_pallas,
)
from __graft_entry__ import _synth_points_realistic
from pillarnet_lts_torch.apis import load_config
from pillarnet_lts_torch.datasets import synth_points_realistic
from pillarnet_lts_torch.ops import _kernels
from pillarnet_lts_torch.ops import scatter as tscatter
from pillarnet_lts_torch.ops import voxelize as tvox
from pillarnet_lts_torch.ops.scatter import (
    pillar_scatter_max,
    pillar_scatter_max_tiled,
)
import test_torch_port_threads  # noqa: F401  (one torch thread)

ROOT = os.path.join(os.path.dirname(__file__), "..")


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



def test_tiled_plain_matches_jax_pallas_interpret():
    # the JAX sorted-tile kernel (the "tiled" backend's counterpart); ~2k
    # points into 16 x 16 keeps its interpret-mode loop under ~10 s
    feats, ids, valid, H, W = _scatter_inputs(8, False, B=2, N=1024)
    with pltpu.force_tpu_interpret_mode():
        want_grid, want_occ = pillar_scatter_max_pallas(
            jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(valid), H, W)
    grid, occ = pillar_scatter_max_tiled(
        torch.from_numpy(feats), torch.from_numpy(ids),
        torch.from_numpy(valid), H, W)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want_occ))
    assert (grid.numpy() == np.asarray(want_grid)).all()  # by value
    assert (grid.numpy() < 0).any()  # the all-negative pillar stays signed


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_tiled_takes_plain_version_on_cpu(dtype):
    feats, ids, valid, H, W = _scatter_inputs(9, dtype == torch.int8)
    x = torch.from_numpy(feats)
    x = (x * 30).round().clamp(0, 127).to(dtype) if dtype == torch.int8 \
        else x.to(dtype)
    args = (x, torch.from_numpy(ids), torch.from_numpy(valid), H, W)
    before = dict(_kernels.LAUNCHES)
    grid, occ = pillar_scatter_max_tiled(*args, nonneg=True)  # ignored
    assert _kernels.LAUNCHES == before  # no kernel launched for CPU tensors
    want_grid, want_occ = tvox.scatter_max_to_grid(*args)
    assert grid.dtype == dtype and torch.equal(occ, want_occ)
    assert (grid == want_grid).all()


def test_set_backend_tiled_routes_the_scatter():
    feats, ids, valid, H, W = _scatter_inputs(10, True)
    args = (torch.from_numpy(feats), torch.from_numpy(ids),
            torch.from_numpy(valid), H, W)
    want = pillar_scatter_max(*args, nonneg=True)
    calls = []
    real = tscatter.pillar_scatter_max_tiled
    try:
        tscatter.pillar_scatter_max_tiled = \
            lambda *a, **k: calls.append(1) or real(*a, **k)
        tscatter.set_backend("tiled")
        got = pillar_scatter_max(*args, nonneg=True)
    finally:
        tscatter.pillar_scatter_max_tiled = real
        tscatter.set_backend("auto")
    assert calls == [1]
    assert (got[0] == want[0]).all() and torch.equal(got[1], want[1])
    for name in ("xla", "sort", "pallas", "mxu"):
        with pytest.raises(ValueError, match="backend"):
            tscatter.set_backend(name)


def test_tiled_raises_off_cpu_and_cuda():
    feats = torch.empty(1, 4, 8, device="meta")
    ids = torch.empty(1, 4, dtype=torch.int32, device="meta")
    valid = torch.empty(1, 4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pillar_scatter_max_tiled(feats, ids, valid, 2, 2)


def _edge_inputs(case, B=2, N=384, C=8, H=16, W=16):
    """The cases the scatter-max kernels' redesign targets: every point in
    one pillar, a sample whose points are all dropped, and ids below 0 or
    at/after H*W on valid points (dropped)."""
    rng = np.random.RandomState(20)
    feats = rng.randn(B, N, C).astype(np.float32)
    ids = rng.randint(0, H * W, (B, N))
    valid = rng.rand(B, N) > 0.2
    if case == "one_pillar":
        ids[:] = 37
    elif case == "empty_sample":
        valid[1] = False
    else:
        ids[:, ::3] = rng.randint(-H * W, 0, ids[:, ::3].shape)
        ids[:, 1::5] = rng.randint(H * W, 3 * H * W, ids[:, 1::5].shape)
    return feats, ids.astype(np.int32), valid, H, W


@pytest.mark.parametrize("ref", ["segment_max", "sorted", "pallas_interpret"])
@pytest.mark.parametrize("case", ["one_pillar", "empty_sample", "bad_ids"])
def test_plain_scatter_edge_cases_match_jax(case, ref):
    # JAX's scatter_max_to_grid (segment_max), scatter_max_to_grid_sorted
    # and the sorted-tile Pallas kernel in interpret mode all drop ids
    # outside [0, H*W); the port's plain versions (and its wrappers on CPU
    # tensors) must give the same grid and occupancy
    feats, ids, valid, H, W = _edge_inputs(case)
    jargs = (jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(valid), H, W)
    if ref == "pallas_interpret":
        with pltpu.force_tpu_interpret_mode():
            want = pillar_scatter_max_pallas(*jargs)
    elif ref == "sorted":
        want = jvox.scatter_max_to_grid_sorted(*jargs)
    else:
        want = jvox.scatter_max_to_grid(*jargs)
    want_grid, want_occ = (np.asarray(a) for a in want)
    targs = (torch.from_numpy(feats), torch.from_numpy(ids),
             torch.from_numpy(valid), H, W)
    for fn in (tvox.scatter_max_to_grid, tscatter.scatter_max_tiled_plain,
               pillar_scatter_max, pillar_scatter_max_tiled):
        grid, occ = fn(*targs)
        np.testing.assert_array_equal(occ.numpy(), want_occ)
        assert (grid.numpy() == want_grid).all(), fn.__name__  # by value
    occupied = occ.sum(dim=(1, 2)).tolist()
    if case == "one_pillar":
        assert occupied == [1, 1]
    elif case == "empty_sample":
        assert occupied[1] == 0 and not grid[1].any()
    else:
        assert 0 < occupied[0] < H * W


@pytest.mark.parametrize("config,seed", [
    ("pillarnet34_nusc.py", 100), ("pillarnet34_waymo.py", 101)])
def test_synth_cloud_equals_the_drivers_cloud(config, seed):
    cfg = load_config(os.path.join(ROOT, "configs", "pillarnet", config))
    args = (2, int(cfg["data"]["max_points"]), cfg["point_cloud_range"])
    kw = dict(seed=seed, nsweeps=cfg.get("nsweeps", 10))
    pts, msk = synth_points_realistic(*args, **kw)
    want_pts, want_msk = _synth_points_realistic(*args, **kw)
    assert pts.dtype == want_pts.dtype and msk.dtype == want_msk.dtype
    assert pts.tobytes() == want_pts.tobytes()
    assert msk.tobytes() == want_msk.tobytes()
