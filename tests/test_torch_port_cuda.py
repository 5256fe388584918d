"""PyTorch port on the card: each CUDA kernel against its plain version, and
the model's path through both kernels.

This file imports no JAX, so it also runs where only PyTorch is installed.
Every test needs a CUDA card with nvcc and skips without one. On the card,
from the repository root:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

(`--noconftest`: `tests/conftest.py` configures JAX.) Tolerances: the
scatter-max is bit-equal (max of the same floats); areas within 1e-4 m^2
(the kernel is built without FMA contraction and repeats the plain
version's operation order, so they agree to rounding).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pillarnet_lts_torch.ops import _kernels  # noqa: E402
from pillarnet_lts_torch.ops import iou3d as tiou  # noqa: E402
from pillarnet_lts_torch.ops import voxelize as tvox  # noqa: E402
from pillarnet_lts_torch.ops.scatter import pillar_scatter_max  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """Decided per test, never at import (workers must collect the same)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on one: python -m pytest "
                    "--noconftest tests/test_torch_port_cuda.py")
    return torch.device("cuda", 0)


def _scatter_inputs(seed, nonneg, B=2, N=20000, C=32, H=96, W=64):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, N, C).astype(np.float32)
    if nonneg:
        feats = np.maximum(feats, 0.0)
    else:
        feats[0, :40] = -1.0 - np.abs(feats[0, :40])  # an all-negative pillar
    ids = rng.randint(0, H * W, (B, N)).astype(np.int32)
    ids[0, :40] = 3
    valid = rng.rand(B, N) > 0.3
    ids = np.where(valid, ids, H * W).astype(np.int32)
    valid[1, :30] = False  # invalid points with in-range ids
    return feats, ids, valid, H, W


@pytest.mark.parametrize("nonneg", [True, False])
def test_scatter_kernel_matches_plain(cuda, nonneg):
    feats, ids, valid, H, W = _scatter_inputs(5, nonneg)
    args = (torch.from_numpy(feats).to(cuda), torch.from_numpy(ids).to(cuda),
            torch.from_numpy(valid).to(cuda), H, W)
    before = _kernels.LAUNCHES["pillar_scatter_max"]
    grid, occ = pillar_scatter_max(*args, nonneg=nonneg)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["pillar_scatter_max"] == before + 1
    want_grid, want_occ = tvox.scatter_max_to_grid(*args)
    assert torch.equal(occ, want_occ)
    assert torch.equal(grid, want_grid)


def test_scatter_kernel_rejects_unsupported_inputs(cuda):
    feats, ids, valid, H, W = _scatter_inputs(6, True, N=100)
    f = torch.from_numpy(feats).to(cuda)
    i = torch.from_numpy(ids).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    with pytest.raises(TypeError, match="f32"):
        pillar_scatter_max(f.double(), i, v, H, W)
    with pytest.raises(ValueError, match="contiguous"):
        pillar_scatter_max(f.transpose(0, 1), i.t(), v.t(), H, W)


def _bev(n, seed):
    rng = np.random.RandomState(seed)
    b = np.zeros((n, 5), np.float32)
    b[:, 0:2] = rng.uniform(-54, 54, (n, 2))
    b[:, 2:4] = rng.uniform(0.3, 12, (n, 2))
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    b[1] = b[0]  # identical pair
    b[2:4] = [[0, 0, 2, 4, 0], [2, 0, 2, 4, 0]]  # shared edge
    return b


def test_overlap_kernel_matches_plain(cuda):
    b = np.stack([_bev(300, s) for s in (10, 11)])
    c = tiou.box_corners_bev(torch.from_numpy(b).to(cuda)).contiguous()
    before = _kernels.LAUNCHES["rotated_overlap"]
    got = tiou.convex_intersection_area(c, c[:, :257])  # ragged column edge
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["rotated_overlap"] == before + 1
    want = tiou._pairwise_area_plain(c, c[:, :257])
    assert got.shape == (2, 300, 257)
    assert (got - want).abs().max().item() <= 1e-4
    assert got[0, 0, 1].item() == pytest.approx(want[0, 0, 0].item())


def test_model_path_runs_both_kernels(cuda):
    from chip_smoke import golden_model_cfg
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.models import build_detector
    from pillarnet_lts_torch.runtime.convert import (
        load_jax_variables, variables_from_keystr)

    data = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                "golden_e2e_r3.npz"))
    mcfg, tcfg = golden_model_cfg()
    model = build_detector(mcfg, test_cfg=tcfg, device=cuda)
    load_jax_variables(model, variables_from_keystr(data))
    _kernels.reset_launches()
    det = make_infer_fn(model)(torch.from_numpy(data["points"]).to(cuda),
                               torch.from_numpy(data["points_mask"]).to(cuda))
    assert all(n >= 1 for n in _kernels.LAUNCHES.values()), _kernels.LAUNCHES
    np.testing.assert_array_equal(det["mask"].cpu().numpy(), data["det_mask"])
