"""PyTorch port on the card: each CUDA kernel against its plain version, and
the models' paths through the kernels (f32: scatter-max and overlap; int8
deploy: also the int8 conv and the fused int8 stage).

This file imports no JAX, so it also runs where only PyTorch is installed.
Every test needs a CUDA card with nvcc and skips without one. On the card,
from the repository root:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

(`--noconftest`: `tests/conftest.py` configures JAX.) Tolerances: the
scatter-max is bit-equal (max of the same floats or codes); areas within
1e-4 m^2 (the kernel is built without FMA contraction and repeats the plain
version's operation order, so they agree to rounding); the int8 conv and
the fused int8 stage are bit-equal as values (integer sums, the same f32
epilogue roundings; an all-empty tile writes +0 where the plain version
may give -0).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pillarnet_lts_torch.ops import _kernels  # noqa: E402
from pillarnet_lts_torch.ops import int8_stage as tstage  # noqa: E402
from pillarnet_lts_torch.ops import iou3d as tiou  # noqa: E402
from pillarnet_lts_torch.ops import quant as tquant  # noqa: E402
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
    for name in ("pillar_scatter_max", "rotated_overlap"):
        assert _kernels.LAUNCHES[name] >= 1, _kernels.LAUNCHES
    np.testing.assert_array_equal(det["mask"].cpu().numpy(), data["det_mask"])


def test_scatter_kernel_int8_codes_match_plain(cuda):
    feats, ids, valid, H, W = _scatter_inputs(7, True)
    codes = np.clip(np.round(feats * 40), 0, 127).astype(np.int8)
    args = (torch.from_numpy(codes).to(cuda), torch.from_numpy(ids).to(cuda),
            torch.from_numpy(valid).to(cuda), H, W)
    before = _kernels.LAUNCHES["pillar_scatter_max"]
    grid, occ = pillar_scatter_max(*args, nonneg=True)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["pillar_scatter_max"] == before + 1
    assert grid.dtype == torch.int8
    want_grid, want_occ = tvox.scatter_max_to_grid(*args)
    assert torch.equal(occ, want_occ) and torch.equal(grid, want_grid)
    with pytest.raises(ValueError, match="nonneg"):
        pillar_scatter_max(*args, nonneg=False)


def _int8_conv_args(dev, seed, B, H, W, cin, cout, stride, density=0.2):
    rng = np.random.RandomState(seed)
    occ = rng.rand(B, H, W) < density
    x = rng.randn(B, H, W, cin).astype(np.float32) * occ[..., None] * 2
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    mask = rng.rand(B, Ho, Wo) < 0.3
    res = rng.randn(B, Ho, Wo, cout).astype(np.float32) * mask[..., None]
    bf = torch.bfloat16
    return dict(
        x=torch.from_numpy(x).to(dev, bf),
        w_q=torch.from_numpy(rng.randint(-127, 128, (3, 3, cin, cout))
                             .astype(np.int8)).to(dev),
        inv_s=torch.tensor(127.0 / np.abs(x).max(), dtype=torch.float32,
                           device=dev),
        dq=torch.from_numpy((rng.rand(cout) * 1e-3 + 1e-4)
                            .astype(np.float32)).to(dev),
        shift=torch.from_numpy(rng.randn(cout).astype(np.float32)).to(dev),
        mask=torch.from_numpy(mask).to(dev, bf),
        residual=torch.from_numpy(res).to(dev, bf))


@pytest.mark.parametrize("stride,cin,cout,use_mask,use_res,act", [
    (1, 32, 32, True, True, True),      # stage-1 tail conv
    (1, 32, 32, True, False, False),    # stage-1 conv0
    (2, 32, 64, True, False, True),     # down conv
    (1, 512, 256, False, False, True),  # neck conv (dense)
    (2, 256, 256, False, False, True),  # conv5 down (dense)
])
def test_int8_conv_kernel_matches_plain(cuda, stride, cin, cout, use_mask,
                                        use_res, act):
    a = _int8_conv_args(cuda, cin + stride, 2, 37, 45, cin, cout, stride)
    kw = dict(mask=a["mask"] if use_mask else None,
              residual=a["residual"] if use_res else None, act=act)
    args = (a["x"], a["w_q"], a["inv_s"], a["dq"], a["shift"], stride)
    before = _kernels.LAUNCHES["int8_conv"]
    got = tquant.int8_conv_bn_act(*args, **kw)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["int8_conv"] == before + 1
    want = tquant.int8_conv_bn_act_plain(*args, **kw)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    assert got.float().abs().max() > 0


def test_int8_conv_kernel_rejects_unsupported_inputs(cuda):
    a = _int8_conv_args(cuda, 1, 1, 8, 8, 32, 32, 1)
    args = (a["w_q"], a["inv_s"], a["dq"], a["shift"], 1)
    with pytest.raises(TypeError, match="bf16"):
        tquant.int8_conv_bn_act(a["x"].float(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        tquant.int8_conv_bn_act(a["x"].transpose(1, 2), *args)


@pytest.mark.parametrize("n_convs", [3, 7])
def test_int8_stage_kernel_matches_plain(cuda, n_convs):
    rng = np.random.RandomState(n_convs)
    B, H, W, c = 2, 45, 70, 32
    occ = rng.rand(B, H, W) < 0.15
    occ[1, :20] = False  # empty tiles
    bf = torch.bfloat16
    x = torch.from_numpy(rng.randn(B, H, W, c).astype(np.float32)
                         * occ[..., None]).to(cuda, bf)
    w_q = torch.from_numpy(rng.randint(-127, 128, (n_convs, 3, 3, c, c))
                           .astype(np.int8)).to(cuda)
    inv_s = torch.from_numpy((30.0 + 5 * np.arange(n_convs))
                             .astype(np.float32)).to(cuda)
    dq = torch.from_numpy((rng.rand(n_convs, c) * 2e-5 + 1e-5)
                          .astype(np.float32)).to(cuda)
    shift = torch.from_numpy((rng.randn(n_convs, c) * 0.05)
                             .astype(np.float32)).to(cuda)
    mask = torch.from_numpy(occ).to(cuda, bf)
    before = _kernels.LAUNCHES["int8_stage"]
    got = tstage.int8_stage(x, w_q, inv_s, dq, shift, mask)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["int8_stage"] == before + 1
    want = tstage.int8_stage_plain(x, w_q, inv_s, dq, shift, mask)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    assert got.float().abs().max() > 0


def test_int8_model_path_runs_all_kernels(cuda):
    from chip_smoke import golden_model_cfg
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.models import build_detector
    from pillarnet_lts_torch.models.utils import init_weights
    from pillarnet_lts_torch.runtime.quantize import (
        calibrate, enable_backbone_quant)

    data = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                "golden_e2e_r3.npz"))
    mcfg, tcfg = golden_model_cfg()
    # the golden structure at the int8 kernels' widths (32-channel stage 1)
    mcfg = enable_backbone_quant(dict(mcfg, dtype="bfloat16"))
    mcfg["backbone"] = dict(mcfg["backbone"], in_channels=32, s2d_pallas=True)
    mcfg["reader"] = dict(mcfg["reader"], num_filters=(32,))
    model = init_weights(build_detector(mcfg, test_cfg=tcfg, device=cuda), 0)
    pts = torch.from_numpy(data["points"]).to(cuda)
    msk = torch.from_numpy(data["points_mask"]).to(cuda)
    calibrate(model, [(pts, msk)])
    _kernels.reset_launches()
    det = make_infer_fn(model)(pts, msk)
    torch.cuda.synchronize()
    assert all(n >= 1 for n in _kernels.LAUNCHES.values()), _kernels.LAUNCHES
    assert bool(torch.isfinite(det["box3d_lidar"]).all())
