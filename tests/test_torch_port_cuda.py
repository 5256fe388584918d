"""PyTorch port on the card: each CUDA kernel against its plain version, and
the models' paths through the kernels (f32: scatter-max and overlap; int8
deploy: also the int8 conv and the fused int8 stage; the switches: the
sorted-run scatter-max and the suppression mask).

This file imports no JAX, so it also runs where only PyTorch is installed.
Every test needs a CUDA card with nvcc and skips without one. On the card,
from the repository root:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

(`--noconftest`: `tests/conftest.py` configures JAX.) Tolerances: the
scatter-max is bit-equal (max of the same floats or codes); areas within
1e-4 m^2 (the kernel is built without FMA contraction and repeats the plain
version's operation order, so they agree to rounding); the sorted-run
scatter-max equal by value (-0.0 and +0.0 may trade places); the
suppression mask bit-equal (built without FMA contraction, the plain
version's order of operations); the int8 conv and
the fused int8 stage are equal by value (integer sums, the same f32
epilogue roundings; an inactive site is written as +0 where the plain
version may give -0).
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
from pillarnet_lts_torch.ops import nms as tnms  # noqa: E402
from pillarnet_lts_torch.ops import quant as tquant  # noqa: E402
from pillarnet_lts_torch.ops import voxelize as tvox  # noqa: E402
from pillarnet_lts_torch.ops import scatter as tscatter  # noqa: E402
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


# the tensor-core int8 conv (K4): every (Cin, Cout, stride) class of the
# flagship's int8 convs, on the edge cases of the redesign. Each checks the
# kernel equal to the plain version, two calls byte-identical and one count
# per call.
_K4_CLASSES = {"32-32": (32, 32, 1), "32-64-s2": (32, 64, 2),
               "64-64": (64, 64, 1), "64-128-s2": (64, 128, 2),
               "128-128": (128, 128, 1), "256-256": (256, 256, 1),
               "512-256": (512, 256, 1)}
# "masked": a random mask and residual, codes that clip at +-127, with and
# without the packed keyword; "dense": no mask; "corners": one active site
# at each image corner and at tile corners; "poisoned": the output carved
# out of 0xFF-filled memory, one sample with a random mask and one whose
# mask is all zero. Sizes are odd and no multiple of the 8 x 16 tile.
_K4_CASES = ("masked", "dense", "corners", "poisoned")


def _k4_case(dev, case, cin, cout, stride):
    rng = np.random.RandomState(cin + cout + stride + len(case))
    B, H, W = (2, 181, 163) if case == "poisoned" else (2, 37, 45)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    occ = rng.rand(B, H, W) < (1.0 if case in ("dense", "corners") else 0.3)
    x = rng.randn(B, H, W, cin).astype(np.float32) * occ[..., None] * 2
    mask = rng.rand(B, Ho, Wo) < 0.3
    if case == "corners":
        mask[:] = False
        for b, y, xx in ((0, 0, 0), (0, Ho - 1, Wo - 1), (1, 0, Wo - 1),
                         (1, Ho - 1, 0), (0, 7, 15), (1, 8, 16)):
            mask[b, y, xx] = True
    elif case == "poisoned":
        mask[1] = False
    res = rng.randn(B, Ho, Wo, cout).astype(np.float32) * mask[..., None]
    amax = np.abs(x).max() * (0.5 if case == "masked" else 1.0)
    bf = torch.bfloat16
    args = (torch.from_numpy(x).to(dev, bf),
            torch.from_numpy(rng.randint(-127, 128, (3, 3, cin, cout))
                             .astype(np.int8)).to(dev),
            torch.tensor(127.0 / amax, dtype=torch.float32, device=dev),
            torch.from_numpy((rng.rand(cout) * 2e-4 / cin ** 0.5 + 1e-5)
                             .astype(np.float32)).to(dev),
            torch.from_numpy(rng.randn(cout).astype(np.float32)).to(dev),
            stride)
    kw = dict(mask=None if case == "dense"
              else torch.from_numpy(mask).to(dev, bf),
              residual=torch.from_numpy(res).to(dev, bf)
              if case == "masked" else None,
              act=case != "corners")
    return args, kw


@pytest.mark.parametrize("case", _K4_CASES)
@pytest.mark.parametrize("cls", sorted(_K4_CLASSES))
def test_int8_conv_kernel_on_edge_cases(cuda, cls, case):
    cin, cout, stride = _K4_CLASSES[cls]
    args, kw = _k4_case(cuda, case, cin, cout, stride)
    want = tquant.int8_conv_bn_act_plain(*args, **kw)
    pack = tquant.pack_kernel(args[1])
    out_bytes = want.numel() * want.element_size()
    if case == "poisoned":
        poisoned = _poison(cuda, out_bytes)
    before = _kernels.LAUNCHES["int8_conv"]
    got = tquant.int8_conv_bn_act(*args, **kw, w_pack=pack)
    got2 = tquant.int8_conv_bn_act(
        *args, **kw, w_pack=None if case == "masked" else pack)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["int8_conv"] == before + 2
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    assert torch.equal(got.view(torch.int16), got2.view(torch.int16))
    assert got.float().abs().max() > 0
    if case == "masked":  # some codes clip
        assert (args[0].float() * args[2]).abs().max() > 127
    elif case == "poisoned":  # the output was carved out of a poisoned block
        start, end = got.data_ptr(), got.data_ptr() + out_bytes
        assert any(lo < end and start < hi for lo, hi in poisoned)
        assert not bool(torch.isnan(got.float()).any())
        assert not bool(got[1].any())  # the all-zero mask: exactly 0
    elif case == "corners":
        assert int((got.float().abs().sum(-1) > 0).sum()) <= 6


@pytest.mark.parametrize("density", ["sparse", "dense"])
@pytest.mark.parametrize("n_convs", [3, 5, 7, 9])
def test_int8_stage_kernel_on_sparse_and_dense_masks(cuda, n_convs, density):
    """K5 on a size that is no multiple of its tile, at 1% and 100%
    occupancy; n = 9 takes the 8-row tile (16 rows do not fit in shared
    memory there)."""
    rng = np.random.RandomState(10 * n_convs + len(density))
    B, H, W, c = 2, 37, 83, 32
    occ = rng.rand(B, H, W) < (0.01 if density == "sparse" else 1.0)
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
    args = (x, w_q, inv_s, dq, shift, torch.from_numpy(occ).to(cuda, bf))
    want = tstage.int8_stage_plain(*args)
    before = _kernels.LAUNCHES["int8_stage"]
    got = tstage.int8_stage(*args, w_pack=tquant.pack_kernel(w_q))
    got2 = tstage.int8_stage(*args)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["int8_stage"] == before + 2
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    assert torch.equal(got.view(torch.int16), got2.view(torch.int16))
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
    path = ("pillar_scatter_max", "rotated_overlap", "int8_conv", "int8_stage")
    assert all(_kernels.LAUNCHES[n] >= 1 for n in path), _kernels.LAUNCHES
    assert bool(torch.isfinite(det["box3d_lidar"]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_tiled_scatter_kernel_matches_plain_and_atomic(cuda, dtype):
    feats, ids, valid, H, W = _scatter_inputs(11, dtype == torch.int8)
    x = torch.from_numpy(feats).to(cuda)
    x = (x * 30).round().clamp(0, 127).to(dtype) if dtype == torch.int8 \
        else x.to(dtype)
    args = (x, torch.from_numpy(ids).to(cuda),
            torch.from_numpy(valid).to(cuda), H, W)
    before = dict(_kernels.LAUNCHES)
    grid, occ = tscatter.pillar_scatter_max_tiled(*args)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["pillar_scatter_max_tiled"] == \
        before["pillar_scatter_max_tiled"] + 1
    assert _kernels.LAUNCHES["pillar_scatter_max"] == \
        before["pillar_scatter_max"]
    want_grid, want_occ = tscatter.scatter_max_tiled_plain(*args)
    assert grid.dtype == dtype and torch.equal(occ, want_occ)
    assert bool((grid == want_grid).all())
    if dtype == torch.float32:
        atomic = pillar_scatter_max(*args, nonneg=False)
        assert torch.equal(occ, atomic[1])
        assert bool((grid == atomic[0]).all())


def test_set_backend_tiled_launches_the_sorted_kernel(cuda):
    feats, ids, valid, H, W = _scatter_inputs(12, True)
    args = (torch.from_numpy(feats).to(cuda), torch.from_numpy(ids).to(cuda),
            torch.from_numpy(valid).to(cuda), H, W)
    want = pillar_scatter_max(*args, nonneg=True)
    _kernels.reset_launches()
    try:
        tscatter.set_backend("tiled")
        got = pillar_scatter_max(*args, nonneg=True)
    finally:
        tscatter.set_backend("auto")
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["pillar_scatter_max_tiled"] == 1
    assert _kernels.LAUNCHES["pillar_scatter_max"] == 0
    assert torch.equal(got[1], want[1]) and bool((got[0] == want[0]).all())


def _det_boxes(R, K, seed):
    rng = np.random.RandomState(seed)
    centres = rng.uniform(-50, 50, (R, 12, 2))
    b = np.zeros((R, K, 7), np.float32)
    pick = rng.randint(0, 12, (R, K))
    b[..., 0:2] = np.take_along_axis(centres, pick[..., None], 1) \
        + rng.randn(R, K, 2) * 1.5
    b[..., 3:6] = rng.uniform(0.3, 6, (R, K, 3))
    b[..., 6] = rng.uniform(-np.pi, np.pi, (R, K))
    b[:, 1] = b[:, 0]  # identical pair
    b[:, 2:4] = [[0, 0, 0, 2, 4, 1.5, 0], [2, 0, 0, 2, 4, 1.5, 0]]
    return b


@pytest.mark.parametrize("R,K,thresh", [
    (2, 100, (0.2, 0.2)),            # ragged tiles
    (3, 300, (0.8, 0.55, 0.55)),     # per-row thresholds
    (6, 1000, (0.2,) * 6),           # nuScenes flagship
    (3, 2048, (0.8, 0.55, 0.55)),    # Waymo grouped flagship
])
def test_suppression_mask_kernel_matches_plain(cuda, R, K, thresh):
    boxes = torch.from_numpy(_det_boxes(R, K, K)).to(cuda)
    th = torch.tensor(thresh, device=cuda)
    before = _kernels.LAUNCHES["suppression_mask"]
    got = tnms.suppression_matrix(boxes, th)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["suppression_mask"] == before + 1
    ca, cb = tnms.mask_kernel_corners(boxes)
    want = tnms._suppression_matrix_plain(ca, cb, th)
    assert got.shape == (R, K, K)
    assert torch.equal(got, want), int((got != want).sum())
    assert got.sum() > 0 and not bool(got.tril().any())


def test_mask_kernel_nms_route_launches_the_mask_kernel(cuda):
    boxes = torch.from_numpy(_det_boxes(3, 256, 5)).to(cuda)
    valid = torch.ones((3, 256), dtype=torch.bool, device=cuda)
    scores = torch.zeros((3, 256), device=cuda)
    th = torch.tensor([0.8, 0.55, 0.55], device=cuda)
    _kernels.reset_launches()
    got = tnms.rotated_nms_dynamic(boxes, scores, valid, th, 64,
                                   use_mask_kernel=True)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["suppression_mask"] == 1
    assert _kernels.LAUNCHES["rotated_overlap"] == 0
    stat = tnms.rotated_nms(boxes, scores, valid, 0.55, 64,
                            use_mask_kernel=True)
    assert _kernels.LAUNCHES["suppression_mask"] == 2
    plain = tnms.rotated_nms_dynamic(boxes.cpu(), scores.cpu(), valid.cpu(),
                                     th.cpu(), 64, use_mask_kernel=True)
    for a, b in zip(got, plain):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(stat[1][1:], got[1][1:])


@pytest.mark.parametrize("name", ["pillarnet18_waymo", "pillarnet34_waymo",
                                  "pillarnet18_s4_waymo",
                                  "pillarnet34_s4_waymo"])
def test_waymo_config_serves_on_the_card(cuda, name):
    """Each served Waymo config builds on the card by default (full width
    and depth) and serves a 196,608-point request with per-class NMS."""
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.eval_utils import make_infer_fn

    root = os.path.join(os.path.dirname(__file__), "..")
    cfg = load_config(os.path.join(root, "configs", "pillarnet",
                                   name + ".py"))
    model = build_model_from_cfg(cfg)
    assert next(model.parameters()).device.type == "cuda"
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    pts, msk = (torch.from_numpy(a).to(cuda) for a in
                synth_points_realistic(1, n, pc_range, seed=4, nsweeps=1))
    spread_head_outputs(model, pts, msk)
    _kernels.reset_launches()
    det = make_infer_fn(model)(pts, msk)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["pillar_scatter_max"] == 1
    assert _kernels.LAUNCHES["rotated_overlap"] == 1
    assert det["box3d_lidar"].shape == (1, 500, 7)
    assert bool(torch.isfinite(det["box3d_lidar"]).all())
    m = det["mask"][0]
    for k, (lo, hi) in enumerate(((0, 200), (200, 350), (350, 500))):
        assert bool(m[lo:hi].any())
        assert bool((det["label_preds"][0, lo:hi][m[lo:hi]] == k).all())


# the redesigned scatter-max kernels (K1 and K1'): every variant, on the
# edge cases of the redesign. Each checks occupancy identical and the grid
# equal by value to the plain version, two calls bit-identical, and one
# count per call.
_VARIANTS = {
    "k1_f32_signed": ("auto", torch.float32, False),
    "k1_f32_nonneg": ("auto", torch.float32, True),
    "k1_int8_codes": ("auto", torch.int8, True),
    "k1t_f32": ("tiled", torch.float32, False),
    "k1t_bf16": ("tiled", torch.bfloat16, False),
    "k1t_int8": ("tiled", torch.int8, False),
}

# (B, N, C, H, W) per case: "poisoned" makes the grid large enough (> 1 MB
# in every dtype) to come from the caching allocator's large pool
_EDGE_SHAPES = {
    "poisoned": (2, 20000, 32, 256, 256),
    "empty_sample": (2, 5000, 32, 40, 48),
    "batch8": (8, 3000, 32, 24, 40),
    "bad_ids": (2, 5000, 32, 40, 48),
    "one_pillar": (2, 20000, 32, 40, 48),
}


def _edge_case(dev, case, dtype, nonneg):
    B, N, C, H, W = _EDGE_SHAPES[case]
    rng = np.random.RandomState(len(case))
    feats = rng.randn(B, N, C).astype(np.float32)
    if nonneg:
        feats = np.maximum(feats, 0.0)
    ids = rng.randint(0, H * W, (B, N))
    valid = rng.rand(B, N) > 0.2
    if case == "empty_sample":
        valid[1] = False
    elif case == "bad_ids":  # valid points with ids outside [0, H*W)
        ids[:, ::3] = rng.randint(-H * W, 0, ids[:, ::3].shape)
        ids[:, 1::5] = rng.randint(H * W, 3 * H * W, ids[:, 1::5].shape)
    elif case == "one_pillar":
        ids[:] = H * W // 2 + 3
    x = torch.from_numpy(feats).to(dev)
    if dtype == torch.int8:  # K1's codes are in [0, 127]; K1' takes any
        x = (x * 40).round().clamp(0 if nonneg else -128, 127)
    return (x.to(dtype), torch.from_numpy(ids.astype(np.int32)).to(dev),
            torch.from_numpy(valid).to(dev), H, W)


def _poison(dev, nbytes):
    """Fill cached blocks of `nbytes` with 0xFF bytes (NaN in f32 and bf16,
    -1 in int8, 255 as occupancy) until the allocator has to reserve more,
    then free them: every free block that can hold `nbytes` is then
    poisoned, so the next allocation of that size comes out of one.
    Returns their address ranges."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    junk = []
    for _ in range(64):
        reserved = torch.cuda.memory_reserved(dev)
        junk.append(torch.full((nbytes,), 255, dtype=torch.uint8, device=dev))
        if torch.cuda.memory_reserved(dev) > reserved:
            break
    ranges = [(j.data_ptr(), j.data_ptr() + nbytes) for j in junk]
    del junk
    return ranges


@pytest.mark.parametrize("case", sorted(_EDGE_SHAPES))
@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_scatter_kernels_on_edge_cases(cuda, variant, case):
    backend, dtype, nonneg = _VARIANTS[variant]
    name = "pillar_scatter_max" if backend == "auto" \
        else "pillar_scatter_max_tiled"
    args = _edge_case(cuda, case, dtype, nonneg)
    want_grid, want_occ = (tvox.scatter_max_to_grid if backend == "auto"
                           else tscatter.scatter_max_tiled_plain)(*args)
    B, N, C = args[0].shape
    H, W = args[3], args[4]
    grid_bytes = B * H * W * C * args[0].element_size()
    if case == "poisoned":
        poisoned = _poison(cuda, grid_bytes)
    outs = []
    try:
        tscatter.set_backend(backend)
        for _ in range(2):
            before = dict(_kernels.LAUNCHES)
            outs.append(pillar_scatter_max(*args, nonneg=nonneg))
            torch.cuda.synchronize()
            assert _kernels.LAUNCHES == dict(before, **{name: before[name]
                                                        + 1})
    finally:
        tscatter.set_backend("auto")
    (grid, occ), (grid2, occ2) = outs
    if case == "poisoned":  # the grid was carved out of a poisoned block
        start, end = grid.data_ptr(), grid.data_ptr() + grid_bytes
        assert any(lo < end and start < hi for lo, hi in poisoned)
        assert not bool(torch.isnan(grid.float()).any())
        assert not bool(grid[~occ].any())  # every empty pillar exactly 0
    assert grid.dtype == dtype and grid.shape == (B, H, W, C)
    assert torch.equal(occ, want_occ)
    assert bool((grid == want_grid).all())
    # deterministic: two calls bit-identical
    assert torch.equal(occ, occ2)
    assert torch.equal(grid.flatten().view(torch.uint8),
                       grid2.flatten().view(torch.uint8))
    occupied = occ.sum(dim=(1, 2)).tolist()
    if case == "empty_sample":
        assert occupied[1] == 0 and not bool(grid[1].any())
    elif case == "one_pillar":
        assert occupied == [1, 1]
