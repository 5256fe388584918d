"""PyTorch port on the card: each CUDA kernel against its plain version, and
the models' paths through the kernels (f32: scatter-max and overlap; int8
deploy: also the int8 conv, its f32 variant, its per-channel variants
(the int8 CenterHead's wide conv) and the fused int8 stage; the
switches: the sorted-run scatter-max and the suppression mask; the
two-stage and RPNG Waymo configs: scatter-max and overlap, no host sync,
the card against the CPU; the two-stage model in int8 on f32 activations
(every int8 conv call against the plain version) and in bf16 (against the
CPU); the legacy detectors and circular NMS against the CPU; training: a
demo step, also on a batch of the config's augmented train pipeline,
against the CPU; two-stage training: the overlap kernel on the RoI
sampler's padded zero boxes, the sampler and a demo step against the CPU;
evaluation: the Waymo evaluator's overlap calls and metrics against the
CPU, double-flip `dist_test` on the demo against the CPU, the trainer's
val workflow against `dist_test`; the compact sparse path: its tables and
rows, and the demo detector, against the CPU, and a request without the
scatter-max kernel).

This file imports no JAX, so it also runs where only PyTorch is installed.
Every test needs a CUDA card with nvcc and skips without one. On the card,
from the repository root:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

(`--noconftest`: `tests/conftest.py` configures JAX.) Tolerances: the
scatter-max is bit-equal (max of the same floats or codes); the sorted-run
scatter-max equal by value (-0.0 and +0.0 may trade places); the overlap
areas and the suppression mask bit-equal (built without FMA contraction,
the plain version's order of operations; a pair that cannot meet gets the
plain version's exact value without the clip), the mask kernel's own
corners bit-equal to `mask_kernel_corners` (the same cosf/sinf); the int8
conv and the fused int8 stage are equal by value (integer sums, the same f32
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


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_overlap_kernel_matches_plain(cuda):
    b = np.stack([_bev(300, s) for s in (10, 11)])
    c = tiou.box_corners_bev(torch.from_numpy(b).to(cuda)).contiguous()
    before = _kernels.LAUNCHES["rotated_overlap"]
    got = tiou.convex_intersection_area(c, c[:, :257])  # ragged column edge
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["rotated_overlap"] == before + 1
    want = tiou._pairwise_area_plain(c, c[:, :257])
    assert got.shape == (2, 300, 257)
    # bit for bit: -fmad=false and the plain version's order of operations
    assert torch.equal(_bits(got), _bits(want)), \
        (got - want).abs().max().item()
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


# K4's variants: activations' dtype and per-channel scales
_K4_VARIANTS = {"bf16": (torch.bfloat16, False, "int8_conv"),
                "f32": (torch.float32, False, "int8_conv_f32"),
                "pc": (torch.bfloat16, True, "int8_conv_pc"),
                "pc_f32": (torch.float32, True, "int8_conv_pc_f32")}


@pytest.mark.parametrize("variant", sorted(_K4_VARIANTS))
@pytest.mark.parametrize("stride,cin,cout,use_mask,use_res,act,shape", [
    (1, 32, 32, True, True, True, None),       # stage-1 tail conv
    (1, 32, 32, True, False, False, None),     # stage-1 conv0
    (2, 32, 64, True, False, True, None),      # down conv
    (1, 512, 256, False, False, True, None),   # neck conv (dense)
    (2, 256, 256, False, False, True, None),   # conv5 down (dense)
    # the tile configurations of the warp-specialised kernel: N of 32 and
    # 64 (8 x 64 tiles, weights resident) at batch 8, 128 (4 x 64, a ring of
    # weight stages) and 256 (2 x 64) with a mask, stride 2 into 64 / 128 /
    # 256; the sizes are no multiple of the tiles; Cin 1024 at stride 2
    # (in f32 with per-channel scales: one raw stage, two weight stages)
    (1, 32, 32, True, True, True, (8, 40, 150)),
    (1, 64, 64, True, True, True, (8, 19, 125)),
    (1, 128, 128, True, True, True, (2, 33, 70)),
    (1, 128, 256, True, False, True, (2, 33, 70)),
    (2, 64, 128, True, False, True, (2, 37, 130)),
    (2, 128, 256, True, True, True, (2, 37, 130)),
    (2, 1024, 64, True, False, True, (1, 19, 21)),
])
def test_int8_conv_kernel_matches_plain(cuda, stride, cin, cout, use_mask,
                                        use_res, act, shape, variant):
    """Each variant equal to its plain version and counted under its own
    name."""
    dtype, per_channel, name = _K4_VARIANTS[variant]
    B, H, W = shape or (2, 37, 45)
    a = _int8_conv_args(cuda, cin + stride, B, H, W, cin, cout, stride)
    kw = dict(mask=a["mask"].to(dtype) if use_mask else None,
              residual=a["residual"].to(dtype) if use_res else None, act=act)
    inv_s = a["inv_s"]
    if per_channel:  # scales a factor of 4 apart across the channels
        inv_s = inv_s * torch.linspace(0.5, 2.0, cin, device=cuda)
    args = (a["x"].to(dtype), a["w_q"], inv_s, a["dq"], a["shift"], stride)
    before = dict(_kernels.LAUNCHES)
    got = tquant.int8_conv_bn_act(*args, **kw)
    torch.cuda.synchronize()
    assert {k: n - before[k] for k, n in _kernels.LAUNCHES.items()
            if n != before[k]} == {name: 1}
    want = tquant.int8_conv_bn_act_plain(*args, **kw)
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    assert got.float().abs().max() > 0


def test_int8_conv_kernel_rejects_unsupported_inputs(cuda):
    a = _int8_conv_args(cuda, 1, 1, 8, 8, 32, 32, 1)
    args = (a["w_q"], a["inv_s"], a["dq"], a["shift"], 1)
    with pytest.raises(TypeError, match="bf16 or f32"):
        tquant.int8_conv_bn_act(a["x"].half(), *args)
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
# mask is all zero; "dead": a mask all zero, so that every tile is dead.
# Sizes are odd and no multiple of the tiles (8, 4 or 2 rows x 64).
_K4_CASES = ("masked", "dense", "corners", "poisoned", "dead")


def _k4_case(dev, case, cin, cout, stride, dtype=torch.bfloat16):
    """(args, kwargs) of one K4 edge case; activations, mask and residual
    in `dtype` (bf16, or f32 for the f32 variant)."""
    bf = dtype
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
    elif case == "dead":
        mask[:] = False
    res = rng.randn(B, Ho, Wo, cout).astype(np.float32) * mask[..., None]
    amax = np.abs(x).max() * (0.5 if case == "masked" else 1.0)
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
    before = dict(_kernels.LAUNCHES)
    got = tquant.int8_conv_bn_act(*args, **kw, w_pack=pack)
    got2 = tquant.int8_conv_bn_act(
        *args, **kw, w_pack=None if case == "masked" else pack)
    torch.cuda.synchronize()
    assert {k: n - before[k] for k, n in _kernels.LAUNCHES.items()
            if n != before[k]} == {"int8_conv": 2}
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    assert torch.equal(got.view(torch.int16), got2.view(torch.int16))
    assert (got.float().abs().max() > 0) == (case != "dead")
    if case == "masked":  # some codes clip
        assert (args[0].float() * args[2]).abs().max() > 127
    elif case == "poisoned":  # the output was carved out of a poisoned block
        start, end = got.data_ptr(), got.data_ptr() + out_bytes
        assert any(lo < end and start < hi for lo, hi in poisoned)
        assert not bool(torch.isnan(got.float()).any())
        assert not bool(got[1].any())  # the all-zero mask: exactly 0
    elif case == "corners":
        assert int((got.float().abs().sum(-1) > 0).sum()) <= 6


@pytest.mark.parametrize("case", _K4_CASES)
@pytest.mark.parametrize("cls", sorted(_K4_CLASSES))
def test_int8_conv_f32_kernel_on_edge_cases(cuda, cls, case):
    """K4's f32 variant (`int8_conv_f32`) on the same edge cases: f32
    activations quantized themselves, the f32 epilogue, equal by value to
    the plain version, counted under its own name."""
    cin, cout, stride = _K4_CLASSES[cls]
    args, kw = _k4_case(cuda, case, cin, cout, stride, torch.float32)
    want = tquant.int8_conv_bn_act_plain(*args, **kw)
    pack = tquant.pack_kernel(args[1])
    out_bytes = want.numel() * want.element_size()
    if case == "poisoned":
        poisoned = _poison(cuda, out_bytes)
    before = dict(_kernels.LAUNCHES)
    got = tquant.int8_conv_bn_act(*args, **kw, w_pack=pack)
    got2 = tquant.int8_conv_bn_act(
        *args, **kw, w_pack=None if case == "masked" else pack)
    torch.cuda.synchronize()
    assert {k: n - before[k] for k, n in _kernels.LAUNCHES.items()
            if n != before[k]} == {"int8_conv_f32": 2}
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want), (got - want).abs().max()
    assert torch.equal(got.view(torch.int32), got2.view(torch.int32))
    assert (got.abs().max() > 0) == (case != "dead")
    if case == "masked":  # some codes clip
        assert (args[0] * args[2]).abs().max() > 127
    elif case == "poisoned":
        start, end = got.data_ptr(), got.data_ptr() + out_bytes
        assert any(lo < end and start < hi for lo, hi in poisoned)
        assert not bool(torch.isnan(got).any())
        assert not bool(got[1].any())
    elif case == "corners":
        assert int((got.abs().sum(-1) > 0).sum()) <= 6


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("cin", [64, 256])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_int8_conv_pc_kernel_on_edge_cases(cuda, dtype, cin, batch):
    """K4's per-input-channel variants (`int8_conv_pc`, `int8_conv_pc_f32`)
    at the int8 CenterHead's wide conv (stride 1, no mask, ReLU; Cout six
    branches of 64 at Cin 64): channel ranges 1e-3 to 1e3 apart, one
    channel all zero (calibrated absmax 0: scale 1e-6 / 127), a quarter of
    the channels with scales at half their range (codes clip at +-127), a
    size that is no multiple of the 8 x 16 tile. Equal by value to the
    plain version, two calls byte-identical, counted under the variant's
    own name only."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    name = "int8_conv_pc" if dtype == "bf16" else "int8_conv_pc_f32"
    cout = 384 if cin == 64 else 128
    rng = np.random.RandomState(cin + batch + len(dtype))
    H, W = 37, 45
    spread = 10.0 ** rng.uniform(-3, 3, cin)
    x = np.abs(rng.randn(batch, H, W, cin)) * spread
    x[..., 5] = 0.0
    x = torch.from_numpy(x.astype(np.float32)).to(cuda, dt)
    absmax = x.float().abs().amax((0, 1, 2))
    absmax[::4] *= 0.5
    inv_s = 1.0 / tquant.activation_scale(absmax)
    args = (x, torch.from_numpy(rng.randint(-127, 128, (3, 3, cin, cout))
                                .astype(np.int8)).to(cuda), inv_s,
            torch.from_numpy((rng.rand(cout) * 2e-4 / cin ** 0.5 + 1e-5)
                             .astype(np.float32)).to(cuda),
            torch.from_numpy(rng.randn(cout).astype(np.float32)).to(cuda), 1)
    want = tquant.int8_conv_bn_act_plain(*args)
    before = dict(_kernels.LAUNCHES)
    got = tquant.int8_conv_bn_act(*args)
    got2 = tquant.int8_conv_bn_act(*args, w_pack=tquant.pack_kernel(args[1]))
    torch.cuda.synchronize()
    assert {k: n - before[k] for k, n in _kernels.LAUNCHES.items()
            if n != before[k]} == {name: 2}
    assert got.shape == want.shape and got.dtype == dt
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    assert torch.equal(got, got2)
    assert got.float().abs().max() > 0
    codes = (x.float() * inv_s).abs()
    assert codes.amax() > 127 and float(inv_s[5]) > 1e8


@pytest.mark.parametrize("density", ["sparse", "dense"])
@pytest.mark.parametrize("n_convs", [3, 5, 7, 9])
def test_int8_stage_kernel_on_sparse_and_dense_masks(cuda, n_convs, density):
    """K5 on a size that is no multiple of its tile, at 1% and 100%
    occupancy; n = 9 takes a 14-row tile (20 rows do not fit in shared
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


@pytest.mark.parametrize("density", ["sparse", "dense"])
@pytest.mark.parametrize("n_convs", [3, 5, 7])
def test_int8_stage_f32_kernel_matches_plain(cuda, n_convs, density):
    """K5's f32 variant (`int8_stage_f32`) against its plain version,
    bit-equal (by value), on a size that is no multiple of its tiles
    (9, 15 and 20 rows at n = 7, 5, 3; 32 columns), with the image edges
    in every conv's halo; sparse: tiles with no active site (sample 1's
    first 20 rows); a quarter of the active inputs on rounding halves of
    conv 0's scale (inv_s a power of two: x = (k + 1/2) / inv_s exactly),
    which round half to even. Two calls are byte-identical, each counts
    once, and an f32 x never takes the bf16 variant."""
    rng = np.random.RandomState(20 + n_convs + len(density))
    B, H, W, c = 2, 45, 83, 32
    occ = rng.rand(B, H, W) < (0.05 if density == "sparse" else 1.0)
    if density == "sparse":
        occ[1, :20] = False
    inv0 = 32.0
    x = rng.randn(B, H, W, c).astype(np.float32) * 2
    halves = rng.rand(B, H, W, c) < 0.25
    x[halves] = (np.round(x[halves] * inv0) + 0.5) / inv0
    x = torch.from_numpy(x * occ[..., None]).to(cuda)
    w_q = torch.from_numpy(rng.randint(-127, 128, (n_convs, 3, 3, c, c))
                           .astype(np.int8)).to(cuda)
    inv_s = torch.from_numpy(np.concatenate(
        [[inv0], 30.0 + 5 * np.arange(1, n_convs)]).astype(np.float32)
        ).to(cuda)
    dq = torch.from_numpy((rng.rand(n_convs, c) * 2e-5 + 1e-5)
                          .astype(np.float32)).to(cuda)
    shift = torch.from_numpy((rng.randn(n_convs, c) * 0.05)
                             .astype(np.float32)).to(cuda)
    args = (x, w_q, inv_s, dq, shift,
            torch.from_numpy(occ).to(cuda, torch.float32))
    want = tstage.int8_stage_plain(*args)
    before = dict(_kernels.LAUNCHES)
    got = tstage.int8_stage(*args, w_pack=tquant.pack_kernel(w_q))
    got2 = tstage.int8_stage(*args)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["int8_stage_f32"] == \
        before["int8_stage_f32"] + 2
    assert _kernels.LAUNCHES["int8_stage"] == before["int8_stage"]
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want), (got - want).abs().max()
    assert torch.equal(got.view(torch.int32), got2.view(torch.int32))
    assert got.abs().max() > 0
    assert not bool(got[~torch.from_numpy(occ).to(cuda)].any())
    with pytest.raises(TypeError, match="f32 x and mask"):
        tstage.int8_stage(x, w_q, inv_s, dq, shift, args[-1].bfloat16())


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


# the redesigned pair kernels (K2 and K3): pair sets that exercise the
# separation test, the compaction and the tile store. Each case is a pair
# of pcdet BEV sets (T, Ka, 5), (T, Kb, 5); K3 takes the first as its rows.
_HEADINGS = tuple(k * np.pi / 4 + 0.1 for k in range(8))


def _near_miss_bev():
    """A-B pairs with B's corner mean at the cull distance -1e-3, 0 and
    +1e-3 m from A's, at 0 m and +-54 m under 8 headings, B's corner
    pointing back at A (the circles' bound is then tight)."""
    out = []
    for cx, cy in ((0.0, 0.0), (54.0, 54.0), (-54.0, -54.0)):
        for h in _HEADINGS:
            for off in (-1e-3, 0.0, 1e-3):
                a = torch.tensor([[cx, cy, 4.5, 1.9, h]], dtype=torch.float32)
                ca = tiou.box_corners_bev(a)
                ma, ra = tiou._bounding_circle(ca)
                u = (ca[0, 0] - ma[0]) / (ca[0, 0] - ma[0]).norm()
                hb = float(torch.atan2(-u[1], -u[0])) - np.arctan2(2.9, 12.0)
                b = torch.tensor([[0.0, 0.0, 12.0, 2.9, hb]],
                                 dtype=torch.float32)
                _, rb = tiou._bounding_circle(tiou._scale_quad(
                    tiou.box_corners_bev(b), 1.0 + tiou._ENLARGE))
                dist = float(ra[0] + rb[0]) + tiou._CULL_MARGIN + off
                b[0, 0:2] = ma[0] + u * dist
                out += [a[0], b[0]]
    s = torch.stack(out)[None].numpy()
    return s, s


def _grid_bev(T, n, x0, seed):
    """Boxes of 0.3-4 m on a 20 x 8 m grid, 3 columns from x0: no two can
    meet."""
    rng = np.random.RandomState(seed)
    b = np.zeros((T, n, 5), np.float32)
    k = np.arange(n)
    b[..., 0] = x0 + 20.0 * (k % 3)
    b[..., 1] = -54.0 + 8.0 * (k // 3)
    b[..., 2:4] = rng.uniform(0.3, 4.0, (T, n, 2))
    b[..., 4] = rng.uniform(-np.pi, np.pi, (T, n))
    return b


def _pair_case(case):
    from chip_smoke import nms_like_boxes

    if case == "near_miss":
        return _near_miss_bev()
    if case == "all_far":  # Ka != Kb, T = 2
        return _grid_bev(2, 36, -54.0, 1), _grid_bev(2, 30, 6.0, 2)
    if case == "all_near":  # every box identical
        b = np.tile(np.array([[[3.0, -2.0, 4.0, 1.8, 0.4]]], np.float32),
                    (1, 150, 1))
        return b, b
    if case == "ragged":  # T = 3, Ka = 45, Kb = 131
        return (nms_like_boxes(torch, 3, T=3, K=45).numpy(),
                nms_like_boxes(torch, 4, T=3, K=131).numpy())
    s = nms_like_boxes(torch, 5, T=2, K=500).numpy()  # "nms_like_poisoned"
    return s, s


def _det3d(bev, d=7):
    """pcdet BEV (..., 5) -> det3d (..., d) boxes, yaw last."""
    b = np.zeros(bev.shape[:-1] + (d,), np.float32)
    b[..., 0:2] = bev[..., 0:2]
    b[..., 3], b[..., 4] = bev[..., 3], bev[..., 2]
    b[..., 5] = 1.5
    b[..., -1] = -bev[..., 4] - np.pi / 2
    return b


_PAIR_CASES = ("near_miss", "all_far", "all_near", "ragged",
               "nms_like_poisoned")


def _twice(dev, name, fn, poison_bytes=0):
    """fn() twice (the first out of poisoned memory if poison_bytes), one
    launch each; returns both outputs and whether the first landed in the
    poisoned blocks."""
    ranges = _poison(dev, poison_bytes) if poison_bytes else []
    outs = []
    for _ in range(2):
        before = _kernels.LAUNCHES[name]
        outs.append(fn())
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES[name] == before + 1
    start = outs[0].data_ptr()
    end = start + outs[0].numel() * 4
    return outs, any(lo < end and start < hi for lo, hi in ranges)


@pytest.mark.parametrize("case", _PAIR_CASES)
def test_overlap_kernel_on_pair_cases(cuda, case):
    a_bev, b_bev = _pair_case(case)
    a = tiou.box_corners_bev(torch.from_numpy(a_bev).to(cuda)).contiguous()
    b = tiou.box_corners_bev(torch.from_numpy(b_bev).to(cuda)).contiguous()
    poison = a.shape[0] * a.shape[1] * b.shape[1] * 4 \
        if case.endswith("poisoned") else 0
    (got, got2), poisoned = _twice(
        cuda, "rotated_overlap",
        lambda: tiou.convex_intersection_area(a, b), poison)
    want = tiou._pairwise_area_plain(a, b)
    assert got.shape == (a.shape[0], a.shape[1], b.shape[1])
    assert torch.equal(_bits(got), _bits(want)), \
        int((_bits(got) != _bits(want)).sum())
    assert torch.equal(_bits(got), _bits(got2))  # two calls byte-identical
    near = tiou.pairs_may_meet(a, b)
    if poison:
        assert poisoned and not bool(torch.isnan(got).any())
    if case == "all_far":
        assert not bool(near.any()) and not bool(got.any())
    elif case == "all_near":
        assert bool(near.all()) and bool((got > 0).all())
    else:
        assert bool(near.any()) and not bool(near.all())


@pytest.mark.parametrize("case", _PAIR_CASES)
def test_suppression_mask_kernel_on_pair_cases(cuda, case):
    a_bev, b_bev = _pair_case(case)
    bev = np.concatenate([a_bev, b_bev], 1) if case == "all_far" else a_bev
    boxes = torch.from_numpy(_det3d(bev)).to(cuda)
    R, K = boxes.shape[:2]
    th = torch.tensor([(0.2, 0.0, -0.1)[r % 3] for r in range(R)],
                      device=cuda)
    (got, got2), poisoned = _twice(
        cuda, "suppression_mask", lambda: tnms.suppression_matrix(boxes, th),
        R * K * K * 4 if case.endswith("poisoned") else 0)
    ca, cb = tnms.mask_kernel_corners(boxes)
    want = tnms._suppression_matrix_plain(ca, cb, th)
    assert torch.equal(_bits(got), _bits(want)), int((got != want).sum())
    assert torch.equal(_bits(got), _bits(got2))
    assert not bool(got.tril().any())
    if case.endswith("poisoned"):
        assert poisoned and not bool(torch.isnan(got).any())
    # one threshold for every row: the launch-argument route
    one = tnms.suppression_matrix(boxes, 0.2)
    want1 = tnms._suppression_matrix_plain(
        ca, cb, torch.full((R,), 0.2, device=cuda))
    assert torch.equal(_bits(one), _bits(want1))


def test_suppression_mask_corners_equal_mask_kernel_corners(cuda):
    from chip_smoke import nms_like_boxes

    bev = nms_like_boxes(torch, 6, T=3, K=700).numpy()
    for d in (7, 9):  # yaw last: det3d with and without velocity
        boxes = torch.from_numpy(_det3d(bev, d)).to(cuda)
        if d == 9:
            boxes[..., 6:8] = torch.randn(boxes.shape[:2] + (2,),
                                          device=cuda)
        ca, cb = tnms.mask_kernel_corners(boxes)
        ka, kb = tnms.suppression_mask_corners(boxes)
        torch.cuda.synchronize()
        assert torch.equal(_bits(ka), _bits(ca)), \
            (ka - ca).abs().max().item()
        assert torch.equal(_bits(kb), _bits(cb)), \
            (kb - cb).abs().max().item()
        got = tnms.suppression_matrix(boxes, 0.2)
        want = tnms._suppression_matrix_plain(
            ca, cb, torch.full((3,), 0.2, device=cuda))
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["pillarnet34_nusc", "pillarnet34_waymo"])
def test_served_request_does_not_sync_the_host(cuda, name):
    """A full-size request, after one warm-up, queues all its work without
    a stream or device synchronize until its result is copied to the host
    (`torch.cuda.set_sync_debug_mode("error")` raises on any)."""
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.runtime.serving import to_host

    root = os.path.join(os.path.dirname(__file__), "..")
    cfg = load_config(os.path.join(root, "configs", "pillarnet",
                                   name + ".py"))
    model = build_model_from_cfg(cfg, device=cuda)
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    clouds = [tuple(torch.from_numpy(a).to(cuda) for a in
                    synth_points_realistic(1, n, pc_range, seed=s,
                                           nsweeps=cfg.get("nsweeps", 10)))
              for s in (7, 8)]
    spread_head_outputs(model, *clouds[0])
    infer = make_infer_fn(model)
    infer(*clouds[0])
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        det = infer(*clouds[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    det = to_host(det)
    assert det["mask"].any() and np.isfinite(det["box3d_lidar"]).all()


# ---- training (chip_smoke.py phase 13) ---------------------------------------

_ROOT = os.path.join(os.path.dirname(__file__), "..")
_DEMO = os.path.join(_ROOT, "configs", "demo", "pillarnet18_demo.py")


def test_pillar_ids_on_the_card_equal_the_cpu(cuda):
    """Every nuScenes pillar edge +-1 ulp, in x and y: the card multiplies
    by the f32 reciprocal as the CPU does (`chip_smoke.py` phase 13 also
    runs the 4 flagship clouds)."""
    spec = tvox.PillarSpec(0.075, (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0))
    edge = np.float32(-54.0 + np.arange(spec.width + 1) * 0.075)
    xs = np.concatenate([np.nextafter(edge, np.float32(-np.inf)), edge,
                         np.nextafter(edge, np.float32(np.inf))])
    pts = np.zeros((2, xs.size, 5), np.float32)
    pts[0, :, 0] = pts[1, :, 1] = xs
    pts[0, :, 1] = pts[1, :, 0] = np.float32(-54.0 + 0.3 * 0.075)
    pts, msk = torch.from_numpy(pts), torch.ones(pts.shape[:2], dtype=bool)
    _, ids, valid = tvox.voxelize_points(pts.to(cuda), msk.to(cuda), spec)
    _, want_ids, want_valid = tvox.voxelize_points(pts, msk, spec)
    assert torch.equal(ids.cpu(), want_ids)
    assert torch.equal(valid.cpu(), want_valid)


@pytest.mark.parametrize("backend", ["auto", "tiled"])
def test_scatter_gradient_on_the_card_matches_plain(cuda, backend):
    """The Function's gradient through K1 (or K1') is bit-equal to the
    same backward over the plain version's grid and to the CPU's, with
    positive points duplicated onto others (each gets the whole gradient)."""
    feats, ids, valid, H, W = _scatter_inputs(9, True)
    feats[:, 500:700] = feats[:, 100:300] = feats[:, 100:300] + 0.5
    ids[:, 500:700] = ids[:, 100:300]
    valid[:, 500:700] = valid[:, 100:300] = True
    ids = np.where(valid, ids, H * W).astype(np.int32)
    rng = np.random.RandomState(3)
    dgrid = rng.randn(feats.shape[0], H, W, feats.shape[2]).astype(np.float32)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        x = torch.from_numpy(feats).to(dev).requires_grad_(True)
        tscatter.set_backend(backend)
        try:
            grid, _ = pillar_scatter_max(x, torch.from_numpy(ids).to(dev),
                                         torch.from_numpy(valid).to(dev), H,
                                         W, nonneg=True)
        finally:
            tscatter.set_backend("auto")
        (grads[dev.type],) = torch.autograd.grad(
            grid, x, torch.from_numpy(dgrid).to(dev))
    args = [torch.from_numpy(a).to(cuda) for a in (feats, ids, valid)]
    plain = tvox.scatter_max_to_grid(*args, H, W)[0]
    want = tscatter.scatter_max_backward(*args, plain,
                                         torch.from_numpy(dgrid).to(cuda))
    assert torch.equal(grads["cuda"], want)
    assert torch.equal(grads["cuda"].cpu(), grads["cpu"])
    tied = (grads["cpu"][:, 100:300] != 0) & (grads["cpu"][:, 500:700] != 0)
    assert bool(tied.any())


def _demo_step(dev, remat=False, seed=3, augmented=False):
    """One demo-config step on `dev` from seeded weights: on two synthetic
    scenes, or (`augmented`) on the config's own train set and pipeline
    (flips, rotation, scaling, translation, shuffle; the samples' draws
    from their own generators, so both devices get one batch)."""
    from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                          optimizer_from_cfg)
    from pillarnet_lts_torch.datasets import (SynthDataset, build_dataset,
                                              collate_batch)
    from pillarnet_lts_torch.runtime.train_step import (batch_to_device,
                                                        train_step)

    cfg = load_config(_DEMO)
    cfg["model"]["backbone"] = dict(cfg["model"]["backbone"], remat=remat)
    ds = (build_dataset(cfg["data"]["train"]) if augmented
          else SynthDataset(cfg, 2, 4096, seed=31))
    batch = collate_batch([ds[0], ds[1]], cfg["data"]["max_points"])
    model = build_model_from_cfg(cfg, device=dev, seed=seed)
    opt = optimizer_from_cfg(model, cfg, 10)
    m = train_step(model, opt, batch_to_device(batch, dev), cfg["train_cfg"])
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    return {k: float(v) for k, v in m.items()}, grads, state, model, opt


def _card_step_matches_the_cpu(cuda, **kw):
    from chip_smoke import params_within_first_adam_step
    from pillarnet_lts_torch.runtime.train_step import bn_shifted_biases

    mg, _, sg, model, opt = _demo_step(cuda, **kw)
    mc, _, sc, _, _ = _demo_step(torch.device("cpu"), **kw)
    for k in mc:
        assert mg[k] == pytest.approx(
            mc[k], rel=1e-3 if k == "grad_norm" else 1e-4), k
    params = [n for n, _ in model.named_parameters()]
    params_within_first_adam_step(torch, sg, sc, params,
                                  set(bn_shifted_biases(model)),
                                  opt.lr_fn(0))
    for k in set(sc) - set(params):
        torch.testing.assert_close(sg[k], sc[k], rtol=1e-4, atol=1e-4)


def test_demo_train_step_on_the_card_matches_the_cpu(cuda):
    """Metrics rtol 1e-4 (grad_norm 1e-3), running statistics rtol = atol
    = 1e-4, parameters within two first Adam steps and 99.5% of them within
    rtol = atol = 1e-4 (`chip_smoke.py::params_within_first_adam_step`)."""
    _card_step_matches_the_cpu(cuda)


def test_augmented_demo_step_on_the_card_matches_the_cpu(cuda):
    """One batch of the demo config's augmented train pipeline: the card's
    step against the CPU's, the tolerances of the unaugmented step."""
    _card_step_matches_the_cpu(cuda, augmented=True)


def test_remat_on_equals_remat_off_on_the_card(cuda):
    """With deterministic cuDNN: equal metrics, gradients and state, the
    running statistics moved once."""
    torch.backends.cudnn.deterministic = True
    try:
        off = _demo_step(cuda, remat=False)
        on = _demo_step(cuda, remat=True)
    finally:
        torch.backends.cudnn.deterministic = False
    assert on[3].backbone_net.remat
    for a, b in zip(off[:3], on[:3]):
        for k in a:
            same = a[k] == b[k] if isinstance(a[k], float) \
                else torch.equal(a[k], b[k])
            assert same, k


def test_checkpoint_resume_on_the_card(cuda, tmp_path):
    """A trainer's checkpoint resumed into a fresh model on the card takes
    the same next step as the trainer (deterministic cuDNN)."""
    from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                          optimizer_from_cfg, train_detector)
    from pillarnet_lts_torch.datasets import SynthDataset, collate_batch
    from pillarnet_lts_torch.runtime.checkpoint import load_checkpoint
    from pillarnet_lts_torch.runtime.train_step import (batch_to_device,
                                                        train_step)

    cfg = load_config(_DEMO)
    cfg["data"] = dict(cfg["data"], samples_per_gpu=2)
    cfg["total_epochs"] = 2
    ds = SynthDataset(cfg, 4, 4096, seed=6)
    torch.backends.cudnn.deterministic = True
    try:
        tr = train_detector(build_model_from_cfg(cfg, device=cuda), ds, cfg,
                            work_dir=str(tmp_path))
        batch = batch_to_device(collate_batch([ds[0], ds[1]],
                                              cfg["data"]["max_points"]),
                                cuda)
        ma = train_step(tr.model, tr.optimizer, batch, cfg["train_cfg"])
        fresh = build_model_from_cfg(cfg, device=cuda, seed=9)
        opt = optimizer_from_cfg(fresh, cfg, 4)
        meta = load_checkpoint(str(tmp_path / "epoch_2.pth"), fresh, opt)
        mb = train_step(fresh, opt, batch, cfg["train_cfg"])
    finally:
        torch.backends.cudnn.deterministic = False
    assert meta["epoch"] == 2 and meta["iter"] == 4
    for k in ma:
        assert float(ma[k]) == pytest.approx(float(mb[k]), rel=1e-6,
                                             abs=1e-6), k
    sb = fresh.state_dict()
    for k, v in tr.model.state_dict().items():
        torch.testing.assert_close(sb[k], v, rtol=1e-6, atol=1e-6)


# ---- two-stage serving (chip_smoke.py phase 14) -----------------------------

_RPNG_CONFIGS = ["pillarrcnn/pillarrcnn18_waymo",
                 "pillarnet/pillarnet18_fpn_waymo",
                 "pillarnet/pillarnet34_fpn_waymo",
                 "pillarnet/pillarnet18_fpn_iou_waymo"]


def _waymo_request(cfg, dev, seed):
    from pillarnet_lts_torch.datasets import synth_points_realistic

    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    return tuple(torch.from_numpy(a).to(dev) for a in synth_points_realistic(
        1, n, pc_range, seed=seed, nsweeps=1))


@pytest.mark.parametrize("name", _RPNG_CONFIGS)
def test_rpng_config_serves_on_the_card(cuda, name):
    """The two-stage config and the three RPNG single-stage Waymo configs
    build on the card by default (full width and depth) and serve a
    196,608-point request: K1 once, K2 once per task (the vehicle row of
    2048, the pedestrian and cyclist rows of 1024), 500 padded slots."""
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.eval_utils import make_infer_fn

    cfg = load_config(os.path.join(_ROOT, "configs", name + ".py"))
    model = build_model_from_cfg(cfg)
    assert next(model.parameters()).device.type == "cuda"
    pts, msk = _waymo_request(cfg, cuda, 11)
    spread_head_outputs(model, pts, msk)
    _kernels.reset_launches()
    det = make_infer_fn(model)(pts, msk)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["pillar_scatter_max"] == 1
    assert _kernels.LAUNCHES["rotated_overlap"] == 2
    assert det["box3d_lidar"].shape == (1, 500, 7)
    assert bool(torch.isfinite(det["box3d_lidar"]).all())
    m = det["mask"][0]
    assert bool(m.any())
    scores = det["scores"][0]
    assert bool(((scores >= 0) & (scores <= 1)).all())
    assert set(det["label_preds"][0][m].tolist()) <= {0, 1, 2}


def test_two_stage_request_does_not_sync_the_host(cuda):
    """A full-size pillarrcnn18_waymo request, after one warm-up, queues
    its first stage, proposals, RoI pooling, heads and post_process without
    a host sync until its result is copied to the host."""
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.runtime.serving import to_host

    cfg = load_config(os.path.join(_ROOT, "configs", "pillarrcnn",
                                   "pillarrcnn18_waymo.py"))
    model = build_model_from_cfg(cfg, device=cuda)
    clouds = [_waymo_request(cfg, cuda, s) for s in (12, 13)]
    spread_head_outputs(model, *clouds[0])
    infer = make_infer_fn(model)
    infer(*clouds[0])
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        det = infer(*clouds[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    det = to_host(det)
    assert det["mask"].any() and np.isfinite(det["box3d_lidar"]).all()


def test_two_stage_demo_on_the_card_matches_the_cpu(cuda):
    """The demo two-stage config from the same weights and cloud: the same
    RoI set and kept slots, labels equal, boxes within 1e-3 m and scores
    within 1e-4 (`chip_smoke.py::rcnn_card_vs_cpu`)."""
    from chip_smoke import rcnn_card_vs_cpu

    r = rcnn_card_vs_cpu(torch, cuda)
    assert r["kept"] > 0


# ---- the two-stage precisions, the legacy detectors, circular NMS --------

_RCNN_DEMO = os.path.join(_ROOT, "configs", "demo", "pillarrcnn18_demo.py")


def _demo_cloud(cfg, dev, seed):
    from pillarnet_lts_torch.datasets import synth_points_realistic

    return tuple(torch.from_numpy(a).to(dev) for a in synth_points_realistic(
        1, cfg["data"]["max_points"], cfg["point_cloud_range"], seed=seed,
        nsweeps=1))


def test_int8_f32_two_stage_request_runs_the_f32_kernel(cuda):
    """`pillarrcnn18_demo` at the int8 kernels' 32-channel widths after
    `enable_backbone_quant` (f32 compute), calibrated on the card: a
    request launches K1 once, K2 once per task and K4's f32 variant once
    per quantized conv, nothing else, with no host sync; each of its K4
    calls equal by value to the plain version; finite detections."""
    from chip_smoke import plain_kwargs, recording_int8_convs
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.models.backbones.base import MaskedConv
    from pillarnet_lts_torch.runtime.quantize import (
        calibrate, enable_backbone_quant)
    from pillarnet_lts_torch.runtime.serving import to_host

    cfg = load_config(_RCNN_DEMO)
    enable_backbone_quant(cfg["model"])
    fs = cfg["model"]["first_stage_cfg"]
    fs["reader"]["num_filters"] = (32,)
    fs["backbone"]["in_channels"] = 32
    model = build_model_from_cfg(cfg, device=cuda)
    assert model.dtype == torch.float32
    clouds = [_demo_cloud(cfg, cuda, s) for s in (21, 22, 23)]
    spread_head_outputs(model, *clouds[0])
    calibrate(model, [clouds[0], clouds[1]])
    n_k4 = sum(1 for m in model.modules()
               if isinstance(m, MaskedConv) and m.quant_ready())
    infer = make_infer_fn(model)
    infer(*clouds[1])
    torch.cuda.synchronize()
    calls = []
    _kernels.reset_launches()
    try:
        torch.cuda.set_sync_debug_mode("error")
        with recording_int8_convs(calls):
            det = infer(*clouds[2])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    det = to_host(det)
    launched = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    assert launched == {"pillar_scatter_max": 1, "rotated_overlap": 2,
                        "int8_conv_f32": n_k4}, launched
    assert n_k4 == len(calls) > 30
    for args, kw, out in calls:
        assert args[0].dtype == torch.float32
        want = tquant.int8_conv_bn_act_plain(*args, **plain_kwargs(kw))
        assert torch.equal(out, want), (out - want).abs().max()
    assert det["mask"].any() and np.isfinite(det["box3d_lidar"]).all()


def _to(tree, dev):
    if torch.is_tensor(tree):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree


def _close_to_scale(got, want, frac, what):
    got, want = got.float().cpu(), want.float().cpu()
    scale = float(want.abs().max()) + 1e-6
    err = float((got - want).abs().max())
    assert err <= frac * scale, f"{what}: max |d| {err} > {frac} x {scale}"


def test_bf16_two_stage_on_the_card_matches_the_cpu(cuda):
    """`pillarrcnn18_demo` in bf16 from the same weights and cloud: the
    first stage's maps on the card within 5e-2 of each map's max |value|
    of the CPU's (cuDNN's and ATen's bf16 convs round in other places), and
    the second stage given the CPU's RoIs and maps within 4e-2 (point
    logits, RoI head outputs) of max |value|, scores within 1e-2; the
    bf16 request makes no host sync."""
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.runtime.serving import to_host

    cfg = load_config(_RCNN_DEMO)
    cfg["model"]["dtype"] = "bfloat16"
    cloud = _demo_cloud(cfg, "cpu", 24)
    cpu = build_model_from_cfg(cfg, device="cpu")
    spread_head_outputs(cpu, *cloud)
    card = build_model_from_cfg(cfg, device=cuda, seed=1)
    card.load_state_dict(cpu.state_dict())
    with torch.inference_mode():
        first, bev, feats, preds = cpu.first_stage(*cloud)
        _, gbev, _, gpreds = card.first_stage(*_to(cloud, cuda))
        want = cpu.second_stage(first, bev, feats)
        got = card.second_stage(_to(first, cuda), _to(bev, cuda),
                                _to(feats, cuda))
    for p, q in zip(gpreds, preds):
        for h in p:
            assert p[h].dtype == torch.bfloat16
            _close_to_scale(p[h], q[h], 5e-2, h)
    for a, b in zip(gbev, bev):
        _close_to_scale(a, b, 5e-2, "bev")
    assert torch.equal(got["roi_labels"].cpu(), want["roi_labels"])
    for k in ("point_logits", "rcnn_cls", "rcnn_reg"):
        assert got[k].dtype == torch.bfloat16
        _close_to_scale(got[k], want[k], 4e-2, k)
    gdet, wdet = card.post_process(got), cpu.post_process(want)
    m = wdet["mask"]
    assert torch.equal(gdet["mask"].cpu(), m) and bool(m.any())
    assert float((gdet["scores"].cpu() - wdet["scores"])[m].abs().max()) \
        <= 1e-2
    infer = make_infer_fn(card)
    request = _to(cloud, cuda)
    infer(*request)
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        det = infer(*request)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert np.isfinite(to_host(det)["box3d_lidar"]).all()


@pytest.mark.parametrize("name", ["twostage18_demo", "voxelnet18_demo",
                                  "pillarnet18_demo_circular_nms"])
def test_legacy_and_circular_demo_on_the_card_match_the_cpu(cuda, name):
    """The legacy detectors' demo configs and the demo config with
    circular NMS from the same weights and cloud: kept slots (and the RoI
    set) equal, labels equal, boxes within 1e-3 m, scores within 1e-4
    (`chip_smoke.py::card_vs_cpu`, phase 18d)."""
    from chip_smoke import card_vs_cpu, circular_nms

    demo = os.path.join(_ROOT, "configs", "demo")
    if name.endswith("_circular_nms"):
        r = card_vs_cpu(torch, cuda, _DEMO, "18d", edit=circular_nms)
    else:
        r = card_vs_cpu(torch, cuda, os.path.join(demo, name + ".py"),
                        "18d")
    assert r["kept"] > 0


# ---- two-stage training -----------------------------------------------------

_ZERO_CASES = ("zero_vs_zero", "zero_vs_real", "real_vs_zero", "mixed")


def _zero_box_corners(dev, case, B=2, R=300, G=200):
    """det3d boxes with padded (all-zero) rows, as the RoI sampler hands
    K2: RoIs (B, R) against GT rows (B, G); zero rows on the side(s) the
    case names (`mixed`: the last third of each side)."""
    rng = np.random.RandomState(60)

    def boxes(n, zero):
        b = np.zeros((B, n, 7), np.float32)
        b[..., :2] = rng.uniform(-20, 20, (B, n, 2))
        b[..., 2] = rng.uniform(-1, 1, (B, n))
        b[..., 3:6] = rng.uniform(0.5, 5, (B, n, 3))
        b[..., 6] = rng.uniform(-np.pi, np.pi, (B, n))
        b[:, zero:] = 0
        return torch.from_numpy(b).to(dev)

    za = {"zero_vs_zero": 0, "zero_vs_real": 0, "real_vs_zero": R,
          "mixed": 2 * R // 3}[case]
    zb = {"zero_vs_zero": 0, "zero_vs_real": G, "real_vs_zero": 0,
          "mixed": 2 * G // 3}[case]
    return boxes(R, za), boxes(G, zb)


@pytest.mark.parametrize("case", _ZERO_CASES)
def test_overlap_kernel_on_zero_boxes(cuda, case):
    """K2 on the padded boxes of the RoI sampler (the zero box: four
    corners at the origin): zero-vs-zero, zero-vs-real and real-vs-zero
    pairs bit-equal to the plain version, exactly +0, no NaN, also out of
    NaN-poisoned memory; `boxes_iou3d` of those rows is 0."""
    a_box, b_box = _zero_box_corners(cuda, case)
    a = tiou.box_corners_bev(tiou.to_pcdet_bev(a_box)).contiguous()
    b = tiou.box_corners_bev(tiou.to_pcdet_bev(b_box)).contiguous()
    poison = a.shape[0] * a.shape[1] * b.shape[1] * 4
    (got, got2), poisoned = _twice(
        cuda, "rotated_overlap",
        lambda: tiou.convex_intersection_area(a, b), poison)
    want = tiou._pairwise_area_plain(a, b)
    assert poisoned and not bool(torch.isnan(got).any())
    assert torch.equal(_bits(got), _bits(want)), \
        int((_bits(got) != _bits(want)).sum())
    assert torch.equal(_bits(got), _bits(got2))
    zero_a = (a_box == 0).all(-1)
    zero_b = (b_box == 0).all(-1)
    pad = zero_a[:, :, None] | zero_b[:, None, :]
    assert bool(pad.any())
    assert torch.equal(_bits(got[pad]), torch.zeros_like(_bits(got[pad])))
    if case == "mixed":
        assert bool((got[~pad] > 0).any())
    iou = tiou.boxes_iou3d(a_box, b_box)
    assert bool(torch.isfinite(iou).all()) and not bool(iou[pad].any())


def test_rcnn_sampler_on_the_card_equals_the_cpu(cuda):
    """`chip_smoke.py::check_sampler` (phase 15a): the RoI sampler at
    (4, 500, 500) -> 128 under `set_sync_debug_mode("error")`, one K2
    launch, bit-equal to the CPU from the same draws given the card's IoU
    matrix (the CPU's own within 1e-3), every quota branch."""
    from chip_smoke import check_sampler

    r = check_sampler(torch, cuda)
    assert r["sampled_fg"][2] == 128 and r["sampled_fg"][3] == 0


def test_two_stage_train_step_on_the_card_matches_the_cpu(cuda):
    """`chip_smoke.py::rcnn_train_card_vs_cpu` (phase 15c): one demo
    two-stage step, dropout off, the same weights, batch and draws: the
    sampled RoIs, metrics, statistics and parameters within its
    tolerances."""
    from chip_smoke import rcnn_train_card_vs_cpu

    r = rcnn_train_card_vs_cpu(torch, cuda)
    assert r["rois_real"] > 0


def test_waymo_evaluator_on_the_card_equals_the_cpu(cuda):
    """The native Waymo evaluator with its IoU matrices on the card: one
    rotated-overlap launch per frame and class with boxes on both sides,
    each call bit-equal to the plain version on the card, and every metric
    equal to the CPU evaluator's on the same boxes (the fixture's scenes,
    `tools/make_eval_fixture.py`)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from make_eval_fixture import synth_waymo_scenes
    from chip_smoke import capture_overlap

    from pillarnet_lts_torch.datasets.waymo import waymo_eval

    gt, pred = synth_waymo_scenes(seed=1, n_tokens=4)
    before = _kernels.LAUNCHES["rotated_overlap"]
    got, calls = capture_overlap(
        lambda: waymo_eval.evaluate_waymo(gt, pred, device="cuda"))
    torch.cuda.synchronize()
    pairs = sum(int(((gt[t]["names"] == c).any())
                    and (pred[t]["names"] == c).any())
                for t in gt for c in ("VEHICLE", "PEDESTRIAN", "CYCLIST"))
    assert _kernels.LAUNCHES["rotated_overlap"] - before == len(calls) \
        == pairs
    for a, b in calls:
        want = tiou._pairwise_area_plain(a, b)
        assert torch.equal(tiou.convex_intersection_area(a, b), want)
    assert got == waymo_eval.evaluate_waymo(gt, pred, device="cpu")
    assert 0.0 < got["mAP_L1"] < 1.0


def test_double_flip_demo_on_the_card_matches_the_cpu(cuda, tmp_path):
    """`tools/dist_test.py` on the demo config with double-flip TTA, one
    checkpoint of seeded weights with the heads spread on the first cloud:
    the card's detections against the CPU's (the same kept detections and
    labels, boxes within 1e-3 m, scores within 1e-4: phase 14e's
    tolerances)."""
    from chip_smoke import DEMO, DOUBLE_FLIP, config_file, spread_checkpoint
    from pillarnet_lts_torch.tools import dist_test

    demo = config_file(str(tmp_path), "demo_flip", DEMO, DOUBLE_FLIP)
    args = [demo, "--seed", "0", "--checkpoint", spread_checkpoint(
        torch, demo, "cpu", str(tmp_path / "ckpt")), "--work_dir",
            str(tmp_path)]
    got = dist_test.main(args)["detections"]
    want = dist_test.main(args + ["--device", "cpu"])["detections"]
    assert sorted(got) == sorted(want)
    assert sum(len(d["scores"]) for d in want.values()) > 0
    for t, w in want.items():
        np.testing.assert_array_equal(got[t]["label_preds"], w["label_preds"])
        np.testing.assert_allclose(got[t]["box3d_lidar"], w["box3d_lidar"],
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(got[t]["scores"], w["scores"], rtol=0,
                                   atol=1e-4)


def test_trainer_val_on_the_card_matches_dist_test(cuda, tmp_path):
    """`chip_smoke.py::eval_trainer` (phase 16d): the demo
    `Trainer.run([('train', 1), ('val', 1)])` on the card logs what
    `tools/dist_test.py` gives on the checkpoint it saved."""
    from chip_smoke import eval_trainer

    assert eval_trainer(torch, cuda, str(tmp_path))["logged"].startswith(
        "Evaluation demo: demo mAP")


# ---- the compact sparse path (chip_smoke.py phase 20) -----------------------

def _compact_demo(cfg):
    """pillarnet18_demo with the compact reader: a budget of the whole
    64 x 64 grid, so no site is dropped."""
    cfg["model"]["reader"]["compact_kmax"] = 4096


def test_compact_tables_on_the_card_equal_the_cpu(cuda):
    """The compact integer tables of a demo cloud (site ids, k_valid, the
    SubM, strided and coarse tables, the coarse sites, the densified
    occupancy) from the card's pillar ids and the CPU's, and the
    segment-max rows of the same features, bit-equal
    (`chip_smoke.compact_tables_card_vs_cpu`, phase 20a)."""
    from chip_smoke import compact_tables_card_vs_cpu
    from pillarnet_lts_torch.apis import build_model_from_cfg, load_config
    from pillarnet_lts_torch.datasets import synth_points_realistic

    cfg = load_config(_DEMO)
    _compact_demo(cfg)
    model = build_model_from_cfg(cfg, device=cuda)
    cloud = synth_points_realistic(1, cfg["data"]["max_points"],
                                   cfg["point_cloud_range"], seed=30,
                                   nsweeps=1)
    r = compact_tables_card_vs_cpu(torch, cuda, model, cloud, "20")
    assert r["k_valid"][0] > 0 and r["k2_valid"][0] > 0


def test_compact_demo_on_the_card_matches_the_cpu(cuda):
    """The compact demo detector from the same weights and cloud on the
    card and on the CPU: kept slots and labels equal, boxes within 1e-3
    m, scores within 1e-4 (`chip_smoke.py::card_vs_cpu`)."""
    from chip_smoke import card_vs_cpu

    assert card_vs_cpu(torch, cuda, _DEMO, "20", edit=_compact_demo)[
        "kept"] > 0


def test_compact_request_launches_no_k1(cuda):
    """A compact request launches K2 and never K1 (the segment max takes
    its place), and syncs the host only for its result."""
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.runtime.serving import to_host

    cfg = load_config(_DEMO)
    _compact_demo(cfg)
    model = build_model_from_cfg(cfg, device=cuda)
    cloud = tuple(torch.from_numpy(a).to(cuda) for a in synth_points_realistic(
        1, cfg["data"]["max_points"], cfg["point_cloud_range"], seed=31,
        nsweeps=1))
    spread_head_outputs(model, *cloud)
    infer = make_infer_fn(model)
    infer(*cloud)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    try:
        torch.cuda.set_sync_debug_mode("error")
        det = infer(*cloud)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    det = to_host(det)
    assert _kernels.LAUNCHES["pillar_scatter_max"] == 0
    assert _kernels.LAUNCHES["rotated_overlap"] >= 1
    assert det["mask"].any() and np.isfinite(det["box3d_lidar"]).all()


# --- the kernel ops (`ops/library.py`) and a serving program on the card ---

def _op_cases(dev):
    """(op, args, plain version) of each kernel op at small card shapes."""
    rng = np.random.RandomState(21)
    feats, ids, valid, H, W = _scatter_inputs(21, False, N=4000)
    f = torch.from_numpy(feats).to(dev)
    i, v = torch.from_numpy(ids).to(dev), torch.from_numpy(valid).to(dev)
    codes = torch.from_numpy(rng.randint(0, 128, feats.shape)
                             .astype(np.int8)).to(dev)
    boxes = torch.from_numpy(np.concatenate([
        rng.uniform(-20, 20, (3, 200, 2)), rng.uniform(-1, 1, (3, 200, 1)),
        rng.uniform(1, 5, (3, 200, 3)), rng.uniform(-3.2, 3.2, (3, 200, 1))],
        -1).astype(np.float32)).to(dev)
    quads = tiou.box_corners_bev(tiou.to_pcdet_bev(boxes)).contiguous()
    th = torch.tensor([0.1, 0.3, 0.5], device=dev)
    a = _int8_conv_args(dev, 4, 2, 37, 45, 32, 64, 2)
    conv = (a["w_q"], a["inv_s"], a["dq"], a["shift"], 2)
    pack = tquant.pack_kernel(a["w_q"])
    bf, f32 = torch.bfloat16, torch.float32
    occ = torch.from_numpy(rng.rand(2, 37, 45) < 0.2).to(dev)
    x = (torch.randn(2, 37, 45, 32, device=dev) * occ[..., None]).to(bf)
    w_q = torch.from_numpy(rng.randint(-127, 128, (3, 3, 3, 32, 32))
                           .astype(np.int8)).to(dev)
    stage = (w_q, torch.full((3,), 30.0, device=dev),
             torch.full((3, 32), 2e-4, device=dev),
             torch.from_numpy(rng.randn(3, 32).astype(np.float32)).to(dev),
             occ.to(bf))
    inv_vec = a["inv_s"] * torch.from_numpy(
        rng.uniform(0.25, 4.0, 32).astype(np.float32)).to(dev)
    ops = torch.ops.pillarnet
    return {
        "pillar_scatter_max": (
            ops.pillar_scatter_max, (f, i, v, H, W, False),
            lambda: tvox.scatter_max_to_grid(f, i, v, H, W), True),
        "pillar_scatter_max-int8": (
            ops.pillar_scatter_max, (codes, i, v, H, W, True),
            lambda: tvox.scatter_max_to_grid(codes, i, v, H, W), True),
        "pillar_scatter_max_tiled": (
            ops.pillar_scatter_max_tiled, (f.to(bf), i, v, H, W, False),
            lambda: tscatter.scatter_max_tiled_plain(f.to(bf), i, v, H, W),
            False),
        "rotated_overlap": (
            ops.rotated_overlap, (quads, quads),
            lambda: tiou._pairwise_area_plain(quads, quads), True),
        "suppression_mask": (
            ops.suppression_mask, (boxes, th, 0.0),
            lambda: tnms._suppression_matrix_plain(
                *tnms.mask_kernel_corners(boxes), th), True),
        "suppression_mask_corners": (
            ops.suppression_mask_corners, (boxes,),
            lambda: tnms.mask_kernel_corners(boxes), True),
        "int8_conv": (
            ops.int8_conv, (a["x"], pack, *conv[1:], a["mask"],
                            a["residual"], True),
            lambda: tquant.int8_conv_bn_act_plain(
                a["x"], *conv, mask=a["mask"], residual=a["residual"]),
            False),
        "int8_conv_f32": (
            ops.int8_conv_f32, (a["x"].to(f32), pack, *conv[1:], None, None,
                                False),
            lambda: tquant.int8_conv_bn_act_plain(a["x"].to(f32), *conv,
                                                  act=False), False),
        "int8_conv_pc": (
            ops.int8_conv_pc, (a["x"], pack, inv_vec, *conv[2:-1], 1, None,
                               None, True),
            lambda: tquant.int8_conv_bn_act_plain(a["x"], a["w_q"], inv_vec,
                                                  *conv[2:-1], 1), False),
        "int8_conv_pc_f32": (
            ops.int8_conv_pc_f32, (a["x"].to(f32), pack, inv_vec, *conv[2:],
                                   a["mask"].to(f32),
                                   a["residual"].to(f32), True),
            lambda: tquant.int8_conv_bn_act_plain(
                a["x"].to(f32), a["w_q"], inv_vec, *conv[2:],
                mask=a["mask"].to(f32), residual=a["residual"].to(f32)),
            False),
        "int8_stage": (
            ops.int8_stage, (x, tquant.pack_kernel(w_q), *stage[1:]),
            lambda: tstage.int8_stage_plain(x, *stage), False),
        "int8_stage_f32": (
            ops.int8_stage_f32, (x.to(f32), tquant.pack_kernel(w_q),
                                 *stage[1:-1], stage[-1].to(f32)),
            lambda: tstage.int8_stage_plain(x.to(f32), *stage[:-1],
                                            stage[-1].to(f32)), False),
    }


_OP_NAMES = ["pillar_scatter_max", "pillar_scatter_max-int8",
             "pillar_scatter_max_tiled", "rotated_overlap",
             "suppression_mask", "suppression_mask_corners", "int8_conv",
             "int8_conv_f32", "int8_conv_pc", "int8_conv_pc_f32",
             "int8_stage", "int8_stage_f32"]


def _outputs(out):
    return out if isinstance(out, (tuple, list)) else (out,)


@pytest.mark.parametrize("case", _OP_NAMES)
def test_kernel_op_on_the_card_matches_its_plain_version(cuda, case):
    op, args, plain, bitwise = _op_cases(cuda)[case]
    name = case.split("-")[0]
    before = dict(_kernels.LAUNCHES)
    got = _outputs(op(*args))
    torch.cuda.synchronize()
    want = _outputs(plain())
    counted = {k for k, n in _kernels.LAUNCHES.items() if n != before[k]}
    assert counted == (set() if name == "suppression_mask_corners"
                       else {name})
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w) if bitwise else bool((g == w).all())


@pytest.mark.parametrize("case", _OP_NAMES)
def test_kernel_op_fake_shapes_match_the_card(cuda, case):
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args, _, _ = _op_cases(cuda)[case]
    real = _outputs(op(*args))
    with FakeTensorMode() as mode:
        fake = _outputs(op(*[mode.from_tensor(t) if torch.is_tensor(t)
                             else t for t in args]))
    assert [(t.shape, t.dtype, t.device) for t in fake] == \
        [(t.shape, t.dtype, t.device) for t in real]


@pytest.mark.parametrize("variant", ["f32", "int8-fused", "f32-fused",
                                     "int8-head", "f32-head"])
def test_demo_program_on_the_card_equals_eager(cuda, variant, tmp_path):
    """pillarnet18_demo exported on the card: f32, int8 in bf16 with the
    fused stage (K4, K5), int8 in f32 with the fused stage (the f32
    variants of K4 and K5), and int8 with the head quantized in bf16 and
    in f32 (K4's per-channel variants for the SepHead wide convs). The
    program launches what eager launches and returns eager's detections
    bit for bit."""
    from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                          spread_head_outputs)
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.runtime.export import (
        export_serving, load_serving, save_serving)
    from pillarnet_lts_torch.runtime.quantize import (calibrate,
                                                      enable_backbone_quant)

    cfg = load_config(os.path.join(os.path.dirname(__file__), "..",
                                   "configs", "demo", "pillarnet18_demo.py"))
    int8 = variant != "f32"
    if int8:
        enable_backbone_quant(cfg["model"], head=variant.endswith("-head"))
        if variant.startswith("int8"):
            cfg["model"]["dtype"] = "bfloat16"
        cfg["model"]["reader"]["num_filters"] = (32,)
        cfg["model"]["backbone"].update(
            in_channels=32, s2d_pallas=variant.endswith("-fused"))
    pts, msk = _demo_cloud(cfg, cuda, 5)
    model = build_model_from_cfg(cfg, device=cuda)
    spread_head_outputs(model, pts, msk)
    if int8:
        calibrate(model, [(pts, msk)])
    _kernels.reset_launches()
    want = make_infer_fn(model)(pts, msk)
    eager = dict(_kernels.LAUNCHES)
    path = str(tmp_path / "demo.pt2")
    save_serving(export_serving(model, *pts.shape[:2]), path)
    serve = load_serving(path).module()
    _kernels.reset_launches()
    with torch.inference_mode():
        got = serve(pts, msk)
    assert dict(_kernels.LAUNCHES) == eager
    assert eager["pillar_scatter_max"] == 1 and eager["rotated_overlap"] >= 1
    assert (eager["int8_stage"] == 1) == (variant == "int8-fused")
    assert (eager["int8_stage_f32"] == 1) == (variant == "f32-fused")
    assert (eager["int8_conv_f32"] > 0) == variant.startswith("f32-")
    assert eager["int8_conv_pc"] == (2 if variant == "int8-head" else 0)
    assert eager["int8_conv_pc_f32"] == (2 if variant == "f32-head" else 0)
    assert int(want["mask"].sum()) > 0
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_compact_demo_program_on_the_card_equals_eager(cuda, tmp_path):
    """pillarnet18_demo with the compact reader, exported on the card: the
    program launches what eager launches (K2, no K1: the compact reader
    takes its place) and returns eager's detections bit for bit."""
    from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                          spread_head_outputs)
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.runtime.export import (
        export_serving, load_serving, save_serving)

    cfg = load_config(os.path.join(os.path.dirname(__file__), "..",
                                   "configs", "demo", "pillarnet18_demo.py"))
    pts, msk = _demo_cloud(cfg, cuda, 6)
    cfg["model"]["reader"] = dict(cfg["model"]["reader"],
                                  compact_kmax=pts.shape[1])
    model = build_model_from_cfg(cfg, device=cuda, seed=6)
    spread_head_outputs(model, pts, msk)
    _kernels.reset_launches()
    want = make_infer_fn(model)(pts, msk)
    eager = dict(_kernels.LAUNCHES)
    assert int(model.reader_net.dropped_sites) == 0
    path = str(tmp_path / "compact.pt2")
    save_serving(export_serving(model, *pts.shape[:2]), path)
    serve = load_serving(path).module()
    _kernels.reset_launches()
    with torch.inference_mode():
        got = serve(pts, msk)
    assert dict(_kernels.LAUNCHES) == eager
    assert eager["pillar_scatter_max"] == 0 and eager["rotated_overlap"] >= 1
    assert int(want["mask"].sum()) > 0
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_cpu_exported_program_served_on_the_card(cuda, tmp_path):
    """A demo program traced on the CPU, loaded onto the card
    (`load_serving(path, device)`, `move_to_device_pass`): it launches the
    kernel ops (K1 once, K2) and returns the detections that eager serving
    of the same weights on the card returns, bit for bit."""
    from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                          spread_head_outputs)
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.runtime.export import (
        export_serving, load_serving, save_serving)

    cfg = load_config(os.path.join(os.path.dirname(__file__), "..",
                                   "configs", "demo", "pillarnet18_demo.py"))
    cpu = torch.device("cpu")
    pts, msk = _demo_cloud(cfg, cpu, 7)
    model = build_model_from_cfg(cfg, device=cpu, seed=7)
    spread_head_outputs(model, pts, msk)
    path = str(tmp_path / "cpu.pt2")
    save_serving(export_serving(model, *pts.shape[:2]), path)
    model.to(cuda)
    pts, msk = pts.to(cuda), msk.to(cuda)
    _kernels.reset_launches()
    want = make_infer_fn(model)(pts, msk)
    eager = dict(_kernels.LAUNCHES)
    serve = load_serving(path, cuda).module()
    _kernels.reset_launches()
    with torch.inference_mode():
        got = serve(pts, msk)
    assert dict(_kernels.LAUNCHES) == eager
    assert eager["pillar_scatter_max"] == 1 and eager["rotated_overlap"] >= 1
    assert int(want["mask"].sum()) > 0
    for k in want:
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k], want[k]), k


# ---- the tracer on the profiler's clock (runtime/tracing.py) ----------------

def _launches_by_kernel(events, launch_calls):
    """{kernel event: the host runtime call that launched it}, matched by
    the CUPTI correlation id that both carry (the kernel's own or its
    linked one)."""
    from torch.autograd import DeviceType

    calls = {e.correlation_id(): e for e in events
             if e.device_type() == DeviceType.CPU
             and any(k in e.name() for k in launch_calls)}
    out = {}
    for e in events:
        if e.device_type() == DeviceType.CUDA \
                and not e.is_user_annotation():
            call = calls.get(e.correlation_id()) \
                or calls.get(e.linked_correlation_id())
            if call is not None:
                out[e] = call
    return out


def test_tracer_spans_share_the_profilers_clock(cuda):
    """One request of the demo f32 model under `torch.profiler`: each
    tracer span has its `pillarnet.<name>` range in the trace, nested as
    the tracer recorded it; the runtime call that launched K1 lies inside
    `pillarnet.reader` and K2's inside `pillarnet.predict`."""
    import time

    from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                          spread_head_outputs)
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.runtime import tracing
    from pillarnet_lts_torch.runtime.serving import to_host

    cfg = load_config(_DEMO)
    pts, msk = _demo_cloud(cfg, cuda, 7)
    model = build_model_from_cfg(cfg, device=cuda, seed=7)
    spread_head_outputs(model, pts, msk)
    infer = make_infer_fn(model)
    to_host(infer(pts, msk))
    prev = tracing.configure("host")
    t0 = time.perf_counter_ns()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            to_host(infer(pts, msk))
            torch.cuda.synchronize()
    finally:
        tracing.configure(prev)
    spans = [s for s in tracing.snapshot()["spans"] if s["start_ns"] >= t0]
    assert spans and all(s["profiled"] for s in spans)
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    ranges = {}
    for e in events:  # the host ranges (the trace repeats them on the card)
        if e.name().startswith("pillarnet.") \
                and e.device_type() == DeviceType.CPU:
            assert e.name() not in ranges, e.name()
            ranges[e.name()] = (e.start_ns(), e.end_ns())
    by_id = {s["id"]: s for s in spans}
    assert set(ranges) == {f"pillarnet.{s['name']}" for s in spans}
    for s in spans:
        a, b = ranges[f"pillarnet.{s['name']}"]
        if s["parent"] is not None:
            pa, pb = ranges[f"pillarnet.{by_id[s['parent']]['name']}"]
            assert pa <= a <= b <= pb, (s["name"], by_id[s["parent"]]["name"])
    assert ranges["pillarnet.serving.sync"][0] \
        >= ranges["pillarnet.serving.request"][1]
    launches = _launches_by_kernel(
        events, ("LaunchKernel", "cuLaunch"))
    found = {}
    for kernel, call in launches.items():
        for tag, keys, layer in (
                ("K1", ("scatter_max_claim", "scatter_max_merge",
                        "ClaimedPillars"), "reader"),
                ("K2", ("rotated_overlap",), "predict")):
            if any(k in kernel.name() for k in keys):
                a, b = ranges[f"pillarnet.{layer}"]
                assert a <= call.start_ns() <= b, (tag, call.name())
                found[tag] = found.get(tag, 0) + 1
    assert found.get("K1", 0) >= 1 and found.get("K2", 0) >= 1, (
        found, sorted({k.name()[:60] for k in launches}))
