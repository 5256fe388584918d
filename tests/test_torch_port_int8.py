"""PyTorch port, int8 deploy modules: each against the JAX package on the
same numpy inputs.

Bit-equality where the JAX package computes int8: quantize (round half to
even), int32 sums, then the f32 dequant (acc * dq + shift) and one bf16
rounding. Two things of XLA's CPU backend would break it and are set
aside here, both stated where they are used:

- XLA's fusion contracts a * b + c to an FMA; the port (and its CUDA
  kernels, built with -fmad=false) rounds the product and the sum
  separately. The JAX references compile with the fusion pass off
  (`jit_nofma`), which keeps every op as written.
- XLA's CPU rsqrt is not correctly rounded (1 ulp from torch's on ~30% of
  inputs), so a BN fold differs by an ulp. `int8_variables` draws batch
  variances with var + eps a power of 4, where both are exact; scales,
  means and biases stay random.

bf16 float paths (calibration forwards) agree only to bf16 rounding; their
tolerance is stated at the test.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillarnet_lts_tpu.models.backbones.base import MaskedConv as JMaskedConv
from pillarnet_lts_tpu.models.backbones.base import (
    _tile4,
    conv_core_int8 as jconv_core_int8,
    expand_kernel_s2d_aligned,
    quantize_act as jquantize_act,
    s2d_pack,
    s2d_unpack,
)
from pillarnet_lts_tpu.models.readers.dynamic_pillar_encoder import (
    DynamicPFE as JDynamicPFE,
)
from pillarnet_lts_tpu.ops.pallas.s2d_conv_kernel import s2d_stage_int8
from pillarnet_lts_tpu.runtime.quantize import calibrate as jcalibrate
from pillarnet_lts_torch.models.readers.dynamic_pillar_encoder import (
    DynamicPFE,
)
from pillarnet_lts_torch.ops import quant
from pillarnet_lts_torch.ops.int8_stage import int8_stage
from pillarnet_lts_torch.ops.voxelize import scatter_max_to_grid
from pillarnet_lts_torch.runtime.convert import load_jax_variables
from pillarnet_lts_torch.runtime.quantize import calibrate
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_torch_port_modules import random_variables

BF16 = jnp.bfloat16
EPS = 1e-3  # MaskedBatchNorm eps
PC_RANGE = (-16.0, -16.0, -4.0, 16.0, 16.0, 2.0)


def jit_nofma(fn, *args):
    """jax.jit(fn)(*args) compiled without XLA's fusion pass: unfused, each
    f32 multiply and add rounds on its own (no FMA contraction)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "fusion"})(*args)


def int8_variables(module, seed, *args, **kwargs):
    """`random_variables`, with every BN variance set to 4^k - eps (k in
    -1..1) so that rsqrt(var + eps) is exact in XLA and in torch."""
    variables = random_variables(module, seed, *args, **kwargs)
    rng = np.random.RandomState(seed + 1000)

    def fix(path, v):
        if path[0].key == "batch_stats" and path[-1].key == "var":
            p = 4.0 ** rng.randint(-1, 2, v.shape)
            v = (p.astype(np.float32) - np.float32(EPS)).astype(np.float32)
            assert np.all(v + np.float32(EPS) == p)
        return np.asarray(v)

    return jax.tree_util.tree_map_with_path(fix, variables)


def to_np(t):
    return t.float().numpy()


def test_quantize_and_weight_quant_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 11, 32).astype(np.float32) * 3
    s_x = np.float32(np.abs(x).max() / 127.0 * 0.8)  # some codes clip
    # exact halves: round half to even in both
    x[0, 0, 0, :4] = np.array([0.5, 1.5, -2.5, 126.5], np.float32) * s_x
    xb = jnp.asarray(x, BF16)
    want = jit_nofma(jquantize_act, xb, jnp.float32(s_x))
    got = quant.quantize_act(torch.from_numpy(np.asarray(xb, np.float32))
                             .to(torch.bfloat16), torch.tensor(s_x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().max() == 127 and got.numpy().min() == -127

    kernel = rng.randn(3, 3, 32, 64).astype(np.float32)
    jm = JMaskedConv(64, 32, quant=True)

    def jweights(k):
        return jm.apply({"params": {"kernel": k, "bias": jnp.zeros(64)}},
                        method=lambda m: (m.weight_scale(),
                                          m.kernel_int8(m.weight_scale())))

    s_w, kq = jit_nofma(jweights, kernel)
    w = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
    t_s_w = quant.weight_scale(w)
    np.testing.assert_array_equal(t_s_w.numpy(), np.asarray(s_w))
    np.testing.assert_array_equal(quant.kernel_int8(w, t_s_w).numpy(),
                                  np.asarray(kq))


def _conv_case(seed, stride, cin=32, cout=64, B=2, H=12, W=10):
    rng = np.random.RandomState(seed)
    occ = rng.rand(B, H, W) < 0.4
    x = (rng.randn(B, H, W, cin) * occ[..., None]).astype(np.float32)
    x = np.asarray(jnp.asarray(x, BF16), np.float32)
    kq = rng.randint(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    s_x = np.float32(np.abs(x).max() / 127.0)
    s_w = (rng.rand(cout).astype(np.float32) + 0.5) / 127.0
    inv = (rng.rand(cout) + 0.5).astype(np.float32)
    dq = (s_x * s_w) * inv
    shift = (rng.randn(cout) * 0.3).astype(np.float32)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    mask = rng.rand(B, Ho, Wo) < 0.5
    res = np.asarray(jnp.asarray(rng.randn(B, Ho, Wo, cout) * mask[..., None],
                                 BF16), np.float32)
    return x, kq, s_x, dq, shift, mask, res


@pytest.mark.parametrize("stride,use_mask,use_res,act", [
    (1, True, True, True),     # a residual pair's tail conv
    (1, True, False, False),   # a BlockV's conv0
    (2, True, False, True),    # a strided down conv
    (1, False, False, True),   # conv5 / the neck (dense)
])
def test_int8_conv_bn_act_matches_jax(stride, use_mask, use_res, act):
    """Bit-equal to `quantize_act` + `conv_core_int8` + the f32 epilogue
    (`base.py:692-703`), then the block's residual / ReLU / re-zero."""
    x, kq, s_x, dq, shift, mask, res = _conv_case(stride, stride)

    def jref(x, kq, s_x, dq, shift, mask, res):
        yq = jconv_core_int8(jquantize_act(x, s_x), kq, stride,
                             ((1, 1), (1, 1)))
        y = (yq.astype(jnp.float32) * dq + shift).astype(BF16)
        if use_res:
            y = y + res
        if act:
            y = jax.nn.relu(y)
        if use_mask:
            y = y * mask.astype(BF16)[..., None]
        return y

    want = jit_nofma(jref, jnp.asarray(x, BF16), jnp.asarray(kq),
                     jnp.float32(s_x), dq, shift, mask,
                     jnp.asarray(res, BF16))
    bf = torch.bfloat16
    got = quant.int8_conv_bn_act(
        torch.from_numpy(x).to(bf), torch.from_numpy(kq),
        1.0 / torch.tensor(s_x), torch.from_numpy(dq),
        torch.from_numpy(shift), stride,
        mask=torch.from_numpy(mask).to(bf) if use_mask else None,
        residual=torch.from_numpy(res).to(bf) if use_res else None, act=act)
    assert got.dtype == bf and got.shape == want.shape
    np.testing.assert_array_equal(to_np(got), np.asarray(want, np.float32))
    assert np.count_nonzero(to_np(got)) > 0


@pytest.mark.parametrize("n_convs", [3, 7])
def test_int8_stage_matches_jax_fused_stage(n_convs):
    """The plain K5 chain against `s2d_stage_int8` in interpret mode on the
    s2d-packed layout, bit-equal (the int32 sums do not depend on it)."""
    rng = np.random.RandomState(n_convs)
    B, H, W, c = 2, 20, 24, 32
    occ = rng.rand(B, H, W) < 0.3
    fine = np.asarray(jnp.asarray(rng.randn(B, H, W, c) * occ[..., None],
                                  BF16), np.float32)
    kq = rng.randint(-127, 128, (n_convs, 3, 3, c, c)).astype(np.int8)
    s_x = (0.02 + 0.01 * np.arange(n_convs)).astype(np.float32)
    s_w = (rng.rand(n_convs, c).astype(np.float32) * 0.5 + 0.5) / 127.0 * 0.3
    inv = (rng.rand(n_convs, c) * 0.6 + 0.2).astype(np.float32)
    dq = (s_x[:, None] * s_w) * inv
    shift = (rng.randn(n_convs, c) * 0.05).astype(np.float32)
    inv_s = np.float32(1.0) / s_x

    def jstage(x, kq, dq, shift, inv_s, maskc):
        w = jnp.stack([expand_kernel_s2d_aligned(k) for k in kq])
        p = jnp.stack([jnp.stack([_tile4(dq[i]), _tile4(shift[i]),
                                  jnp.full((4 * c,), inv_s[i])])
                       for i in range(n_convs)])
        y = s2d_stage_int8(s2d_pack(x), w, p, s2d_pack(maskc),
                           interpret=True)
        return s2d_unpack(y, c)

    maskc = np.repeat(occ[..., None], c, -1)
    want = jit_nofma(jstage, jnp.asarray(fine, BF16), jnp.asarray(kq), dq,
                     shift, inv_s, jnp.asarray(maskc, BF16))
    bf = torch.bfloat16
    got = int8_stage(torch.from_numpy(fine).to(bf), torch.from_numpy(kq),
                     torch.from_numpy(inv_s), torch.from_numpy(dq),
                     torch.from_numpy(shift), torch.from_numpy(occ).to(bf))
    np.testing.assert_array_equal(to_np(got), np.asarray(want, np.float32))
    assert np.count_nonzero(to_np(got)) > 0


def _points(seed, B=2, N=3000):
    rng = np.random.RandomState(seed)
    pts = np.zeros((B, N, 5), np.float32)
    pts[..., :2] = rng.uniform(-17, 17, (B, N, 2))
    pts[..., 2] = rng.uniform(-4, 2, (B, N))
    pts[..., 3] = rng.uniform(0, 255, (B, N))
    pts[..., 4] = rng.uniform(0, 0.45, (B, N))
    return pts, rng.rand(B, N) > 0.05


PFE_KW = dict(in_channels=5, num_filters=(32,), pillar_size=0.25,
              pc_range=PC_RANGE, quant=True)


def test_pfn_int8_and_scatter_payload_match_jax():
    """Calibrated int8 reader (per-input-channel MLP, int8 scatter payload,
    f32 dequant rounded once to bf16), bit-equal."""
    pts, msk = _points(0)
    jm = JDynamicPFE(**PFE_KW, dtype=BF16)
    args = (jnp.asarray(pts), jnp.asarray(msk))
    variables = int8_variables(jm, 1, *args, train=False)
    variables["quant"] = {
        # per input channel [dx, dy, x, y, z, intensity, time]; some clip
        "pfn_dense_0": {"in_absmax": np.array(
            [0.12, 0.12, 15.0, 17.0, 4.0, 200.0, 0.45], np.float32)},
        "scatter_absmax": np.float32(2.5)}  # codes clip at the top
    want_grid, want_occ = jit_nofma(
        lambda v, p, m: jm.apply(v, p, m, train=False), variables, *args)

    tm = load_jax_variables(
        DynamicPFE(**PFE_KW, dtype=torch.bfloat16).eval(), variables)
    assert tm.quant_ready() and tm.pfn_dense_0.quant_ready()
    with torch.inference_mode():
        grid, occ = tm(torch.from_numpy(pts), torch.from_numpy(msk))
    assert grid.dtype == torch.bfloat16
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want_occ))
    np.testing.assert_array_equal(to_np(grid),
                                  np.asarray(want_grid, np.float32))
    assert to_np(grid).max() == pytest.approx(2.5, rel=1e-2)


def test_int8_scatter_plain_is_the_code_max():
    rng = np.random.RandomState(3)
    codes = rng.randint(0, 128, (2, 500, 32)).astype(np.int8)
    ids = rng.randint(0, 40, (2, 500)).astype(np.int32)
    valid = rng.rand(2, 500) > 0.2
    grid, occ = scatter_max_to_grid(torch.from_numpy(codes),
                                    torch.from_numpy(ids),
                                    torch.from_numpy(valid), 5, 8)
    assert grid.dtype == torch.int8
    g = grid.numpy().reshape(2, 40, 32)
    for b in range(2):
        for p in range(40):
            sel = valid[b] & (ids[b] == p)
            assert occ.numpy().reshape(2, 40)[b, p] == sel.any()
            want = codes[b][sel].max(0) if sel.any() else np.zeros(32)
            np.testing.assert_array_equal(g[b, p], want)


def _calibration_cfg():
    """The int8 slice's config (`test_torch_port_int8_e2e.py`) cut in depth
    for the calibration test: PillarResNet18, one conv per neck block."""
    from test_torch_port_int8_e2e import shrunk_int8_cfg

    mcfg, tcfg = shrunk_int8_cfg(grid=32)
    mcfg["backbone"]["type"] = "PillarResNet18"
    mcfg["neck"]["layer_nums"] = [0, 0]
    return mcfg, tcfg


@pytest.fixture(scope="module")
def calibration_case():
    """The shrunk int8 config's JAX model, its weights and two clouds."""
    from pillarnet_lts_tpu.models import build_detector as build_jax

    mcfg, tcfg = _calibration_cfg()
    jmodel = build_jax(copy.deepcopy(mcfg), test_cfg=tcfg)
    clouds = [_points(s, B=1, N=2000) for s in (5, 6)]
    variables = int8_variables(jmodel, 9, *map(jnp.asarray, clouds[0]),
                               train=False)
    variables.pop("quant", None)
    return mcfg, tcfg, jmodel, variables, clouds


@pytest.mark.parametrize("reduce", ["max", "mean"])
def test_calibrate_matches_jax(calibration_case, reduce):
    """Same weights, same clouds: the port's absmax per module against the
    JAX 'quant' collection. The reader's input absmax is exact (the same
    f32 features cast to bf16); later modules see bf16 activations that
    XLA and ATen round differently, so those agree within 2% (a few bf16
    ulps through the chain)."""
    from pillarnet_lts_torch.models import build_detector

    mcfg, tcfg, jmodel, variables, clouds = calibration_case
    jq = jcalibrate(jmodel, variables, clouds, reduce=reduce)["quant"]

    port = load_jax_variables(build_detector(mcfg, test_cfg=tcfg), variables)
    calibrate(port, [tuple(map(torch.from_numpy, c)) for c in clouds],
              reduce=reduce)
    got = {}
    for name, m in port.named_modules():
        if getattr(m, "quant", False):
            got[tuple(name.split("."))] = m.absmax().numpy()
    flat = {tuple(p.key for p in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(jq)[0]}
    # reader 2 + backbone 5 (stage 1) + 3 x 5 + 3 (conv5) + neck 2
    assert set(got) == {p[:-1] for p in flat} and len(got) == 27
    for path, v in flat.items():
        g = got[path[:-1]]
        if path[-2] == "pfn_dense_0":
            np.testing.assert_array_equal(g, v)
        else:
            np.testing.assert_allclose(g, v, rtol=2e-2, err_msg=str(path))


def test_load_jax_variables_quant_collection():
    pts, msk = _points(7, B=1, N=1000)
    jm = JDynamicPFE(**PFE_KW, dtype=BF16)
    variables = random_variables(jm, 0, jnp.asarray(pts), jnp.asarray(msk),
                                 train=False)
    assert sorted(variables["quant"]) == ["pfn_dense_0", "scatter_absmax"]
    tm = load_jax_variables(DynamicPFE(**PFE_KW), variables)
    np.testing.assert_array_equal(tm.scatter_absmax.numpy(),
                                  variables["quant"]["scatter_absmax"])
    assert tm.quant_ready() and tm.pfn_dense_0.quant_ready()

    # no 'quant' collection: loads, stays uncalibrated
    plain = {k: v for k, v in variables.items() if k != "quant"}
    tm = load_jax_variables(DynamicPFE(**PFE_KW), plain)
    assert not tm.quant_ready() and not tm.pfn_dense_0.quant_ready()

    missing = copy.deepcopy(variables)
    del missing["quant"]["scatter_absmax"]
    with pytest.raises(KeyError, match="quant/scatter_absmax"):
        load_jax_variables(DynamicPFE(**PFE_KW), missing)
    extra = copy.deepcopy(variables)
    extra["quant"]["pfn_bn_0"] = {"in_absmax": np.float32(1.0)}
    with pytest.raises(KeyError, match="quant/pfn_bn_0/in_absmax"):
        load_jax_variables(DynamicPFE(**PFE_KW), extra)
    # a quant collection for a model built without the int8 flags
    with pytest.raises(KeyError, match="pfn_dense_0/in_absmax"):
        load_jax_variables(DynamicPFE(**{**PFE_KW, "quant": False}),
                           variables)
