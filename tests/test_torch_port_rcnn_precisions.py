"""PyTorch port, the two-stage model in the precisions users serve: int8
on f32 activations (`enable_backbone_quant` on an f32 config, the JAX
package's `rcnn_int8` build) and bf16 (`dtype="bfloat16"`), against the
JAX package on the same numpy inputs and weights.

Tolerances:
- the int8 conv's plain version on f32 activations: bit-equal to the JAX
  package's f32 int8 core (`quantize_act` + `conv_core_int8` + the f32
  epilogue `y * dq + b`, `base.py:697-703`, then residual, ReLU, mask)
  compiled without XLA's fusion (`test_torch_port_int8.py::jit_nofma`);
- calibration through a two-stage model: the same modules observe, in the
  same order, once per calibration forward; the reader's scales (its
  per-channel input absmax and the scatter payload's) are bit-equal, the
  conv inputs' within 2e-6 relative (a few f32 ulps): the f32 convs
  before them sum in other orders in XLA and in ATen, and the max of a
  map moves with its last bits. The int8 models below then take the JAX
  package's scales (its 'quant' collection, `load_jax_variables`), so
  both run the same int8 arithmetic;
- the int8 two-stage eval (`pillarrcnn18_demo`, `twostage18_demo`) against
  JAX compiled without fusion: head maps within 1e-4, RoI labels and the
  final mask equal, RoI scores within 1e-5, after the score and IoU
  margins of the f32 tests are asserted; boxes within 5e-4 m + 2e-4
  relative and scores within 5e-5 (looser than the f32 eval's 1e-4 m
  and 1e-5: the random-weight refinements reach 40 m, and the f32 layers
  around the int8 convs (the transposed convs, the head, the second
  stage) sum in other orders, which the exact-rsqrt BN statistics of
  these weights (scales up to 2) amplify);
- bf16 (`pillarrcnn18_demo` with `dtype="bfloat16"`): the first stage's
  maps within 5e-2 of each map's max |value| (bf16 roundings compound
  through the backbone and neck, as `test_torch_port_int8_e2e.py`'s bf16
  config); the second stage given the JAX package's RoIs and maps (the
  first stage's top-k and NMS can pick other candidates near a bf16 score
  tie, so the whole-model RoI sets are not compared): RoI labels equal,
  the grid points within 1e-5 m (f32 from the f32 RoIs), the point logits
  and the RoI head's class and regression outputs within 4e-2 of max
  |value| (a few bf16 ulps: the fusion conv and the bf16 Dense layers
  round with their BN folded in the port and after the rounded Dense in
  JAX), decoded boxes within 4e-2 m + 1e-2 relative and final scores
  within 1e-2 (a bf16 ulp of a logit near 1 is 2^-7).
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillarnet_lts_tpu.models import build_detector as build_jax_detector
from pillarnet_lts_tpu.models.backbones.base import (
    conv_core_int8 as jconv_core_int8,
    quantize_act as jquantize_act,
)
from pillarnet_lts_tpu.runtime.quantize import calibrate as jcalibrate
from pillarnet_lts_tpu.runtime.quantize import (
    enable_backbone_quant as jenable_backbone_quant,
)
from pillarnet_lts_torch.apis import build_model_from_cfg, load_config
from pillarnet_lts_torch.ops import quant
from pillarnet_lts_torch.runtime.convert import load_jax_variables
from pillarnet_lts_torch.runtime.quantize import (calibrate,
                                                  enable_backbone_quant,
                                                  observers)
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_torch_port_int8 import _conv_case, int8_variables, jit_nofma
from test_torch_port_modules import random_variables
from test_torch_port_legacy import _guards, twostage_cfg
from test_torch_port_rcnn import spread_rcnn_heads

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RCNN_DEMO = os.path.join(ROOT, "configs", "demo", "pillarrcnn18_demo.py")


# ---- (i) the int8 conv on f32 activations -------------------------------------


@pytest.mark.parametrize("stride,use_mask,use_res,act", [
    (1, True, True, True),     # a residual pair's tail conv
    (1, True, False, False),   # a BlockV's conv0
    (2, True, False, True),    # a strided down conv
    (1, False, False, True),   # conv5 / the neck (dense)
])
def test_int8_conv_f32_matches_jax(stride, use_mask, use_res, act):
    """f32 activations quantized themselves (no bf16 copy), the f32
    epilogue with no rounding to bf16, then residual / ReLU / re-zero in
    f32: bit-equal to the JAX package's f32 int8 core."""
    x, kq, s_x, dq, shift, mask, res = _conv_case(10 + stride, stride)
    rng = np.random.RandomState(stride)
    # f32 values off the bf16 grid, some exactly on a rounding half
    x = (x + rng.randn(*x.shape).astype(np.float32) * 1e-3
         * (x != 0)).astype(np.float32)
    x[0, 0, 0, :3] = np.array([0.5, 1.5, -2.5], np.float32) * s_x
    res = (res + rng.randn(*res.shape).astype(np.float32) * 1e-3
           * (res != 0)).astype(np.float32)

    def jref(x, kq, s_x, dq, shift, mask, res):
        yq = jconv_core_int8(jquantize_act(x, s_x), kq, stride,
                             ((1, 1), (1, 1)))
        y = (yq.astype(jnp.float32) * dq + shift).astype(jnp.float32)
        if use_res:
            y = y + res
        if act:
            y = jax.nn.relu(y)
        if use_mask:
            y = y * mask.astype(jnp.float32)[..., None]
        return y

    want = np.asarray(jit_nofma(jref, jnp.asarray(x), jnp.asarray(kq),
                                jnp.float32(s_x), dq, shift, mask,
                                jnp.asarray(res)))
    f32 = torch.float32
    got = quant.int8_conv_bn_act(
        torch.from_numpy(x), torch.from_numpy(kq), 1.0 / torch.tensor(s_x),
        torch.from_numpy(dq), torch.from_numpy(shift), stride,
        mask=torch.from_numpy(mask).to(f32) if use_mask else None,
        residual=torch.from_numpy(res) if use_res else None, act=act,
        w_pack=quant.pack_kernel(torch.from_numpy(kq)))
    assert got.dtype == f32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.count_nonzero(got.numpy()) > 0
    # a bf16 copy of x quantizes to other codes: the f32 route does not
    # take it
    xb = torch.from_numpy(x).to(torch.bfloat16).float()
    assert not torch.equal(quant.quantize_act(xb, torch.tensor(s_x)),
                           quant.quantize_act(torch.from_numpy(x),
                                              torch.tensor(s_x)))


# ---- (ii) int8 two-stage -----------------------------------------------------


def _cloud(cfg, seed, n=4096):
    from __graft_entry__ import _synth_points_realistic

    return _synth_points_realistic(1, n, cfg["point_cloud_range"], seed=seed,
                                   nsweeps=1)


def _flat(tree):
    return {tuple(p.key for p in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _int8_case(cfg):
    """The int8 build of `cfg` in both packages: JAX weights with exact-rsqrt
    BN, JAX's calibration on two clouds; the port calibrated on the same
    clouds, then given JAX's scales."""
    jcfg = copy.deepcopy(cfg)
    jenable_backbone_quant(jcfg["model"])
    enable_backbone_quant(cfg["model"])
    clouds = [_cloud(cfg, s) for s in (3, 4)]
    jm = build_jax_detector(jcfg["model"], test_cfg=cfg["test_cfg"])
    variables = jax.tree_util.tree_map(np.array, int8_variables(
        jm, 13, *map(jnp.asarray, clouds[0]), train=False))
    variables.pop("quant", None)
    port = build_model_from_cfg(cfg, device="cpu")
    tpts, tmsk = (torch.from_numpy(a) for a in clouds[0])
    spread_rcnn_heads(port, variables, tpts, tmsk)
    jq = jax.tree_util.tree_map(np.asarray, jcalibrate(
        jm, variables, [tuple(map(jnp.asarray, c)) for c in clouds])["quant"])
    calibrate(port, [tuple(map(torch.from_numpy, c)) for c in clouds])
    return jm, variables, jq, port, clouds


@pytest.mark.parametrize("name", ["pillarrcnn18_demo", "twostage18_demo"])
def test_int8_two_stage_matches_jax(name):
    cfg = (load_config(RCNN_DEMO) if name == "pillarrcnn18_demo"
           else twostage_cfg(5))
    assert cfg["model"].get("dtype") is None  # f32 compute
    jm, variables, jq, port, clouds = _int8_case(cfg)

    # calibration: every observer of the first stage, none elsewhere
    got = {tuple(n.split(".")): m for n, m in port.named_modules()
           if m in observers(port)}
    want = _flat(jq)
    assert {p[:-1] for p in want} == set(got)
    assert all(p[0] == "single_det" for p in got)
    # reader 2 + backbone 5 + 3 x 5 + 3 (conv5) + neck (RPNG 3 x 6, RPNV1
    # 2 x 3)
    assert len(got) == (43 if name == "pillarrcnn18_demo" else 31)
    for path, v in want.items():
        g = got[path[:-1]].absmax().numpy()
        if path[2] == "reader_net":
            np.testing.assert_array_equal(g, v, err_msg=str(path))
        else:
            np.testing.assert_allclose(g, v, rtol=2e-6, atol=0,
                                       err_msg=str(path))

    # the int8 forward, with the JAX package's scales in both
    vq = {**variables, "quant": jq}
    load_jax_variables(port, vq)
    pts, msk = clouds[1]
    jout = jit_nofma(lambda v, p, m: jm.apply(v, p, m, train=False), vq,
                     jnp.asarray(pts), jnp.asarray(msk))
    jdet = {k: np.asarray(v) for k, v in jit_nofma(jm.post_process, jout)
            .items()}
    tpts, tmsk = torch.from_numpy(pts), torch.from_numpy(msk)
    with torch.inference_mode():
        out = port(tpts, tmsk)
    det = {k: v.numpy() for k, v in port.post_process(out).items()}
    first, *_ = port.first_stage(tpts, tmsk)
    _guards(port, out["one_stage_preds"], first, port.processed_test_cfg())
    for p, q in zip(out["one_stage_preds"], jout["one_stage_preds"]):
        for h in p:
            np.testing.assert_allclose(p[h].numpy(), np.asarray(q[h]),
                                       rtol=1e-4, atol=1e-4, err_msg=h)
    np.testing.assert_array_equal(out["roi_labels"].numpy(),
                                  np.asarray(jout["roi_labels"]))
    np.testing.assert_allclose(out["roi_scores"].numpy(),
                               np.asarray(jout["roi_scores"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(det["mask"], jdet["mask"])
    m = det["mask"]
    assert m.sum() > 5
    np.testing.assert_array_equal(det["label_preds"], jdet["label_preds"])
    np.testing.assert_allclose(det["box3d_lidar"][m], jdet["box3d_lidar"][m],
                               rtol=2e-4, atol=5e-4)
    np.testing.assert_allclose(det["scores"][m], jdet["scores"][m], rtol=0,
                               atol=5e-5)


def test_int8_f32_convs_fit_the_kernel_on_pillarrcnn18_waymo():
    """Every quantized conv of the full-width `pillarrcnn18_waymo` int8
    build is one K4 takes: 3 x 3, stride 1 or 2, input channels in 32s,
    output channels in 32s, in the model's f32 (no forward: the model is
    only built)."""
    from pillarnet_lts_torch.models.backbones.base import MaskedConv

    cfg = load_config(os.path.join(ROOT, "configs", "pillarrcnn",
                                   "pillarrcnn18_waymo.py"))
    enable_backbone_quant(cfg["model"])
    port = build_model_from_cfg(cfg, device="cpu")
    assert port.dtype == torch.float32
    convs = {n: m for n, m in port.named_modules()
             if isinstance(m, MaskedConv) and m.quant}
    # backbone 5 + 3 x 5 + 3 (conv5) + neck 3 x 6
    assert len(convs) == 41
    for n, m in convs.items():
        o, i, kh, kw = m.weight.shape
        assert (kh, kw) == (3, 3) and m.stride in (1, 2), n
        assert i % 32 == 0 and o % 32 == 0, (n, i, o)
    assert not any(isinstance(m, MaskedConv) and m.quant
                   for n, m in port.named_modules()
                   if not n.startswith("single_det.backbone_net")
                   and not n.startswith("single_det.neck_net"))


# ---- (iii) bf16 two-stage ----------------------------------------------------


def _close_to_scale(got, want, frac, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = float(np.abs(want).max()) + 1e-6
    err = float(np.abs(got - want).max())
    assert err <= frac * scale, f"{what}: max |d| {err} > {frac} x {scale}"
    return err / scale


def _to_port_map(x):
    """A JAX NHWC map (bf16) -> the port's NCHW channels_last bf16."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).permute(0, 3, 1, 2)


def test_bf16_two_stage_matches_jax():
    cfg = load_config(RCNN_DEMO)
    cfg["model"]["dtype"] = "bfloat16"
    pts, msk = _cloud(cfg, 3)
    jm = build_jax_detector(copy.deepcopy(cfg["model"]),
                            test_cfg=cfg["test_cfg"])
    variables = jax.tree_util.tree_map(np.array, random_variables(
        jm, 13, jnp.asarray(pts), jnp.asarray(msk), train=False))
    port = load_jax_variables(build_model_from_cfg(cfg, device="cpu"),
                              variables)
    assert port.dtype == torch.bfloat16
    tpts, tmsk = torch.from_numpy(pts), torch.from_numpy(msk)

    def run(mod, p, m):
        preds, bev, feats = mod.single_det.forward_two_stage(p, m,
                                                             train=False)
        first = mod.single_det.predict(
            {}, preds, mod.single_det.processed_test_cfg())
        return preds, bev, feats, first

    jfirst = jax.jit(lambda v, p, m: jm.apply(v, p, m, method=run))
    args = (jnp.asarray(pts), jnp.asarray(msk))

    # the first stage in bf16, before the heads are spread (the spread
    # centres each map on its median, which shrinks its max, not its
    # bf16 error)
    jpreds, jbev, jfeats, _ = jfirst(variables, *args)
    with torch.inference_mode():
        preds, bev, feats = port.single_det.forward_two_stage(tpts, tmsk)
    for k, (f, _) in feats.items():
        assert f.dtype == torch.bfloat16
        _close_to_scale(f.permute(0, 2, 3, 1).float().numpy(), jfeats[k][0],
                        5e-2, k)
    for b, jb in zip(bev, jbev):
        _close_to_scale(b.permute(0, 2, 3, 1).float().numpy(), jb, 5e-2,
                        "bev")
    for p, q in zip(preds, jpreds):
        for h in p:
            assert p[h].dtype == torch.bfloat16
            _close_to_scale(p[h].float().numpy(), q[h], 5e-2, h)

    # the second stage given JAX's RoIs and maps, heads spread
    spread_rcnn_heads(port, variables, tpts, tmsk)
    _, jbev, jfeats, jfirst_det = jfirst(variables, *args)
    jout = jax.jit(lambda v, p, m: jm.apply(v, p, m, train=False))(
        variables, *args)
    jdet = jax.jit(jm.post_process)(jout)
    first = {k: torch.from_numpy(np.array(v)) for k, v in
             jfirst_det.items()}
    tbev = tuple(_to_port_map(b) for b in jbev)
    tfeats = {k: (_to_port_map(f), None if o is None else
                  torch.from_numpy(np.array(o)))
              for k, (f, o) in jfeats.items()}
    with torch.inference_mode():
        out = port.second_stage(first, tbev, tfeats)
    det = port.post_process(out)
    np.testing.assert_array_equal(out["roi_labels"].numpy(),
                                  np.asarray(jout["roi_labels"]))
    assert len(set(np.unique(out["roi_labels"].numpy()).tolist())) >= 3
    assert out["rcnn_cls"].dtype == torch.bfloat16
    assert det["scores"].dtype == torch.float32
    # the RoI grid in f32 from f32 RoIs: jitted XLA's FMAs and sin/cos
    np.testing.assert_allclose(out["point_coords"].numpy(),
                               np.asarray(jout["point_coords"]), rtol=0,
                               atol=1e-5)
    errs = {}
    for k, frac in (("point_logits", 4e-2), ("rcnn_cls", 4e-2),
                    ("rcnn_reg", 4e-2)):
        errs[k] = _close_to_scale(out[k].float().numpy(), jout[k], frac, k)
    m = det["mask"].numpy()
    np.testing.assert_array_equal(m, np.asarray(jdet["mask"]))
    assert m.sum() > 20
    np.testing.assert_allclose(det["box3d_lidar"].numpy()[m],
                               np.asarray(jdet["box3d_lidar"])[m],
                               rtol=1e-2, atol=4e-2)
    np.testing.assert_allclose(det["scores"].numpy()[m],
                               np.asarray(jdet["scores"])[m], rtol=0,
                               atol=1e-2)
