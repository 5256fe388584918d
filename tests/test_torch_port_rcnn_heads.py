"""PyTorch port, the two-stage remainder: the RoI token mixers
(`mlp_layers.py`), `RoIFFNHead` with its IoU branch and
`box_iou_layer_loss`, and the point head's `ATT_MODEL`, against the JAX
package on the same numpy inputs and weights
(`runtime/convert.py::load_jax_variables`).

Tolerances:
- `MLPMixer`, `ResMLPLayer`, `RoIFFNHead` and `RoIMIXHead` with a mixer,
  eval forward in f32: rtol = atol = 1e-4 (f32 sums in different orders
  in XLA and ATen, as `test_torch_port_rcnn.py`); in bf16 every output
  within 2e-2 of its largest |value| (bf16 products and LayerNorm outputs
  rounded at different places by XLA's and ATen's CPU kernels);
- `box_iou_layer_loss`: value within rtol 1e-5 and its gradient within
  rtol 1e-5 / atol 1e-8 of `jax.grad` (the RCNN losses' tolerance in
  `test_torch_port_rcnn_train.py`); a batch without a foreground RoI
  gives 0 in both;
- the training second stage of `pillarrcnn18_demo` with `RoIFFNHead`,
  with `MLPMixer` and with `ATT_MODEL`, on fixed first-stage outputs and
  the same sampler draws (dropout off): the sampled RoIs equal, each loss
  within rtol 1e-4, every second-stage parameter's gradient within 1e-3
  of JAX's in norm with the JAX package's ReLUs taking the port's
  decisions, as `test_torch_port_rcnn_train.py` holds the config's own
  head; the loss dict (`roi_iou_loss` included) within rtol 1e-4 of the
  JAX package's `loss` on the same output;
- the same training second stage in bf16 (the config's own head and the
  three variants) on the same first-stage maps rounded to bf16, the JAX
  package's L1s taking the port's signs as its ReLUs take the port's
  decisions (the refinement starts within rounding of its targets, and
  an L1's gradient flips with each such sign), and its heads' outputs
  cast to f32 before its losses as the port's are: the sampled RoIs
  equal, each loss within rtol 2e-2 (0.4% seen), every weight leaf's
  gradient (kernels, BN and LayerNorm scales) and each module's whole
  gradient within 5e-2 of JAX's in norm (2.6% seen; bf16 keeps 8
  significant bits, and each of ~10 layers forward and back rounds
  again); the biases are held within their module's gradient, as a
  bias's gradient is a sum that cancels;
- the port's RCNN, point and IoU losses against the JAX package's loss
  functions on the port's own heads' outputs cast to f32: rtol 1e-5, in
  f32 and bf16 (the cast to f32 the port makes before its losses);
- the whole demo eval with each of those three variants (`ResMLP` is
  held at the module and head level above): the RoI set and the final mask
  and labels equal, boxes within 1e-4 m and scores within 1e-5, as
  `test_torch_port_rcnn.py::test_demo_two_stage_eval_matches_jax`.
"""

import copy
import os
import types

import numpy as np
import pytest
import torch

import flax.linen
import jax
import jax.numpy as jnp

from pillarnet_lts_tpu.models import build_detector as build_jax_detector
from pillarnet_lts_tpu.models.roi_heads import mlp_layers as jmlp
from pillarnet_lts_tpu.models.roi_heads import roi_head_template as jtpl
from pillarnet_lts_tpu.models.roi_heads import roi_heads as jroi
from pillarnet_lts_tpu.models.point_heads import point_head as jph
from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                      rcnn_variant)
from pillarnet_lts_torch.models.backbones import base as tbase
from pillarnet_lts_torch.models.roi_heads import mlp_layers as tmlp
from pillarnet_lts_torch.models.roi_heads import roi_head_template as ttpl
from pillarnet_lts_torch.models.roi_heads import roi_heads as troi
from pillarnet_lts_torch.models.second_stage import bev_feature as tbev
from pillarnet_lts_torch.models.utils import dense as tdense
from pillarnet_lts_torch.runtime.convert import (load_jax_variables,
                                                 variables_of)
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_torch_port_modules import TOL, jit_apply, random_variables
from test_torch_port_rcnn import HEAD_CFG, random_rois
from test_torch_port_rcnn_train import (_RecordingF, _demo_cfg,
                                        _fixed_first_stage, jax_draws)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DEMO = os.path.join(ROOT, "configs", "demo", "pillarrcnn18_demo.py")
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
BF16_FRAC = 2e-2
BF16_GRAD_RTOL = 5e-2


def _close(got, want, dtype):
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        assert err <= BF16_FRAC * scale, (err, scale)


def _tokens(seed, n=24, p=49, c=16):
    rng = np.random.RandomState(seed)
    return rng.randn(n, p, c).astype(np.float32)


# ---- the token mixers and the heads against flax ---------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["MLPMixer", "ResMLPLayer"])
def test_mixer_matches_flax(name, dtype):
    tdt, jdt = DTYPES[dtype]
    x = _tokens(50)
    jm = getattr(jmlp, name)(16, 49, dtype=jdt)
    variables = random_variables(jm, 51, jnp.asarray(x))
    want = jit_apply(jm, variables, jnp.asarray(x))
    tm = load_jax_variables(getattr(tmlp, name)(16, 49, dtype=tdt).eval(),
                            variables)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == x.shape
    # the stream stays f32 (the residual sums and f32 parameters promote)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, dtype)
    # the round trip through the flax layout is the identity
    again = variables_of(tm)
    flat = jax.tree_util.tree_leaves_with_path(variables["params"])
    assert len(flat) == len(jax.tree_util.tree_leaves(again["params"]))
    for path, v in flat:
        node = again["params"]
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, v)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("iou,residual", [(0, False), (1, False), (1, True),
                                          (0, True)])
def test_ffn_head_matches_flax(iou, residual, dtype):
    tdt, jdt = DTYPES[dtype]
    B, R, C = 2, 20, 8
    content = 49 * C if residual else 48
    rng = np.random.RandomState(52)
    feats = rng.randn(B, R, 49 * C).astype(np.float32)
    rois = random_rois(53, B, R)
    scores = rng.rand(B, R).astype(np.float32)
    kw = dict(model_cfg=HEAD_CFG, num_iou_fcs=iou, content_dim=content,
              feedforward_channels=64, num_cls_fcs=2, code_size=7)
    jm = jroi.RoIFFNHead(**kw, dtype=jdt)
    args = (jnp.asarray(feats), jnp.asarray(rois), jnp.asarray(scores))
    variables = random_variables(jm, 54, *args, train=False)
    want = jit_apply(jm, variables, *args)
    tm = troi.RoIFFNHead(**kw, in_features=49 * C, dtype=tdt).eval()
    assert tm.residual == residual
    load_jax_variables(tm, variables)
    with torch.inference_mode():
        got = tm(*map(torch.from_numpy, (feats, rois, scores)))
    assert len(got) == len(want) == 2 + iou
    for g, w, width in zip(got, want, (1, 7, 1)):
        assert tuple(g.shape) == (B * R, width) and g.dtype == tdt
        _close(g, w, dtype)


def test_ffn_head_initialisers():
    """flax's initialisers: xavier-uniform LN-MLP kernels, `fc_cls`'s bias
    at `init_bias`, `fc_reg` and `fc_iou` at zero, LayerNorms at (1, 0):
    an untrained head's IoU and regression outputs are 0."""
    from pillarnet_lts_torch.models.utils import init_weights

    tm = init_weights(troi.RoIFFNHead(HEAD_CFG, in_features=40,
                                      content_dim=32,
                                      feedforward_channels=64), 3).eval()
    assert torch.all(tm.fc_cls.bias == -2.19)
    for m in (tm.fc_reg, tm.fc_iou):
        assert not m.weight.any() and not m.bias.any()
    limit = (6.0 / (32 + 32)) ** 0.5
    w = tm.cls_fcs.fc0.weight.detach()
    assert float(w.abs().max()) <= limit and float(w.std()) > limit / 3
    assert torch.all(tm.ffn_norm.weight == 1) and not tm.ffn_norm.bias.any()
    with torch.inference_mode():
        _, reg, iou = tm(torch.randn(2, 5, 40))
    assert not reg.any() and not iou.any()


@pytest.mark.parametrize("mixer", ["MLPMixer", "ResMLP"])
def test_roi_mix_head_with_a_mixer_matches_flax(mixer):
    B, R, C = 2, 12, 8
    rng = np.random.RandomState(55)
    feats = np.abs(rng.randn(B, R, 49 * C)).astype(np.float32)
    rois = random_rois(56, B, R)
    scores = rng.rand(B, R).astype(np.float32)
    kw = dict(in_channels=C, model_cfg=HEAD_CFG, mixer_type=mixer,
              num_patches=49, code_size=7)
    jm = jroi.RoIMIXHead(**kw)
    args = (jnp.asarray(feats), jnp.asarray(rois), jnp.asarray(scores))
    variables = random_variables(jm, 57, *args, train=False)
    want = jit_apply(jm, variables, *args)
    tm = load_jax_variables(troi.RoIMIXHead(**kw).eval(), variables)
    with torch.inference_mode():
        got = tm(*map(torch.from_numpy, (feats, rois, scores)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# ---- the IoU loss ----------------------------------------------------------


def _iou_case(seed, fg_rows):
    rng = np.random.RandomState(seed)
    B, M = 2, 24
    gt = random_rois(seed, B, M, extent=20.0)
    preds = gt.copy()
    preds[..., :3] += rng.normal(0, 0.3, (B, M, 3))
    preds[..., 3:6] *= rng.uniform(0.7, 1.3, (B, M, 3))
    preds[..., 6] += rng.normal(0, 0.2, (B, M))
    preds[:, -3:] = 0.0  # padded rows: zero boxes
    gt = np.concatenate([gt, np.ones((B, M, 1), np.float32)], -1)
    mask = np.zeros((B, M), np.int32)
    mask[:, :fg_rows] = 1
    iou = rng.uniform(-1, 1, (B * M, 1)).astype(np.float32)
    return iou, mask, gt.astype(np.float32), preds.astype(np.float32)


@pytest.mark.parametrize("fg_rows", [15, 0])
def test_box_iou_layer_loss_matches_jax(fg_rows):
    iou, mask, gt, preds = _iou_case(58, fg_rows)

    def jloss(x):
        return jtpl.box_iou_layer_loss(x, mask, gt, preds, weight=0.7)

    want, wgrad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(iou))
    x = torch.from_numpy(iou).requires_grad_(True)
    got = ttpl.box_iou_layer_loss(x, torch.from_numpy(mask),
                                  torch.from_numpy(gt),
                                  torch.from_numpy(preds), weight=0.7)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(wgrad), rtol=1e-5,
                               atol=1e-8)
    if fg_rows:
        assert float(want) > 0
    else:
        assert float(want) == got.item() == 0.0


# ---- the training second stage with each variant ---------------------------

_SECOND = ("second_stage_0", "point_head_net", "roi_head_net")
_TRAIN_VARIANTS = ("RoIFFNHead", "MLPMixer", "ATT_MODEL")


def _variant_cfg(variant, dtype="f32"):
    """The demo config (dropout off) with `variant` (None: the config's
    own second stage) in `dtype`."""
    cfg = _demo_cfg(dp_ratio=0.0)
    if variant:
        cfg["model"] = rcnn_variant(cfg["model"], variant)
    if dtype == "bf16":
        cfg["model"]["dtype"] = "bfloat16"
    return cfg


def _f32(x):
    return x.astype(jnp.float32)


def _jax_second_stage(mdl, bev, feats, rois, scores, labels, gt, key):
    """The train branch of the JAX `PillarRCNN.__call__` after predict and
    the second-stage half of its `loss` (the IoU branch and ATT_MODEL
    included, `pillar_rcnn.py:122-170, :220-253`)."""
    gt = gt[..., jnp.array([0, 1, 2, 3, 4, 5, 6, 9])]
    raw = jptl_module().proposal_target_layer(key, rois, scores, labels, gt,
                                              mdl.target_config())
    targets = jtpl.canonicalize_roi_targets(raw, mdl.code_size())
    roi_feats, point_feats, point_coords = mdl._pool_second_stage(
        [bev], feats, targets["rois"], True)
    point_logits = mdl.point_head_net(point_feats, True)
    if mdl.model_cfg_att():
        point_feats = point_feats * jax.nn.sigmoid(point_logits)
        roi_feats = point_feats.reshape(roi_feats.shape)
    # the heads' outputs enter the losses in f32, as the port's do
    head = [_f32(h) for h in mdl.roi_head_net(roi_feats, targets["rois"],
                                              targets["roi_scores"], True)]
    rcnn_cls, rcnn_reg = head[:2]
    w = mdl.loss_config()["LOSS_WEIGHTS"]
    cls = jtpl.box_cls_layer_loss(rcnn_cls, targets["rcnn_cls_labels"],
                                  weight=w["rcnn_cls_weight"])
    reg = jtpl.box_reg_layer_loss(rcnn_reg, targets["reg_valid_mask"],
                                  targets["gt_of_rois"], w["code_weights"],
                                  weight=w["rcnn_reg_weight"])
    roi = cls + reg
    iou = jnp.float32(0)
    if len(head) == 3:
        _, bbp = jtpl.generate_predicted_boxes(targets["rois"], rcnn_cls,
                                               rcnn_reg)
        iou = jtpl.box_iou_layer_loss(
            head[2], targets["reg_valid_mask"], targets["gt_of_rois_src"],
            jax.lax.stop_gradient(bbp), weight=w.get("rcnn_iou_weight", 1.0))
        roi = roi + iou
    point = jph.point_cls_loss(
        _f32(point_logits),
        jph.assign_point_targets_2d(point_coords, targets["gt_of_rois_src"]),
        weight=mdl.point_head["model_cfg"]["LOSS_CONFIG"]["LOSS_WEIGHTS"][
            "point_cls_weight"])
    return roi + point, (targets, cls, reg, point, iou)


def jptl_module():
    import importlib

    return importlib.import_module(
        "pillarnet_lts_tpu.models.roi_heads.proposal_target_layer")


def _jax_losses_of(out, mdl_cfg):
    """The JAX package's RCNN, point and IoU losses on the port's training
    output `out`, its heads' outputs cast to f32."""
    t = {k: jnp.asarray(v.numpy()) for k, v in out["targets"].items()}
    o = {k: jnp.asarray(out[k].detach().float().numpy())
         for k in ("rcnn_cls", "rcnn_reg", "rcnn_iou", "point_logits",
                   "point_coords", "batch_box_preds_det") if k in out}
    w = mdl_cfg["roi_head"]["model_cfg"]["LOSS_CONFIG"]["LOSS_WEIGHTS"]
    cls = jtpl.box_cls_layer_loss(o["rcnn_cls"], t["rcnn_cls_labels"],
                                  weight=w["rcnn_cls_weight"])
    reg = jtpl.box_reg_layer_loss(o["rcnn_reg"], t["reg_valid_mask"],
                                  t["gt_of_rois"], w["code_weights"],
                                  weight=w["rcnn_reg_weight"])
    point = jph.point_cls_loss(
        o["point_logits"],
        jph.assign_point_targets_2d(o["point_coords"], t["gt_of_rois_src"]),
        weight=mdl_cfg["point_head"]["model_cfg"]["LOSS_CONFIG"][
            "LOSS_WEIGHTS"]["point_cls_weight"])
    iou = (jtpl.box_iou_layer_loss(
        o["rcnn_iou"], t["reg_valid_mask"], t["gt_of_rois_src"],
        o["batch_box_preds_det"], weight=w.get("rcnn_iou_weight", 1.0))
        if "rcnn_iou" in o else None)
    return cls, reg, point, iou


class _AbsAsThePort(types.ModuleType):
    """jax.numpy for `roi_head_template.py`, whose L1s (`jnp.abs`: the
    regression's, then the IoU branch's) take the port's signs: in bf16
    the refinement starts within rounding of its targets, and an L1's
    gradient flips with the sign of each such difference."""

    def __init__(self, signs):
        super().__init__("jnp")
        self.signs = signs
        self.taken = 0

    def __getattr__(self, name):
        return getattr(jnp, name)

    def abs(self, x):
        sign = self.signs[self.taken]
        assert sign.shape == x.shape, (sign.shape, x.shape)
        self.taken += 1
        return x * jnp.asarray(sign, x.dtype)


def _port_l1_signs(out):
    """The signs of the port's L1 differences in a training output: the
    refinement's from its targets, then the IoU branch's."""
    from pillarnet_lts_torch.ops.iou3d import boxes_aligned_iou3d

    t = out["targets"]
    reg = out["rcnn_reg"].detach().float()
    cs = reg.shape[-1]
    signs = [torch.sign(reg.reshape(-1, cs)
                        - t["gt_of_rois"][..., :cs].reshape(-1, cs))]
    if "rcnn_iou" in out:
        iou = 2.0 * boxes_aligned_iou3d(
            out["batch_box_preds_det"][..., :7].reshape(-1, 7),
            t["gt_of_rois_src"][..., :7].reshape(-1, 7)) - 1.0
        signs.append(torch.sign(
            out["rcnn_iou"].detach().float().reshape(-1) - iou))
    return [x.numpy() for x in signs]


def _bf16_round(x):
    """f32 values that bf16 holds: both packages see the same maps."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32)


@pytest.fixture(scope="module", params=[
    *_TRAIN_VARIANTS,
    *(pytest.param((v, "bf16"), id=f"bf16-{v}")
      for v in (None,) + _TRAIN_VARIANTS)])
def variant_second_stage(request):
    """One training second stage of the demo config with a variant
    (dropout off) in both packages from one JAX variables tree on the same
    fixed first-stage outputs and draws, as
    `test_torch_port_rcnn_train.py::second_stage_both`; in f32, or in bf16
    (the config's own head too) on maps rounded to bf16."""
    variant, dtype = (request.param if isinstance(request.param, tuple)
                      else (request.param, "f32"))
    cfg = _variant_cfg(variant, dtype)
    fx = _fixed_first_stage(cfg)
    if dtype == "bf16":
        fx = dict(fx, bev=_bf16_round(fx["bev"]),
                  conv3=_bf16_round(fx["conv3"]))
    B, R = fx["labels"].shape
    M = cfg["model"]["roi_head"]["model_cfg"]["TARGET_CONFIG"][
        "ROI_PER_IMAGE"]
    jm = build_jax_detector(copy.deepcopy(cfg["model"]),
                            train_cfg=cfg["train_cfg"],
                            test_cfg=cfg["test_cfg"])
    pts = np.zeros((1, 64, 5), np.float32)
    variables = random_variables(jm, 59, jnp.asarray(pts),
                                 jnp.ones((1, 64), bool), train=False)
    variables = jax.tree_util.tree_map(np.array, variables)
    key = jax.random.PRNGKey(60)

    port = load_jax_variables(build_model_from_cfg(cfg, device="cpu"),
                              variables).train()
    first = {"box3d_lidar": torch.from_numpy(fx["rois"]),
             "mask": torch.from_numpy(fx["labels"] > 0),
             "label_preds": torch.from_numpy(
                 np.maximum(fx["labels"] - 1, 0).astype(np.int32)),
             "scores": torch.from_numpy(fx["scores"])}
    bev = (torch.from_numpy(fx["bev"]).permute(0, 3, 1, 2),)
    feats = {"conv3": (torch.from_numpy(fx["conv3"]).permute(0, 3, 1, 2),
                       torch.from_numpy(fx["occ"]))}
    decisions = []
    with pytest.MonkeyPatch.context() as mp:
        for mod in (tbase, tbev):
            mp.setattr(mod, "F", _RecordingF(decisions, nchw=True))
        for mod in (tdense, troi):
            mp.setattr(mod, "F", _RecordingF(decisions))
        out = port.second_stage_train(first, bev, feats,
                                      torch.from_numpy(fx["gt"]),
                                      jax_draws(key, B, R, M))
        cls, reg, point = port.second_stage_losses(out)
        iou = port.iou_loss(out)
        roi = cls + reg if iou is None else (cls + reg) + iou
        (roi + point).backward()
    grads = {n: p.grad.numpy().copy() for n, p in port.named_parameters()
             if n.split(".")[0] in _SECOND}

    taken = []

    def relu_as_the_port(x):
        decision = decisions[len(taken)]
        assert decision.shape == x.shape, (decision.shape, x.shape)
        taken.append(decision)
        return jnp.where(decision, x, 0)

    def jloss(params):
        (total, aux), _ = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(fx["bev"]),
            {"conv3": (jnp.asarray(fx["conv3"]), jnp.asarray(fx["occ"]))},
            jnp.asarray(fx["rois"]), jnp.asarray(fx["scores"]),
            jnp.asarray(fx["labels"]), jnp.asarray(fx["gt"]), key,
            method=_jax_second_stage, mutable=["batch_stats"])
        return total, aux

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "relu", relu_as_the_port)
        if dtype == "bf16":
            abs_as_the_port = _AbsAsThePort(_port_l1_signs(out))
            mp.setattr(jtpl, "jnp", abs_as_the_port)
        (_, jaux), jgrads = jax.jit(
            jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    assert len(taken) == len(decisions) > 0
    if dtype == "bf16":
        assert abs_as_the_port.taken == len(abs_as_the_port.signs)
    want = load_jax_variables(
        build_model_from_cfg(cfg, device="cpu"),
        {"params": jax.tree_util.tree_map(np.asarray, jgrads),
         "batch_stats": variables["batch_stats"]})
    want = {n: p.detach().numpy() for n, p in want.named_parameters()}
    return dict(variant=variant, dtype=dtype, out=out,
                losses=(cls, reg, point, iou), grads=grads, jaux=jaux,
                want=want, on_port_out=_jax_losses_of(out, cfg["model"]))


def test_variant_second_stage_losses_match_jax(variant_second_stage):
    vs = variant_second_stage
    got, (targets, *want) = vs["losses"], vs["jaux"]
    rtol = 1e-4 if vs["dtype"] == "f32" else BF16_FRAC
    for k in ("rois", "roi_labels", "reg_valid_mask"):
        np.testing.assert_array_equal(vs["out"]["targets"][k].numpy(),
                                      np.asarray(targets[k]), err_msg=k)
    assert int(vs["out"]["targets"]["reg_valid_mask"].sum()) > 0
    for name, g, w in zip(("roi_cls", "roi_reg", "point", "roi_iou"), got,
                          want):
        if g is None:
            assert name == "roi_iou" and vs["variant"] != "RoIFFNHead"
            continue
        np.testing.assert_allclose(g.item(), float(w), rtol=rtol,
                                   err_msg=name)
        assert float(w) > 0, name
    assert (got[3] is not None) == (vs["variant"] == "RoIFFNHead")


def test_variant_second_stage_losses_take_f32_outputs(variant_second_stage):
    """The port's RCNN, point and IoU losses equal, within rtol 1e-5, the
    JAX package's loss functions on the port's own heads' outputs cast to
    f32 (in bf16 the cast the port makes and the JAX package does not)."""
    vs = variant_second_stage
    for name, g, w in zip(("roi_cls", "roi_reg", "point", "roi_iou"),
                          vs["losses"], vs["on_port_out"]):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == torch.float32, name
            np.testing.assert_allclose(g.item(), float(w), rtol=1e-5,
                                       err_msg=name)


def test_variant_second_stage_gradients_match_jax(variant_second_stage):
    """f32: ||g_port - g_jax|| <= 1e-3 ||g_jax|| per second-stage leaf. A
    bias whose every output a training-mode BN shifts away has a gradient
    of 0 in exact arithmetic, and is held to 1e-3 of the largest leaf norm
    instead, as `test_torch_port_rcnn_train.py` holds the conv biases: so
    are `MLPMixer`'s `token_fc2` and `channel_fc2` biases, which add one
    constant to every RoI at a grid token and channel, before the shared
    FC stack's BN.

    bf16: ||g_port - g_jax|| <= BF16_GRAD_RTOL ||g_jax|| for every weight
    leaf (kernels, BN and LayerNorm scales) and for each module's whole
    gradient (`second_stage_0`, `point_head_net`, `roi_head_net`, biases
    included). A bias's gradient is a sum over every row that cancels
    (to 0 in exact arithmetic behind a training BN; to a small remainder
    of opposite-signed loss gradients at a last layer), and what rounding
    leaves of it is held within its module's."""
    vs = variant_second_stage
    grads, want = vs["grads"], vs["want"]
    mixer = [k for k in grads if ".mixer." in k or "ffn" in k or "_fcs" in k]
    assert mixer or vs["variant"] in ("ATT_MODEL", None)
    norm = np.linalg.norm
    if vs["dtype"] == "bf16":
        for k in grads:
            assert norm(want[k]) > 0 or k.endswith(".bias"), k
            if k.endswith(".weight"):
                err = norm(grads[k] - want[k]) / norm(want[k])
                assert err <= BF16_GRAD_RTOL, (k, err)
        for module in _SECOND:
            keys = [k for k in grads if k.split(".")[0] == module]
            g = np.concatenate([grads[k].ravel() for k in keys])
            w = np.concatenate([want[k].ravel() for k in keys])
            err = norm(g - w) / norm(w)
            assert err <= BF16_GRAD_RTOL, (module, err)
        return
    scale = max(norm(want[k]) for k in grads)
    for k in grads:
        ref = norm(want[k])
        err = norm(grads[k] - want[k])
        if k.endswith(".bias") and ("conv" in k or ".mixer." in k) \
                and ref < 1e-3 * scale:
            assert err <= 1e-3 * scale, (k, err)
            continue
        assert ref > 0, k
        assert err <= 1e-3 * ref, (k, err / ref)


def test_ffn_head_loss_composition_matches_jax():
    """`PillarRCNN.loss` with the IoU branch against the JAX package's on
    the same training output and batch: `roi_iou_loss` listed per task
    after `roi_cls_loss`, added to task 0's loss."""
    from pillarnet_lts_tpu.parallel.collate import (
        collate_batch as jax_collate)
    from pillarnet_lts_torch.datasets import SynthDataset, collate_batch
    from pillarnet_lts_torch.runtime.train_step import batch_to_device

    cfg = _variant_cfg("RoIFFNHead")
    ds = SynthDataset(cfg, 2, 4096, seed=61)
    examples = [ds[0], ds[1]]
    port = build_model_from_cfg(cfg, device="cpu", seed=2).train()
    batch = batch_to_device(collate_batch(examples, 16384), "cpu")
    with torch.no_grad():
        out = port(batch["points"], batch["points_mask"],
                   gt_boxes_and_cls=batch["gt_boxes_and_cls"],
                   generator=torch.Generator().manual_seed(0))
        got = port.loss(batch, out, cfg["train_cfg"])
    assert "rcnn_iou" in out and "batch_box_preds_det" in out
    jb = jax_collate(examples, max_points=16384)
    jb.pop("metadata")
    jout = jax.tree_util.tree_map(lambda t: t.numpy(), out)
    jm = build_jax_detector(copy.deepcopy(cfg["model"]),
                            train_cfg=cfg["train_cfg"],
                            test_cfg=cfg["test_cfg"])
    want = jax.jit(lambda e, o: jm.loss(e, o, cfg["train_cfg"]))(jb, jout)
    assert set(got) == set(want)
    assert list(got)[-4:] == ["roi_reg_loss", "roi_cls_loss", "roi_iou_loss",
                              "point_loss"]
    for k in want:
        for t, (g, w) in enumerate(zip(got[k], want[k])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{k}[{t}]")


# ---- the whole demo eval with each variant ---------------------------------


@pytest.mark.parametrize("variant", _TRAIN_VARIANTS)
def test_demo_variant_eval_matches_jax(variant):
    from __graft_entry__ import _synth_points_realistic
    from test_torch_port_rcnn import spread_rcnn_heads

    cfg = load_config(DEMO)
    cfg["model"] = rcnn_variant(cfg["model"], variant)
    pts, msk = _synth_points_realistic(1, 4096, cfg["point_cloud_range"],
                                       seed=3, nsweeps=1)
    jm = build_jax_detector(copy.deepcopy(cfg["model"]),
                            test_cfg=cfg["test_cfg"])
    variables = random_variables(jm, 62, jnp.asarray(pts), jnp.asarray(msk),
                                 train=False)
    variables = jax.tree_util.tree_map(np.array, variables)
    port = build_model_from_cfg(cfg, device="cpu")
    tpts, tmsk = torch.from_numpy(pts), torch.from_numpy(msk)
    spread_rcnn_heads(port, variables, tpts, tmsk)
    jout = jax.jit(lambda v, p, m: jm.apply(v, p, m, train=False))(
        variables, jnp.asarray(pts), jnp.asarray(msk))
    jdet = {k: np.asarray(v) for k, v in jax.jit(jm.post_process)(jout)
            .items()}
    with torch.inference_mode():
        out = port(tpts, tmsk)
    det = {k: v.numpy() for k, v in port.post_process(out).items()}
    assert ("rcnn_iou" in out) == ("rcnn_iou" in jout) \
        == (variant == "RoIFFNHead")
    np.testing.assert_array_equal(out["roi_labels"].numpy(),
                                  np.asarray(jout["roi_labels"]))
    for k in ("rcnn_cls", "rcnn_reg") + (
            ("rcnn_iou",) if "rcnn_iou" in out else ()):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_array_equal(det["mask"], jdet["mask"])
    m = det["mask"]
    assert m.sum() > 5
    np.testing.assert_array_equal(det["label_preds"], jdet["label_preds"])
    np.testing.assert_allclose(det["box3d_lidar"][m], jdet["box3d_lidar"][m],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(det["scores"][m], jdet["scores"][m], rtol=0,
                               atol=1e-5)


# ---- a reference checkpoint onto a variant ---------------------------------


@pytest.mark.parametrize("variant", ["RoIFFNHead", "MLPMixer"])
def test_reference_checkpoint_onto_a_variant_leaves_what_jax_leaves(variant):
    """The reference `.pth` converters map no mixer and no FFN-head leaf
    (JAX `runtime/torch_convert.py::_roi_head_rules`): onto the demo with
    a variant, the port's `convert_state_dict` (non-strict) reports the
    same converted, missing, unmapped and unused leaves as the JAX
    package's and gives its tree leaf for leaf; `load_reference_checkpoint`
    keeps the model's own values at the unmapped leaves."""
    from pillarnet_lts_tpu.runtime import torch_convert as jconv
    from pillarnet_lts_torch.runtime import torch_convert as tconv

    cfg = load_config(DEMO)
    cfg["model"] = rcnn_variant(cfg["model"], variant)
    jm = build_jax_detector(copy.deepcopy(cfg["model"]),
                            train_cfg=cfg["train_cfg"],
                            test_cfg=cfg["test_cfg"])
    pts, msk = jnp.zeros((1, 64, 5), jnp.float32), jnp.ones((1, 64), bool)
    tmpl = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)},
        pts, msk, jnp.zeros((1, 8, 10), jnp.float32), train=True))
    exp = jconv.expected_source_keys(tmpl)
    rng = np.random.RandomState(63)
    sd = {k: rng.randn(*s).astype(np.float32) for _, (k, s) in exp.items()}
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = np.abs(sd[k]) + 0.5
    want, wrep = jconv.convert_state_dict(sd, tmpl, strict=False)
    model = build_model_from_cfg(cfg, device="cpu", seed=4)
    before = variables_of(model)
    got, rep = tconv.convert_state_dict(sd, before, strict=False)
    assert {k: sorted(v) for k, v in rep.items()} == {
        k: sorted(v) for k, v in wrep.items()}
    head = "mixer" if variant == "MLPMixer" else "ffn_norm"
    assert any(head in u for u in rep["unmapped"]), rep["unmapped"][:5]
    for path, w in jax.tree_util.tree_leaves_with_path(
            {k: want[k] for k in ("params", "batch_stats")}):
        keys = [p.key for p in path]
        if "/".join(keys) in rep["unmapped"]:
            continue
        node = got
        for k in keys:
            node = node[k]
        np.testing.assert_array_equal(node, np.asarray(w),
                                      err_msg="/".join(keys))
    report = tconv.load_reference_checkpoint(model, sd, strict=False)
    assert sorted(report["unmapped"]) == sorted(rep["unmapped"])
    after = variables_of(model)
    for name in rep["unmapped"]:
        a, b = after, before
        for k in name.split("/"):
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_ffn_head_dropout_draws_from_the_explicit_generator():
    """`RoIFFNHead`'s FFN dropout in training: the caller's generator, the
    same seed the same output, another seed another; without a generator
    it raises; at eval it does not drop."""
    tm = troi.RoIFFNHead(HEAD_CFG, in_features=40, content_dim=32,
                         feedforward_channels=64, dropout=0.3)
    from pillarnet_lts_torch.models.utils import init_weights

    init_weights(tm, 5).train()
    x = torch.rand(2, 6, 40, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = tm(x, generator=torch.Generator().manual_seed(1))
        b = tm(x, generator=torch.Generator().manual_seed(1))
        c = tm(x, generator=torch.Generator().manual_seed(2))
        with pytest.raises(ValueError, match="generator"):
            tm(x)
        e = [tm.eval()(x) for _ in range(2)]
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert all(torch.equal(p, q) for p, q in zip(*e))


def test_bf16_rcnn_losses_stay_finite_where_the_jax_package_is_not():
    """A bf16 model's RoI head logit of 9 against a soft label of 0.2:
    the JAX package's `box_cls_layer_loss` on the bf16 output is infinite
    (its sigmoid rounds to 1 in bf16, and the clip's 1 - 1e-7 is 1 there;
    its fault, which stays there). `PillarRCNN.second_stage_losses` takes
    the outputs in f32: finite, and within rtol 1e-5 of the JAX loss on
    the same logits in f32."""
    logits = np.array([[9.0], [-9.0], [0.5], [3.0]], np.float32)
    labels = np.array([0.2, 0.9, 0.5, -1.0], np.float32)
    bf = jnp.asarray(logits).astype(jnp.bfloat16)
    assert not np.isfinite(float(jax.jit(jtpl.box_cls_layer_loss)(
        bf, jnp.asarray(labels))))
    want = float(jax.jit(jtpl.box_cls_layer_loss)(
        jnp.asarray(np.asarray(bf, np.float32)), jnp.asarray(labels)))
    cfg = load_config(DEMO)
    cfg["model"]["dtype"] = "bfloat16"
    model = build_model_from_cfg(cfg, device="cpu")
    targets = {"rcnn_cls_labels": torch.from_numpy(labels),
               "reg_valid_mask": torch.zeros(4, dtype=torch.int32),
               "gt_of_rois": torch.zeros(4, 8)}
    out = {"targets": targets,
           "rcnn_cls": torch.from_numpy(logits).to(torch.bfloat16),
           "rcnn_reg": torch.zeros(4, 7, dtype=torch.bfloat16)}
    cls, reg, point = model.second_stage_losses(out)
    assert point is None and float(reg) == 0.0
    assert np.isfinite(cls.item())
    np.testing.assert_allclose(cls.item(), want, rtol=1e-5)
