"""PyTorch port, two-stage Pillar R-CNN training: the RoI sampler, the
canonical RoI targets, the RCNN and point losses and the training second
stage against the JAX package on the same numpy inputs, and the port's
training runs of `pillarrcnn18_demo` (the loss falls, a resumed step
equals the uninterrupted one, `freeze`).

Tolerances:
- `boxes_iou3d`: within 1e-4 of the JAX package's, the tolerance of the
  repo's other overlap tests (`tests/test_pallas_iou.py`,
  `test_torch_port_iou_nms.py`): on the CPU the JAX package clips the
  polygons and fans them into triangles, while the port (and K2, and the
  JAX package's Pallas kernel) integrates the clipped edges; the two
  differ by up to ~2e-5 at IoUs near 1;
- `proposal_target_layer`: bit-equal to the JAX package's, every field,
  when given the draws `jax.random` makes from the JAX package's key
  splits and the JAX package's IoU matrix; with its own IoU, equal
  indices and labels and IoUs within 1e-4 where no IoU lies within 1e-4
  of a threshold;
- `canonicalize_roi_targets`: within 1e-6 (XLA's and ATen's sin/cos and
  the reciprocal of 2 pi differ by an ulp), heading-flip edges included;
- the RCNN and point losses: values within rtol 1e-5, gradients within
  rtol 1e-5 / atol 1e-8 of `jax.grad`; `assign_point_targets_2d` equal
  where no point lies within 1e-5 m of a footprint edge;
- the training second stage (`PillarRCNN.second_stage_train` + the three
  losses) on fixed first-stage outputs against jitted JAX: the sampled
  RoIs, labels, scores and masks equal, the canonical targets within
  1e-6 + 1e-6 |x|, the IoUs and soft labels within 1e-4, the losses
  within rtol 1e-4, every second-stage parameter's gradient within 1e-3
  of JAX's in norm with the JAX package's ReLUs taking the port's
  decisions (both as `test_torch_port_train_step.py`), the running statistics
  within rtol = atol = 1e-4. Dropout off (DP_RATIO = 0 in both packages'
  copy of the demo config).
"""

import copy
import importlib
import os

import numpy as np
import pytest
import torch

import flax.linen
import jax
import jax.numpy as jnp

from pillarnet_lts_tpu.models import build_detector as build_jax_detector
from pillarnet_lts_tpu.models.point_heads import point_head as jph
from pillarnet_lts_tpu.models.roi_heads import roi_head_template as jtpl
from pillarnet_lts_tpu.ops.iou3d import boxes_iou3d as jboxes_iou3d
from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                      optimizer_from_cfg, train_detector)
from pillarnet_lts_torch.datasets import SynthDataset, collate_batch
from pillarnet_lts_torch.models.backbones import base as tbase
from pillarnet_lts_torch.models.point_heads import point_head as tph
from pillarnet_lts_torch.models.roi_heads import proposal_target_layer as tptl
from pillarnet_lts_torch.models.roi_heads import roi_head_template as ttpl
from pillarnet_lts_torch.models.roi_heads.roi_heads import _FCStack, dropout
from pillarnet_lts_torch.models.utils import init_weights
from pillarnet_lts_torch.models.second_stage import bev_feature as tbev
from pillarnet_lts_torch.models.utils import dense as tdense
from pillarnet_lts_torch.ops.iou3d import boxes_iou3d
from pillarnet_lts_torch.runtime.convert import load_jax_variables
from pillarnet_lts_torch.runtime.train_step import (batch_to_device,
                                                    step_generator,
                                                    step_losses, train_step)
from chip_smoke import gt_rows, jitter_rois
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_torch_port_modules import random_variables, sparse_grid
from test_torch_port_train_step import _RecordingF

# the module (the package exports a function of the same name)
jptl = importlib.import_module(
    "pillarnet_lts_tpu.models.roi_heads.proposal_target_layer")
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DEMO = os.path.join(ROOT, "configs", "demo", "pillarrcnn18_demo.py")
WAYMO = os.path.join(ROOT, "configs", "pillarrcnn", "pillarrcnn18_waymo.py")
TARGET_CFG = load_config(WAYMO)["model"]["roi_head"]["model_cfg"][
    "TARGET_CONFIG"]
THRESHOLDS = sorted({TARGET_CFG[k] for k in (
    "REG_FG_THRESH", "CLS_FG_THRESH", "CLS_BG_THRESH", "CLS_BG_THRESH_LO")})


# ---- inputs -----------------------------------------------------------------


# (per sample: plan of RoI kinds, real GT rows), by_class, label type; R =
# 64 RoIs, G = 12 GT rows, M = 16 slots (fg quota 8)
_R, _G, _M = 64, 12, 16
_CASES = {
    # fg without replacement (above and below the quota), hard and easy
    "mixed": ([([("fg", 10), ("hard", 20), ("easy", 24), ("zero", 10)], 6),
               ([("fg", 3), ("hard", 5), ("easy", 50), ("zero", 6)], 5),
               ([("fg", 30), ("hard", 10), ("easy", 14), ("zero", 10)], 12)],
              True, "roi_iou"),
    # no background: every slot fg, drawn with replacement
    "no_background": ([([("fg", 64)], 7),
                       ([("fg", 5), ("hard", 30), ("easy", 29)], 4)],
                      True, "roi_iou"),
    "no_foreground": ([([("hard", 30), ("easy", 34)], 6),
                       ([("easy", 64)], 6)], True, "roi_iou"),
    # hard background only (with and without fg), easy only
    "hard_only": ([([("fg", 5), ("hard", 59)], 6), ([("hard", 64)], 3),
                   ([("fg", 4), ("easy", 60)], 6)], True, "roi_iou"),
    "by_class_off": ([([("fg", 10), ("hard", 20), ("easy", 24), ("zero", 10)],
                       6), ([("fg", 20), ("hard", 44)], 9)],
                     False, "roi_iou"),
    "cls_labels": ([([("fg", 12), ("hard", 24), ("easy", 20), ("zero", 8)],
                     6), ([("fg", 2), ("hard", 40), ("zero", 22)], 4)],
                   True, "cls"),
    # all-zero RoIs, and a sample whose GT is all padding
    "all_zero_rois": ([([("zero", 64)], 6), ([("zero", 64)], 0),
                       ([("fg", 8), ("easy", 40), ("zero", 16)], 0)],
                      True, "roi_iou"),
}


def sampler_case(name, seed=0):
    plans, by_class, label_type = _CASES[name]
    rng = np.random.RandomState(seed)
    B = len(plans)
    gt = gt_rows(rng, B, _G, [n for _, n in plans])
    rois, labels = zip(*(jitter_rois(rng, gt[b], plan)
                         for b, (plan, _) in enumerate(plans)))
    rois, labels = np.stack(rois), np.stack(labels)
    if not by_class:  # labels unrelated to the GT's
        labels = np.where(labels > 0, rng.randint(1, 4, labels.shape), 0)
    scores = (rng.rand(B, _R) * (labels > 0)).astype(np.float32)
    cfg = dict(TARGET_CFG, ROI_PER_IMAGE=_M, SAMPLE_ROI_BY_EACH_CLASS=by_class,
               CLS_SCORE_TYPE=label_type)
    return rois, scores, labels.astype(np.int32), gt, cfg


def jax_draws(key, B, R, M):
    """The JAX package's sampler draws: per sample (split(key, B)), the
    (R,) uniforms of split(key_b, 6)[:3] and the (M,) ints in
    [0, int32 max) of [3:]."""
    u, r = [], []
    for kb in jax.random.split(key, B):
        ks = jax.random.split(kb, 6)
        u.append([jax.random.uniform(k, (R,)) for k in ks[:3]])
        r.append([jax.random.randint(k, (M,), 0, jnp.iinfo(jnp.int32).max)
                  for k in ks[3:]])
    return tptl.SamplerDraws(torch.from_numpy(np.asarray(u)),
                             torch.from_numpy(np.asarray(r)).to(torch.int64))


def jax_iou(rois, gt):
    return np.array(jax.jit(jax.vmap(jboxes_iou3d))(rois[..., :7],
                                                     gt[..., :7]))


def _overlap_counts(rois, labels, gt, cfg):
    """Per sample (fg, hard, easy) counts from the JAX IoU."""
    iou = jax_iou(rois, gt)
    valid = gt[..., 7] > 0
    match = valid[:, None, :]
    if cfg["SAMPLE_ROI_BY_EACH_CLASS"]:
        match = match & (labels[:, :, None] == gt[:, None, :, 7])
    mo = np.maximum(np.where(match, iou, -1).max(-1), 0)
    fg = mo >= min(cfg["REG_FG_THRESH"], cfg["CLS_FG_THRESH"])
    easy = mo < cfg["CLS_BG_THRESH_LO"]
    hard = (mo < cfg["REG_FG_THRESH"]) & ~easy
    return [tuple(int(x) for x in c) for c in
            zip(fg.sum(-1), hard.sum(-1), easy.sum(-1))], mo


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


# ---- boxes_iou3d ------------------------------------------------------------


def test_boxes_iou3d_matches_jax():
    rois, _, _, gt, _ = sampler_case("mixed", seed=1)
    got = boxes_iou3d(torch.from_numpy(rois), torch.from_numpy(gt[..., :7]))
    want = jax_iou(rois, gt)
    assert tuple(got.shape) == want.shape == (3, _R, _G)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert (want > 0.5).sum() > 20 and np.isfinite(got.numpy()).all()
    # padded rows on either side: IoU exactly 0, no NaN
    zero_roi = (rois == 0).all(-1)
    zero_gt = (gt == 0).all(-1)
    assert zero_roi.any() and zero_gt.any()
    g = got.numpy()
    assert (g[zero_roi] == 0).all() and (g.transpose(0, 2, 1)[zero_gt] == 0
                                         ).all()


# ---- proposal_target_layer --------------------------------------------------


def _branch_holds(name, counts, M):
    fg_quota = int(round(TARGET_CFG["FG_RATIO"] * M))
    fg = [c[0] for c in counts]
    bg = [c[1] + c[2] for c in counts]
    if name == "mixed":
        return (any(0 < f < fg_quota and b for f, b in zip(fg, bg))
                and any(f > fg_quota and b for f, b in zip(fg, bg))
                and all(c[1] and c[2] for c in counts))
    if name == "no_background":
        return counts[0][0] > 0 and bg[0] == 0
    if name == "no_foreground":
        return not any(fg) and counts[0][1] and not counts[1][1]
    if name == "hard_only":
        return (counts[0][0] and counts[0][1] and not counts[0][2]
                and not counts[1][0] and counts[1][1] and not counts[1][2]
                and counts[2][0] and not counts[2][1] and counts[2][2])
    if name == "all_zero_rois":
        return counts[0] == (0, 0, _R) and counts[1] == (0, 0, _R)
    return any(fg) and all(bg)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_proposal_target_layer_bit_equal_to_jax(name):
    """Every sampling branch, with the JAX package's draws and IoU matrix
    injected: every field bit-equal to the JAX package's."""
    rois, scores, labels, gt, cfg = sampler_case(name)
    B = rois.shape[0]
    counts, _ = _overlap_counts(rois, labels, gt, cfg)
    assert _branch_holds(name, counts, _M), counts

    key = jax.random.PRNGKey(7)
    want = jptl.proposal_target_layer(key, rois, scores, labels, gt, cfg)
    draws = jax_draws(key, B, _R, _M)
    iou = torch.from_numpy(jax_iou(rois, gt))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tptl, "boxes_iou3d", lambda a, b: iou)
        got = tptl.proposal_target_layer(
            torch.from_numpy(rois), torch.from_numpy(scores),
            torch.from_numpy(labels), torch.from_numpy(gt), cfg, draws)
    for field in tptl.RoiTargets._fields:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.shape == w.shape, field
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=field)
    if name == "cls_labels":  # ignored RoIs
        assert (got.rcnn_cls_labels == -1).any()
    if name == "mixed":  # the soft ramp between the thresholds
        assert ((got.rcnn_cls_labels > 0) & (got.rcnn_cls_labels < 1)).any()


def test_proposal_target_layer_with_its_own_iou_matches_jax():
    """The port's own IoU: sampled RoIs, labels and masks equal, IoUs within
    1e-4, on a case where no IoU lies within 1e-4 of a threshold."""
    rois, scores, labels, gt, cfg = sampler_case("mixed", seed=3)
    _, mo = _overlap_counts(rois, labels, gt, cfg)
    assert min(np.abs(mo - t).min() for t in THRESHOLDS) > 1e-4
    key = jax.random.PRNGKey(11)
    want = jptl.proposal_target_layer(key, rois, scores, labels, gt, cfg)
    got = tptl.proposal_target_layer(
        torch.from_numpy(rois), torch.from_numpy(scores),
        torch.from_numpy(labels), torch.from_numpy(gt), cfg,
        jax_draws(key, rois.shape[0], _R, _M))
    for field in ("rois", "gt_of_rois", "roi_scores", "roi_labels",
                  "reg_valid_mask"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.gt_iou_of_rois.numpy(),
                               np.asarray(want.gt_iou_of_rois), rtol=0,
                               atol=1e-4)
    # the ramp divides the IoU's difference by CLS_FG - CLS_BG
    np.testing.assert_allclose(
        got.rcnn_cls_labels.numpy(), np.asarray(want.rcnn_cls_labels),
        rtol=0, atol=1e-4 / (cfg["CLS_FG_THRESH"] - cfg["CLS_BG_THRESH"]))


def test_proposals_near_gt_feed_the_sampler_fg_rois():
    """`chip_smoke.py::proposals_near_gt` (phases 15c, 15f): RoIs far from
    every GT give the sampler no fg; with the first 20 slots of each sample
    jittered about its GT rows the fg quota fills and the regression mask
    is set, the other slots and a sample without GT stay as they were, and
    a second entry draws the same boxes."""
    from chip_smoke import proposals_near_gt
    from pillarnet_lts_torch.models.detectors import pillar_rcnn

    rng = np.random.RandomState(5)
    gt = gt_rows(rng, 3, _G, [6, 12, 0])
    rois, labels = zip(*(jitter_rois(rng, gt[b], [("easy", _R)])
                         for b in range(3)))
    args = [torch.from_numpy(np.stack(rois)),
            torch.from_numpy(rng.rand(3, _R).astype(np.float32)),
            torch.from_numpy(np.stack(labels)), torch.from_numpy(gt),
            dict(TARGET_CFG, ROI_PER_IMAGE=_M),
            tptl.sampler_draws(torch.Generator().manual_seed(2), 3, _R, _M,
                               "cpu")]
    assert int(pillar_rcnn.proposal_target_layer(
        *args).reg_valid_mask.sum()) == 0
    seen = []

    def recording(*a):
        seen.append(a[0])
        return tptl.proposal_target_layer(*a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pillar_rcnn, "proposal_target_layer", recording)
        got = []
        for _ in range(2):
            with proposals_near_gt(torch, 20, 17):
                got.append(pillar_rcnn.proposal_target_layer(*args))
    fg = got[0].reg_valid_mask.sum(-1)
    assert int(fg[0]) > 0 and int(fg[1]) > 0 and int(fg[2]) == 0
    assert torch.equal(seen[0], seen[1])
    assert torch.equal(seen[0][:, 20:], args[0][:, 20:])
    assert torch.equal(seen[0][2], args[0][2])
    assert not torch.equal(seen[0][:2, :20], args[0][:2, :20])


def test_sampler_draws_shapes_ranges_and_generator():
    g = torch.Generator().manual_seed(3)
    d = tptl.sampler_draws(g, 2, 500, 128, "cpu")
    assert tuple(d.uniforms.shape) == (2, 3, 500)
    assert tuple(d.ints.shape) == (2, 3, 128)
    assert d.uniforms.dtype == torch.float32 and d.ints.dtype == torch.int64
    assert 0 <= float(d.uniforms.min()) and float(d.uniforms.max()) < 1
    assert 0 <= int(d.ints.min()) and int(d.ints.max()) < 2**31 - 1
    again = tptl.sampler_draws(torch.Generator().manual_seed(3), 2, 500, 128,
                               "cpu")
    assert torch.equal(d.uniforms, again.uniforms)
    assert torch.equal(d.ints, again.ints)


# ---- canonical targets, losses, point targets -------------------------------


def _raw_targets(seed, B=2, M=40, width=7):
    rng = np.random.RandomState(seed)
    rois = np.zeros((B, M, width), np.float32)
    rois[..., :2] = rng.uniform(-60, 60, (B, M, 2))
    rois[..., 2] = rng.uniform(-1, 1, (B, M))
    rois[..., 3:6] = rng.uniform(0.5, 5, (B, M, 3))
    rois[..., 6] = rng.uniform(-7, 7, (B, M))
    if width == 9:
        rois[..., 7:] = rng.uniform(-5, 5, (B, M, 2))
    gt = np.zeros((B, M, width + 1), np.float32)
    gt[..., :width] = rois + rng.normal(0, 0.3, rois.shape)
    # heading differences on and next to the flip edges (+-pi/2, +-3pi/2,
    # +-pi) and far around the circle
    edges = np.array([np.pi / 2, -np.pi / 2, 1.5 * np.pi, -1.5 * np.pi,
                      np.pi, -np.pi, 0.0, 2 * np.pi], np.float32)
    d = np.concatenate([edges, edges + 1e-3, edges - 1e-3])
    n = min(d.size, M)
    gt[0, :n, 6] = rois[0, :n, 6] + d[:n]
    gt[1, :, 6] = rois[1, :, 6] + rng.uniform(-9, 9, M)
    gt[..., -1] = rng.randint(1, 4, (B, M))
    t = jptl.RoiTargets(rois=rois, gt_of_rois=gt,
                        gt_iou_of_rois=rng.rand(B, M).astype(np.float32),
                        roi_scores=rng.rand(B, M).astype(np.float32),
                        roi_labels=rng.randint(0, 4, (B, M)).astype(np.int32),
                        reg_valid_mask=rng.randint(0, 2, (B, M)).astype(
                            np.int32),
                        rcnn_cls_labels=rng.rand(B, M).astype(np.float32))
    return t


@pytest.mark.parametrize("width", [7, 9])
def test_canonicalize_roi_targets_matches_jax(width):
    raw = _raw_targets(5, width=width)
    want = jax.jit(jtpl.canonicalize_roi_targets, static_argnums=1)(
        raw, width)
    got = ttpl.canonicalize_roi_targets(
        tptl.RoiTargets(*(torch.from_numpy(np.asarray(v)) for v in raw)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    heading = got["gt_of_rois"][..., 6]
    assert float(heading.abs().max()) <= np.float32(np.pi / 2)


def _loss_inputs(seed, N=60, G=49):
    rng = np.random.RandomState(seed)
    cls = rng.randn(N, 1).astype(np.float32) * 2
    labels = rng.rand(N).astype(np.float32)
    labels[:10] = -1
    labels[10:20] = 1
    labels[20:25] = 0
    reg = rng.randn(N, 7).astype(np.float32)
    gt = rng.randn(1, N, 8).astype(np.float32)
    valid = (rng.rand(1, N) > 0.4).astype(np.int32)
    logits = rng.randn(1, N, G, 1).astype(np.float32) * 3
    point_labels = (rng.rand(1, N, G) > 0.8).astype(np.float32)
    return dict(cls=cls, labels=labels, reg=reg, gt=gt, valid=valid,
                logits=logits, point_labels=point_labels)


_CW = [1.0, 1.0, 1.0, 0.5, 0.5, 2.0, 1.0]
_LOSSES = {
    "cls": (lambda P, d: P.box_cls_layer_loss(d["cls"], d["labels"], 1.5),
            "cls"),
    "reg": (lambda P, d: P.box_reg_layer_loss(d["reg"], d["valid"], d["gt"],
                                              _CW, 0.7), "reg"),
    "point": (lambda P, d: P.point_cls_loss(d["logits"], d["point_labels"],
                                            1.2), "logits"),
}


@pytest.mark.parametrize("name", sorted(_LOSSES))
@pytest.mark.parametrize("seed", [0, 1])
def test_rcnn_and_point_losses_and_gradients_match_jax(name, seed):
    fn, wrt = _LOSSES[name]
    d = _loss_inputs(seed)
    jmod = jph if name == "point" else jtpl
    tmod = tph if name == "point" else ttpl

    def jloss(x):
        return fn(jmod, dict(d, **{wrt: x}))

    want, jgrad = jax.jit(jax.value_and_grad(jloss))(d[wrt])
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    x = t[wrt].clone().requires_grad_(True)
    got = fn(tmod, dict(t, **{wrt: x}))
    (grad,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-8)
    assert float(want) > 0 and np.abs(np.asarray(jgrad)).max() > 0


def test_losses_without_valid_rows():
    """No foreground RoI and every label ignored: the averages' max(n, 1)
    keeps both losses 0 and finite, with zero gradients."""
    d = _loss_inputs(2)
    reg = torch.from_numpy(d["reg"]).requires_grad_(True)
    cls = torch.from_numpy(d["cls"]).requires_grad_(True)
    loss = (ttpl.box_reg_layer_loss(reg, torch.zeros(1, 60, dtype=torch.int32),
                                    torch.from_numpy(d["gt"]), _CW)
            + ttpl.box_cls_layer_loss(cls, -torch.ones(60)))
    loss.backward()
    assert loss.item() == 0.0
    assert not reg.grad.any() and not cls.grad.any()


def test_assign_point_targets_2d_equals_jax():
    rng = np.random.RandomState(9)
    B, R, G = 2, 30, 49
    gt = np.zeros((B, R, 8), np.float32)
    gt[..., :2] = rng.uniform(-20, 20, (B, R, 2))
    gt[..., 2] = rng.uniform(-1, 1, (B, R))
    gt[..., 3:6] = rng.uniform(1, 5, (B, R, 3))
    gt[..., 6] = rng.uniform(-4, 4, (B, R))
    gt[:, -5:] = 0  # padding rows
    pts = gt[..., None, :2] + rng.uniform(-3, 3, (B, R, G, 2)).astype(
        np.float32)
    want = np.asarray(jax.jit(jph.assign_point_targets_2d)(pts, gt))
    got = tph.assign_point_targets_2d(torch.from_numpy(pts),
                                      torch.from_numpy(gt)).numpy()
    # margin: no point within 1e-5 m of its footprint's edge
    rel = pts - gt[..., None, :2]
    c, s = np.cos(gt[..., 6])[..., None], np.sin(gt[..., 6])[..., None]
    lx = rel[..., 0] * c + rel[..., 1] * s
    ly = -rel[..., 0] * s + rel[..., 1] * c
    margin = np.minimum(np.abs(np.abs(lx) - gt[..., 3:4] / 2),
                        np.abs(np.abs(ly) - gt[..., 4:5] / 2))
    assert margin.min() > 1e-5
    np.testing.assert_array_equal(got, want)
    assert 0.05 < want.mean() < 0.95 and not want[:, -5:].any()


# ---- dropout on an explicit generator ---------------------------------------


def test_dropout_draws_from_the_explicit_generator():
    """Training-mode dropout keeps U < 1 - rate of the caller's generator
    and scales by 1 / (1 - rate), as flax's nn.Dropout with its rng: the
    global generator's state does not matter, the same seed gives the same
    mask, and training without a generator raises."""
    x = torch.rand(64, 32, generator=torch.Generator().manual_seed(0)) + 0.5
    torch.manual_seed(1)
    a = dropout(x, 0.3, torch.Generator().manual_seed(5))
    torch.manual_seed(2)
    b = dropout(x, 0.3, torch.Generator().manual_seed(5))
    u = torch.rand(x.shape, generator=torch.Generator().manual_seed(5))
    want = torch.where(u < 0.7, x / 0.7, torch.zeros_like(x))
    assert torch.equal(a, b) and torch.equal(a, want)
    assert 0.2 < float((a == 0).float().mean()) < 0.4

    # flax's: the same form, zero or x / 0.7 (x > 0 here, so the zeros are
    # its mask)
    flax_out = np.asarray(flax.linen.Dropout(0.3, deterministic=False).apply(
        {}, jnp.asarray(x.numpy()), rngs={"dropout": jax.random.PRNGKey(4)}))
    keep = flax_out != 0
    np.testing.assert_array_equal(flax_out,
                                  np.where(keep, x.numpy() / 0.7, 0))
    assert 0.2 < 1 - keep.mean() < 0.4

    stack = init_weights(_FCStack(32, [16, 16], 4, dropout=0.3), 0).train()
    with torch.no_grad():
        out = [stack(x, torch.Generator().manual_seed(9)) for _ in range(2)]
        other = stack(x, torch.Generator().manual_seed(10))
    assert torch.equal(out[0], out[1]) and not torch.equal(out[0], other)
    with pytest.raises(ValueError, match="generator"):
        stack(x)
    with torch.no_grad():
        ev = [stack.eval()(x) for _ in range(2)]
    assert torch.equal(ev[0], ev[1])


# ---- the training second stage against jitted JAX ---------------------------


def _demo_cfg(dp_ratio=None, freeze=False):
    cfg = load_config(DEMO)
    m = copy.deepcopy(cfg["model"])
    if dp_ratio is not None:
        m["roi_head"]["model_cfg"]["DP_RATIO"] = dp_ratio
    m["freeze"] = freeze
    cfg["model"] = m
    return cfg


def _fixed_first_stage(cfg, B=2):
    """Fixed first-stage outputs for the demo config: the neck's last map
    (B, 128, 16, 16), the backbone's conv3 map (B, 64, 16, 16) with its
    occupancy, and
    padded proposals jittered from the GT of two synthetic scenes."""
    ds = SynthDataset(cfg, B, 4096, seed=40)
    gt = np.stack([ds[i]["gt_boxes_and_cls"] for i in range(B)])
    rng = np.random.RandomState(41)
    bev = rng.randn(B, 16, 16, 128).astype(np.float32)
    conv3, occ = sparse_grid(42, B, 16, 16, 64, occupancy=0.5)
    R = sum(cfg["test_cfg"]["nms"]["nms_post_max_size"])
    gt8 = np.concatenate([gt[..., :7], gt[..., 9:]], -1)
    rois, labels = zip(*(jitter_rois(rng, gt8[b], [
        ("fg", 40), ("hard", 40), ("easy", 28), ("zero", R - 108)])
        for b in range(B)))
    rois, labels = np.stack(rois), np.stack(labels)
    scores = (rng.rand(B, R) * (labels > 0)).astype(np.float32)
    return dict(bev=bev, conv3=conv3, occ=occ, gt=gt, rois=rois,
                labels=labels, scores=scores)


def _jax_second_stage(mdl, bev, feats, rois, scores, labels, gt, key):
    """The train branch of the JAX `PillarRCNN.__call__` after predict
    (`pillar_rcnn.py:122-158`) and the second-stage half of its `loss`
    (`:221-249`)."""
    gt = gt[..., jnp.array([0, 1, 2, 3, 4, 5, 6, 9])]
    raw = jptl.proposal_target_layer(key, rois, scores, labels, gt,
                                     mdl.target_config())
    targets = jtpl.canonicalize_roi_targets(raw, mdl.code_size())
    roi_feats, point_feats, point_coords = mdl._pool_second_stage(
        [bev], feats, targets["rois"], True)
    point_logits = mdl.point_head_net(point_feats, True)
    rcnn_cls, rcnn_reg = mdl.roi_head_net(roi_feats, targets["rois"],
                                          targets["roi_scores"], True)
    w = mdl.loss_config()["LOSS_WEIGHTS"]
    cls = jtpl.box_cls_layer_loss(rcnn_cls, targets["rcnn_cls_labels"],
                                  weight=w["rcnn_cls_weight"])
    reg = jtpl.box_reg_layer_loss(rcnn_reg, targets["reg_valid_mask"],
                                  targets["gt_of_rois"], w["code_weights"],
                                  weight=w["rcnn_reg_weight"])
    point = jph.point_cls_loss(
        point_logits,
        jph.assign_point_targets_2d(point_coords, targets["gt_of_rois_src"]),
        weight=mdl.point_head["model_cfg"]["LOSS_CONFIG"]["LOSS_WEIGHTS"][
            "point_cls_weight"])
    return (cls + reg) + point, (targets, cls, reg, point)


_SECOND = ("second_stage_0", "point_head_net", "roi_head_net")


class _RecordingF(_RecordingF):
    """`_RecordingF` whose decisions on NCHW maps are stored NHWC, the JAX
    package's layout (`nchw=True`)."""

    def __init__(self, decisions, nchw=False):
        super().__init__(decisions)
        self.nchw = nchw

    def relu(self, x):
        out = super().relu(x)
        if self.nchw:
            self.decisions[-1] = self.decisions[-1].transpose(0, 2, 3, 1)
        return out


@pytest.fixture(scope="module")
def second_stage_both():
    """One training second stage of the demo config (dropout off) in both
    packages from one JAX variables tree on the same fixed first-stage
    outputs and draws: the port's losses, gradients and state, and the JAX
    package's, with its ReLUs taking the port's decisions."""
    cfg = _demo_cfg(dp_ratio=0.0)
    fx = _fixed_first_stage(cfg)
    B, R = fx["labels"].shape
    M = cfg["model"]["roi_head"]["model_cfg"]["TARGET_CONFIG"][
        "ROI_PER_IMAGE"]
    jm = build_jax_detector(copy.deepcopy(cfg["model"]),
                            train_cfg=cfg["train_cfg"],
                            test_cfg=cfg["test_cfg"])
    pts = np.zeros((1, 64, 5), np.float32)
    variables = random_variables(jm, 43, jnp.asarray(pts),
                                 jnp.ones((1, 64), bool), train=False)
    variables = jax.tree_util.tree_map(np.array, variables)
    key = jax.random.PRNGKey(44)

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
        # the BEV maps' ReLUs record NCHW decisions, the heads' row ones
        for mod in (tbase, tbev):
            mp.setattr(mod, "F", _RecordingF(decisions, nchw=True))
        mp.setattr(tdense, "F", _RecordingF(decisions))
        out = port.second_stage_train(first, bev, feats,
                                      torch.from_numpy(fx["gt"]),
                                      jax_draws(key, B, R, M))
        losses = port.second_stage_losses(out)
        ((losses[0] + losses[1]) + losses[2]).backward()
    grads = {n: p.grad.numpy().copy() for n, p in port.named_parameters()
             if n.split(".")[0] in _SECOND}
    state = {k: v.numpy().copy() for k, v in port.state_dict().items()
             if k.split(".")[0] in _SECOND}

    taken = []

    def relu_as_the_port(x):
        decision = decisions[len(taken)]
        assert decision.shape == x.shape, (decision.shape, x.shape)
        taken.append(decision)
        return jnp.where(decision, x, 0)

    def jloss(params):
        (total, aux), mutated = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(fx["bev"]),
            {"conv3": (jnp.asarray(fx["conv3"]), jnp.asarray(fx["occ"]))},
            jnp.asarray(fx["rois"]), jnp.asarray(fx["scores"]),
            jnp.asarray(fx["labels"]), jnp.asarray(fx["gt"]), key,
            method=_jax_second_stage, mutable=["batch_stats"])
        return total, (aux, mutated["batch_stats"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "relu", relu_as_the_port)
        (_, (jaux, jstats)), jgrads = jax.jit(
            jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    assert len(taken) == len(decisions) > 0
    want = load_jax_variables(
        build_model_from_cfg(cfg, device="cpu"),
        {"params": jax.tree_util.tree_map(np.asarray, jgrads),
         "batch_stats": jax.tree_util.tree_map(np.asarray, jstats)})
    want = {k: v.numpy() for k, v in want.state_dict().items()}
    return dict(out=out, losses=losses, grads=grads, state=state,
                jaux=jaux, want=want)


def test_second_stage_targets_match_jax(second_stage_both):
    """Before the losses: the sampled RoIs, labels, scores and targets of
    the port equal the JAX package's."""
    got = second_stage_both["out"]["targets"]
    want = second_stage_both["jaux"][0]
    for k in ("rois", "roi_scores", "roi_labels", "reg_valid_mask",
              "gt_of_rois_src"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # an ulp of a background RoI's ~50 m offset from its GT is 3.8e-6
    np.testing.assert_allclose(got["gt_of_rois"].numpy(),
                               np.asarray(want["gt_of_rois"]), rtol=1e-6,
                               atol=1e-6)
    for k in ("gt_iou_of_rois", "rcnn_cls_labels"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
    fg = got["reg_valid_mask"].numpy()
    assert 0 < fg.sum() < fg.size


def test_second_stage_losses_match_jax(second_stage_both):
    got = second_stage_both["losses"]
    want = second_stage_both["jaux"][1:]
    for name, g, w in zip(("roi_cls", "roi_reg", "point"), got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-4,
                                   err_msg=name)
        assert float(w) > 0, name


@pytest.mark.parametrize("part", _SECOND)
def test_second_stage_gradients_match_jax_leaf_by_leaf(second_stage_both,
                                                       part):
    """||g_port - g_jax|| <= 1e-3 ||g_jax|| per second-stage leaf (the
    conv biases a training-mode BN follows have a gradient of 0 in exact
    arithmetic, and are held to 1e-3 of the largest leaf norm instead)."""
    grads, want = second_stage_both["grads"], second_stage_both["want"]
    names = [k for k in grads if k.startswith(part + ".")]
    assert names
    scale = max(np.linalg.norm(want[k]) for k in grads)
    for k in names:
        ref = np.linalg.norm(want[k])
        err = np.linalg.norm(grads[k] - want[k])
        if k.endswith(".bias") and ("conv" in k) and ref < 1e-3 * scale:
            assert err <= 1e-3 * scale, (k, err)
            continue
        assert ref > 0, k
        assert err <= 1e-3 * ref, (k, err / ref)


def test_second_stage_running_statistics_match_flax(second_stage_both):
    state, want = second_stage_both["state"], second_stage_both["want"]
    keys = [k for k in state if "running_" in k]
    assert len(keys) > 10
    for k in keys:
        np.testing.assert_allclose(state[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_loss_composition_matches_jax():
    """`PillarRCNN.loss` against the JAX package's on the same training
    output (the port's, as numpy) and the same collated batch: the same
    keys (the first stage's per-task losses, then `roi_reg_loss`,
    `roi_cls_loss`, `point_loss` per task) and values within rtol 1e-4,
    the RCNN and point losses added to task 0's `loss`."""
    from pillarnet_lts_tpu.parallel.collate import (
        collate_batch as jax_collate)

    cfg = _demo_cfg(dp_ratio=0.0)
    ds = SynthDataset(cfg, 2, 4096, seed=45)
    examples = [ds[0], ds[1]]
    port = build_model_from_cfg(cfg, device="cpu", seed=1).train()
    batch = batch_to_device(collate_batch(examples, 16384), "cpu")
    with torch.no_grad():
        out = port(batch["points"], batch["points_mask"],
                   gt_boxes_and_cls=batch["gt_boxes_and_cls"],
                   generator=torch.Generator().manual_seed(0))
        got = port.loss(batch, out, cfg["train_cfg"])
    jb = jax_collate(examples, max_points=16384)
    jb.pop("metadata")
    jout = jax.tree_util.tree_map(lambda t: t.numpy(), out)
    jm = build_jax_detector(copy.deepcopy(cfg["model"]),
                            train_cfg=cfg["train_cfg"],
                            test_cfg=cfg["test_cfg"])
    want = jax.jit(lambda e, o: jm.loss(e, o, cfg["train_cfg"]))(jb, jout)
    assert set(got) == set(want)  # (jit returns its dict keys sorted)
    assert list(got)[-3:] == ["roi_reg_loss", "roi_cls_loss", "point_loss"]
    for k in want:
        for t, (g, w) in enumerate(zip(got[k], want[k])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{k}[{t}]")
    cls, reg, point = port.second_stage_losses(out)
    first = port.single_det.loss(batch, out["one_stage_preds"],
                                 cfg["train_cfg"])
    assert got["loss"][0].item() == pytest.approx(
        (first["loss"][0] + (cls + reg) + point).item(), rel=1e-6)
    assert got["loss"][1].item() == first["loss"][1].item()


# ---- whole training steps of the port ---------------------------------------


def _demo_run(tmp_path, name, epochs, seed=1, resume_from=None, freeze=False):
    cfg = _demo_cfg(freeze=freeze)
    cfg["data"] = dict(cfg["data"], samples_per_gpu=2)
    cfg["total_epochs"] = epochs
    ds = SynthDataset(cfg, 2, 4096, seed=4)
    return train_detector(build_model_from_cfg(cfg, device="cpu", seed=seed),
                          ds, cfg, work_dir=str(tmp_path / name),
                          cfg_text="demo", resume_from=resume_from, seed=3)


def test_demo_training_loss_falls(tmp_path):
    """Five steps of `pillarrcnn18_demo` (dropout 0.3) on one batch through
    `apis.train_detector`: every metric finite, the three new losses
    logged per task, the loss after the fifth step below the first's. On
    one intra-op thread: five steps from random weights through the
    one-cycle peak part with the reduction order (the model moves a
    gradient ~1e5 times a 1e-6 weight nudge, ROADMAP Queue 3), so on
    torch's default threads the run would depend on the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t = _demo_run(tmp_path, "a", 5)
    finally:
        torch.set_num_threads(before)
    hist = t.log_buffer.val_history
    for k in ("roi_cls_loss_task0", "roi_reg_loss_task1",
              "point_loss_task0", "point_loss_task1", "hm_loss_task1"):
        assert k in hist, k
    for k, vals in hist.items():
        assert np.isfinite(vals).all(), k
    assert hist["loss"][-1] < hist["loss"][0], hist["loss"]
    assert hist["point_loss_task0"][-1] < hist["point_loss_task0"][0]


def test_demo_resumed_step_equals_the_uninterrupted_one(tmp_path):
    """Trainer A runs two epochs (one step each); trainer B, built from
    another seed, resumes A's first checkpoint: its second step samples the
    same RoIs and drops the same units, so its state and logged metrics
    equal A's."""
    a = _demo_run(tmp_path, "a", 2)
    b = _demo_run(tmp_path, "b", 2, seed=2,
                  resume_from=os.path.join(str(tmp_path / "a"),
                                           "epoch_1.pth"))
    assert (a.iter, b.iter) == (2, 2)
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    for k, hist in b.log_buffer.val_history.items():
        if k not in ("time", "data_time"):
            assert hist == a.log_buffer.val_history[k][1:], k
    # and the draws depend on the step
    d = [tptl.sampler_draws(step_generator(3, s, "cpu"), 1, 8, 4, "cpu")
         for s in (0, 1, 0)]
    assert torch.equal(d[0].ints, d[2].ints)
    assert not torch.equal(d[0].ints, d[1].ints)


def test_batch_to_device_carries_gt_boxes_and_cls():
    """The collated `gt_boxes_and_cls` reaches the model: a two-stage
    training forward without it raises, with it the losses come back."""
    cfg = _demo_cfg()
    ds = SynthDataset(cfg, 2, 4096, seed=5)
    batch = batch_to_device(collate_batch([ds[0], ds[1]], 16384), "cpu")
    assert tuple(batch["gt_boxes_and_cls"].shape) == (2, 100, 10)
    model = build_model_from_cfg(cfg, device="cpu", seed=1)
    with pytest.raises(ValueError, match="gt_boxes_and_cls"):
        step_losses(model, {k: v for k, v in batch.items()
                            if k != "gt_boxes_and_cls"}, cfg["train_cfg"],
                    torch.Generator().manual_seed(0))
    _, losses = step_losses(model, batch, cfg["train_cfg"],
                            torch.Generator().manual_seed(0))
    assert {"roi_cls_loss", "roi_reg_loss", "point_loss"} <= set(losses)


def test_freeze_leaves_the_first_stage_untouched():
    """With `freeze` a step leaves the first stage's running statistics
    as they were and gives its parameters no gradient: they move only by
    AdamW's decoupled decay (p - lr * wd * p, as optax's adamw on a zero
    gradient); the second stage trains."""
    cfg = _demo_cfg(freeze=True)
    ds = SynthDataset(cfg, 2, 4096, seed=6)
    batch = batch_to_device(collate_batch([ds[0], ds[1]], 16384), "cpu")
    model = build_model_from_cfg(cfg, device="cpu", seed=1)
    opt = optimizer_from_cfg(model, cfg, 10)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m = train_step(model, opt, batch, cfg["train_cfg"],
                   torch.Generator().manual_seed(0))
    assert model.training and not model.single_det.training
    lr, wd = opt.lr_fn(0), opt.param_groups[0]["weight_decay"]
    after = model.state_dict()
    moved = 0
    for n, p in model.named_parameters():
        if n.startswith("single_det."):
            assert p.grad is None, n
            want = before[n] + (before[n] * wd) * (-lr)
            assert torch.equal(after[n], want), n
        else:
            moved += int(not torch.equal(after[n], before[n] + (
                before[n] * wd) * (-lr)))
    for k in before:
        if k.startswith("single_det.") and "running_" in k:
            assert torch.equal(after[k], before[k]), k
    assert moved > 10 and np.isfinite(float(m["loss"]))


def test_two_stage_training_imports_no_jax(tmp_path):
    """One `pillarrcnn18_demo` step through `apis.train_detector` in a
    process that imports neither JAX nor the JAX package."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "from pillarnet_lts_torch.apis import (build_model_from_cfg, "
        "load_config, train_detector)\n"
        "from pillarnet_lts_torch.datasets import SynthDataset\n"
        "cfg = load_config('configs/demo/pillarrcnn18_demo.py')\n"
        "cfg['data'] = dict(cfg['data'], samples_per_gpu=2, max_points=2048)\n"
        "cfg['total_epochs'] = 1\n"
        "model = build_model_from_cfg(cfg, device='cpu')\n"
        "tr = train_detector(model, SynthDataset(cfg, 2, 2048), cfg,\n"
        "                    work_dir=sys.argv[1])\n"
        "assert tr.iter == 1\n"
        "assert 'point_loss_task0' in tr.log_buffer.val_history\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'pillarnet_lts_tpu')]\n"
        "assert not bad, bad\n"
        "print('no-jax ok')\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "no-jax ok" in out.stdout


@pytest.mark.slow
def test_demo_training_forward_and_loss_match_jax():
    """The whole `pillarrcnn18_demo` training forward and loss in both
    packages (dropout off) from one JAX variables tree with the first
    stage's head spread, on one collated batch, the sampler drawing from
    one key in both (the JAX package's `proposal_target_layer` given that
    key, the port's `sampler_draws` replaced by `jax_draws` of it), after
    margins of 1e-4 from the score threshold and the NMS thresholds: the
    sampled RoI labels and fg masks equal; the sampled RoIs, their GT and
    scores, and every loss held to the JAX package's own spread, measured
    here as `test_torch_port_train_step.py` does (the same step compiled
    without XLA's fusion pass): within twice its largest difference, or
    1e-4 (rtol for the losses, m for the boxes). On random weights the
    spread first-stage heads turn the two builds' ~1e-6 differences into
    ~1e-3 m in the box sizes. Slow: it compiles the JAX package's
    training forward twice."""
    from pillarnet_lts_tpu.models.detectors import pillar_rcnn as jrcnn
    from pillarnet_lts_tpu.parallel.collate import (
        collate_batch as jax_collate)
    from pillarnet_lts_torch.models.detectors import pillar_rcnn as trcnn
    from pillarnet_lts_torch.ops.iou3d import rotated_iou_bev, to_pcdet_bev
    from test_torch_port_rcnn import spread_rcnn_heads

    cfg = _demo_cfg(dp_ratio=0.0)
    ds = SynthDataset(cfg, 2, 4096, seed=46)
    examples = [ds[0], ds[1]]
    batch = batch_to_device(collate_batch(examples, 16384), "cpu")
    jb = jax_collate(examples, max_points=16384)
    jb.pop("metadata")
    jm = build_jax_detector(copy.deepcopy(cfg["model"]),
                            train_cfg=cfg["train_cfg"],
                            test_cfg=cfg["test_cfg"])
    variables = random_variables(jm, 47, jnp.asarray(jb["points"]),
                                 jnp.asarray(jb["points_mask"]), train=False)
    variables = jax.tree_util.tree_map(np.array, variables)
    port = build_model_from_cfg(cfg, device="cpu")
    spread_rcnn_heads(port, variables, batch["points"], batch["points_mask"])
    key = jax.random.PRNGKey(48)
    M = cfg["model"]["roi_head"]["model_cfg"]["TARGET_CONFIG"][
        "ROI_PER_IMAGE"]

    port.train()
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(trcnn, "sampler_draws",
                   lambda g, B, R, M_, d: jax_draws(key, B, R, M_))
        out = port(batch["points"], batch["points_mask"],
                   gt_boxes_and_cls=batch["gt_boxes_and_cls"],
                   generator=torch.Generator())
        got = port.loss(batch, out, cfg["train_cfg"])
        first, *_ = port.first_stage(batch["points"], batch["points_mask"])

    def jax_step(v, b):
        o, _ = jm.apply(v, b["points"], b["points_mask"],
                        gt_boxes_and_cls=b["gt_boxes_and_cls"], train=True,
                        mutable=["batch_stats"],
                        rngs={"dropout": key, "sampler": key})
        return o, jm.loss(b, o, cfg["train_cfg"])

    builds = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrcnn, "proposal_target_layer",
                   lambda rng, *a: jptl.proposal_target_layer(key, *a))
        for options in (None, {"xla_disable_hlo_passes": "fusion"}):
            step = jax.jit(jax_step).lower(variables, jb).compile(
                compiler_options=options)
            builds.append(jax.tree_util.tree_map(np.asarray,
                                                 step(variables, jb)))
    (jout, want), (jout2, want2) = builds

    # margins: no candidate score on the threshold, no kept same-class
    # pair's IoU on its NMS threshold
    test_cfg = port.processed_test_cfg()
    scores = torch.cat([torch.sigmoid(p["hm"]).flatten()
                        for p in out["one_stage_preds"]])
    assert (scores - test_cfg["score_threshold"]).abs().min() > 1e-4
    threshs = sum(test_cfg["nms"]["nms_iou_threshold"], [])
    for b in range(2):
        for k, th in enumerate(threshs):
            cls = first["mask"][b] & (first["label_preds"][b] == k)
            if int(cls.sum()) > 1:
                bev = to_pcdet_bev(first["box3d_lidar"][b][cls])
                iou = rotated_iou_bev(bev, bev)
                off = ~torch.eye(len(bev), dtype=torch.bool)
                assert (iou[off] - th).abs().min() > 1e-4

    t, jt, jt2 = out["targets"], jout["targets"], jout2["targets"]
    for k in ("roi_labels", "reg_valid_mask"):
        np.testing.assert_array_equal(t[k].numpy(), jt[k], k)
        np.testing.assert_array_equal(jt2[k], jt[k], k)
    assert int((t["roi_labels"] > 0).sum()) > 10
    for k in ("rois", "gt_of_rois_src", "roi_scores"):
        port_d = np.abs(t[k].numpy() - jt[k]).max()
        own = np.abs(jt2[k] - jt[k]).max()
        assert port_d <= max(2 * own, 1e-4), (k, port_d, own)

    def rel(a, b):
        return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())

    assert set(got) == set(want)
    for k in want:
        for i, w in enumerate(want[k]):
            port_r = rel(got[k][i].numpy(), w)
            own = rel(want2[k][i], w)
            assert port_r <= max(2 * own, 1e-4), (k, i, port_r, own)


@pytest.mark.slow
def test_a_weight_nudge_moves_the_gradient_as_much_in_jax():
    """The spread of the two-stage gradient is the model's: one
    `pillarrcnn18_demo` training step (dropout off, first-stage head
    spread, the sampler drawing from one key in both packages, as
    `test_demo_training_forward_and_loss_match_jax`) from the weights and
    from 3 copies times 1 + 1e-6 N(0, 1), in the JAX package (jitted) and
    in the port: each group's relative gradient change under the nudges,
    printed per package. The sampled RoI labels do not move. The port's
    largest backbone change lies within a factor 2 of the JAX package's,
    and the port's gradient is as near the JAX package's as the JAX
    package's nudged gradients are to its own. Slow: it compiles the JAX
    package's training step."""
    from chip_smoke import grad_diffs
    from pillarnet_lts_tpu.models.detectors import pillar_rcnn as jrcnn
    from pillarnet_lts_tpu.parallel.collate import (
        collate_batch as jax_collate)
    from pillarnet_lts_torch.models.detectors import pillar_rcnn as trcnn
    from test_torch_port_rcnn import spread_rcnn_heads

    cfg = _demo_cfg(dp_ratio=0.0)
    ds = SynthDataset(cfg, 2, 4096, seed=46)
    examples = [ds[0], ds[1]]
    batch = batch_to_device(collate_batch(examples, 16384), "cpu")
    jb = jax_collate(examples, max_points=16384)
    jb.pop("metadata")
    jm = build_jax_detector(copy.deepcopy(cfg["model"]),
                            train_cfg=cfg["train_cfg"],
                            test_cfg=cfg["test_cfg"])
    variables = jax.tree_util.tree_map(np.array, random_variables(
        jm, 47, jnp.asarray(jb["points"]), jnp.asarray(jb["points_mask"]),
        train=False))
    spread_rcnn_heads(build_model_from_cfg(cfg, device="cpu"), variables,
                      batch["points"], batch["points_mask"])
    key = jax.random.PRNGKey(48)
    rng = np.random.RandomState(16)
    trees = [variables["params"]] + [jax.tree_util.tree_map(
        lambda p: (p * (1 + 1e-6 * rng.randn(*p.shape))).astype(np.float32),
        variables["params"]) for _ in range(3)]

    def port_names(params):
        m = load_jax_variables(build_model_from_cfg(cfg, device="cpu"), {
            "params": jax.tree_util.tree_map(np.asarray, params),
            "batch_stats": variables["batch_stats"]})
        return m

    def jloss(params, b):
        o, _ = jm.apply({"params": params,
                         "batch_stats": variables["batch_stats"]},
                        b["points"], b["points_mask"],
                        gt_boxes_and_cls=b["gt_boxes_and_cls"], train=True,
                        mutable=["batch_stats"],
                        rngs={"dropout": key, "sampler": key})
        losses = jm.loss(b, o, cfg["train_cfg"])
        total = jnp.asarray(0.0, jnp.float32)
        for part in losses["loss"]:
            total = total + part
        return total, o["targets"]["roi_labels"]

    jax_grads, labels = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrcnn, "proposal_target_layer",
                   lambda r, *a: jptl.proposal_target_layer(key, *a))
        step = jax.jit(jax.value_and_grad(jloss, has_aux=True))
        for t in trees:
            (_, lab), g = step(t, jb)
            labels.append(np.asarray(lab))
            jax_grads.append({n: p.detach().clone() for n, p in
                              port_names(g).named_parameters()})
    port_grads = []
    for t in trees:
        m = port_names(t)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(trcnn, "sampler_draws",
                       lambda g, B, R, M_, d: jax_draws(key, B, R, M_))
            total, _ = step_losses(m, batch, cfg["train_cfg"],
                                   torch.Generator())
        total.backward()
        port_grads.append({n: p.grad.detach().clone()
                           for n, p in m.named_parameters()
                           if p.grad is not None})
    assert all(np.array_equal(lab, labels[0]) for lab in labels)

    spread = {}
    for name, grads in (("jax", jax_grads), ("port", port_grads)):
        base = {k: v for k, v in grads[0].items() if k in port_grads[0]}
        moves = [grad_diffs(torch, g, base)[0] for g in grads[1:]]
        spread[name] = {k: max(m[k] for m in moves) for k in moves[0]}
        print(f"{name}: the largest relative gradient change by group under "
              f"a 1e-6 nudge: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in sorted(spread[name].items())))
    apart = grad_diffs(torch, port_grads[0], {
        k: v for k, v in jax_grads[0].items() if k in port_grads[0]})[0]
    print("port vs JAX, unnudged: " + ", ".join(
        f"{k} {v:.3e}" for k, v in sorted(apart.items())))
    bb = "single_det.backbone_net"
    assert 0.5 <= spread["port"][bb] / spread["jax"][bb] <= 2.0, spread
    assert spread["jax"][bb] > 1e-2  # the JAX package's own spread
    assert apart[bb] <= spread["jax"][bb], (apart, spread)
