"""PyTorch port, training pieces against the JAX package on the same numpy
inputs: pillar ids, the scatter-max gradient, masked BN in training, the
CenterNet losses, the target assignment and the one-cycle AdamW.

Tolerances: pillar ids, validity and the scatter gradient bit-equal (a
compare and a gather); the target arrays bit-equal (the same numpy);
masked BN rtol = atol = 1e-5 (sums in other orders); losses rtol = atol =
1e-6 (a loss of ~100 is summed in another order: atol alone would be below
its f32 ulp); the schedules and the optimizer rtol = 1e-6 with atol =
1e-6 * lr_max (1e-9): the same f32 formulas, but numpy's f32 cosine and
XLA's differ in the last ulp, which the cosine's cancellation near the
end of the cycle makes ~1e-6 relative, and a parameter passing near 0
has no relative precision. The whole train step is in
`test_torch_port_train_step.py`.

The JAX package's TPU scatter kernels carry their own gradient
(`voxelize_kernel.py:853-890`): a pillar's whole gradient goes to every
point equal to its max. Its CPU default (XLA's `segment_max`) splits it
between tied points instead, so the references here run
`pillar_scatter_max_pallas` in interpret mode, and `tpu_vjp_scatter`
(XLA's forward, bit-equal to the kernel's, with the kernel's backward
`_scatter_vjp_bwd`) stands in for it where a whole model runs, pinned
equal to it below.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.experimental.pallas import tpu as pltpu

from pillarnet_lts_tpu.datasets.demo import DemoDataset
from pillarnet_lts_tpu.datasets.pipelines import preprocess as jpre
from pillarnet_lts_tpu.datasets.pipelines import formating as jfmt
from pillarnet_lts_tpu.models.losses import centernet_loss as jloss
from pillarnet_lts_tpu.models.utils.norm import (
    MaskedBatchNorm as JMaskedBatchNorm,
)
from pillarnet_lts_tpu.ops import voxelize as jvox
from pillarnet_lts_tpu.ops.pallas import voxelize_kernel as jvk
from pillarnet_lts_tpu.solver import optim as joptim
from pillarnet_lts_torch.apis import build_model_from_cfg, load_config
from pillarnet_lts_torch.datasets import (SynthDataset, synth_points_realistic,
                                          synth_scene)
from pillarnet_lts_torch.models.losses import centernet_loss as tloss
from pillarnet_lts_torch.models.utils.norm import MaskedBatchNorm
from pillarnet_lts_torch.ops import scatter as tscatter
from pillarnet_lts_torch.ops import voxelize as tvox
from pillarnet_lts_torch.solver import build_optimizer, one_cycle_schedules
import test_torch_port_threads  # noqa: F401  (one torch thread)

ROOT = os.path.join(os.path.dirname(__file__), "..")
FLAGSHIP = os.path.join(ROOT, "configs", "pillarnet", "pillarnet34_nusc.py")
DEMO = os.path.join(ROOT, "configs", "demo", "pillarnet18_demo.py")
NUSC_RANGE = [-54.0, -54.0, -5.0, 54.0, 54.0, 3.0]


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5))
def tpu_vjp_scatter(point_feats, flat_ids, valid, height, width,
                    nonneg=False):
    """JAX's XLA scatter-max forward with the TPU kernels' backward, with
    `pillarnet_lts_tpu.ops.scatter.pillar_scatter_max`'s signature."""
    return jvox.scatter_max_to_grid(point_feats, flat_ids, valid, height,
                                    width)


def _tpu_vjp_fwd(point_feats, flat_ids, valid, height, width, nonneg):
    grid, occ = jvox.scatter_max_to_grid(point_feats, flat_ids, valid,
                                         height, width)
    res = (point_feats, flat_ids, valid,
           jvk._pack_residual_rows(grid, height, width))
    return (grid, occ), res


def _tpu_vjp_bwd(height, width, nonneg, res, cotangents):
    return jvk._scatter_vjp_bwd(height, width, None, res, cotangents)


tpu_vjp_scatter.defvjp(_tpu_vjp_fwd, _tpu_vjp_bwd)


# ---- pillar ids ------------------------------------------------------------

def _ids_both(pts, msk, pillar_size, pc_range):
    jspec = jvox.PillarSpec(pillar_size, tuple(pc_range))
    tspec = tvox.PillarSpec(pillar_size, tuple(pc_range))
    jf, jids, jvalid = jax.jit(
        lambda p, m: jvox.voxelize_points(p, m, jspec))(pts, msk)
    tf, tids, tvalid = tvox.voxelize_points(
        torch.from_numpy(pts), torch.from_numpy(msk), tspec)
    return (np.asarray(jids), np.asarray(jvalid), np.asarray(jf),
            tids.numpy(), tvalid.numpy(), tf.numpy())


def test_pillar_ids_equal_jitted_jax_on_the_flagship_clouds():
    """All 1,048,576 points of the flagship's 4 calibration clouds."""
    for seed in (90, 91, 92, 93):
        pts, msk = synth_points_realistic(1, 262144, NUSC_RANGE, seed=seed)
        jids, jvalid, jf, tids, tvalid, tf = _ids_both(pts, msk, 0.075,
                                                       NUSC_RANGE)
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_array_equal(tvalid, jvalid)
        np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-5)


@pytest.mark.parametrize("pillar_size, pc_range", [
    (0.075, NUSC_RANGE),
    (0.1, [-75.2, -75.2, -2.0, 75.2, 75.2, 4.0]),
    (0.5, [-16.0, -16.0, -5.0, 16.0, 16.0, 3.0]),
], ids=["nusc", "waymo", "demo"])
def test_pillar_ids_at_pillar_edges(pillar_size, pc_range):
    """Every x0 + k * pillar_size (rounded to f32) and its f32 neighbours,
    in x and in y."""
    n = int(round((pc_range[3] - pc_range[0]) / pillar_size))
    edge = np.float32(pc_range[0] + np.arange(n + 1) * pillar_size)
    xs = np.concatenate([np.nextafter(edge, np.float32(-np.inf)), edge,
                         np.nextafter(edge, np.float32(np.inf))])
    k = xs.size
    pts = np.zeros((2, k, 5), np.float32)
    pts[0, :, 0] = xs
    pts[0, :, 1] = np.float32(pc_range[1] + 0.3 * pillar_size)
    pts[1, :, 0] = np.float32(pc_range[0] + 0.3 * pillar_size)
    pts[1, :, 1] = xs
    msk = np.ones((2, k), bool)
    jids, jvalid, _, tids, tvalid, _ = _ids_both(pts, msk, pillar_size,
                                                 pc_range)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tvalid, jvalid)


# ---- the scatter-max gradient ---------------------------------------------

H = W = 16


@pytest.fixture(scope="module")
def tied_scatter():
    """Post-ReLU-like features with positive duplicated points (exact
    ties at the max), the cotangent, and the JAX references' gradients."""
    rng = np.random.RandomState(7)
    B, N, C = 1, 300, 8
    feats = np.maximum(rng.randn(B, N, C), 0).astype(np.float32)
    ids = rng.randint(0, H * W, (B, N)).astype(np.int32)
    valid = rng.rand(B, N) > 0.2
    # 40 positive points copied onto 40 others: same pillar, same features
    feats[:, 100:140] += 0.5
    feats[:, 200:240] = feats[:, 100:140]
    ids[:, 200:240] = ids[:, 100:140]
    valid[:, 200:240] = valid[:, 100:140] = True
    ids = np.where(valid, ids, H * W).astype(np.int32)
    cot = rng.randn(B, H, W, C).astype(np.float32)

    def grad(fn):
        _, vjp = jax.vjp(lambda f: fn(f, jnp.asarray(ids),
                                      jnp.asarray(valid), H, W)[0],
                         jnp.asarray(feats))
        return np.asarray(vjp(jnp.asarray(cot))[0])

    with pltpu.force_tpu_interpret_mode():
        pallas = grad(jvk.pillar_scatter_max_pallas)
    return dict(feats=feats, ids=ids, valid=valid, cot=cot, pallas=pallas,
                composed=grad(tpu_vjp_scatter),
                xla=grad(jvox.scatter_max_to_grid))


@pytest.mark.parametrize("backend", ["auto", "tiled"])
def test_scatter_gradient_matches_the_tpu_kernels_vjp(tied_scatter, backend):
    t = tied_scatter
    feats = torch.from_numpy(t["feats"]).requires_grad_(True)
    tscatter.set_backend(backend)
    try:
        grid, occ = tscatter.pillar_scatter_max(
            feats, torch.from_numpy(t["ids"]), torch.from_numpy(t["valid"]),
            H, W, nonneg=True)
    finally:
        tscatter.set_backend("auto")
    assert not occ.requires_grad
    (grid * torch.from_numpy(t["cot"])).sum().backward()
    np.testing.assert_array_equal(feats.grad.numpy(), t["pallas"])


def test_scatter_references_agree_on_ties(tied_scatter):
    """The stand-in equals the kernel's VJP; XLA's split differs on the
    duplicated points (so the test above tells the two apart)."""
    t = tied_scatter
    np.testing.assert_array_equal(t["composed"], t["pallas"])
    split = (t["pallas"] != t["xla"]).any(-1)[0]
    assert split[100:140].any() and split[200:240].any()


def test_scatter_without_grad_keeps_the_forward_path():
    t = np.random.RandomState(0)
    feats = torch.from_numpy(t.randn(1, 50, 4).astype(np.float32))
    ids = torch.from_numpy(t.randint(0, 16, (1, 50)).astype(np.int32))
    valid = torch.ones(1, 50, dtype=torch.bool)
    grid, _ = tscatter.pillar_scatter_max(feats, ids, valid, 4, 4)
    assert grid.grad_fn is None
    grid, _ = tscatter.pillar_scatter_max(feats.requires_grad_(True), ids,
                                          valid, 4, 4)
    assert grid.grad_fn is not None


# ---- masked BN in training --------------------------------------------------

@pytest.mark.parametrize("layout", ["maps", "maps_masked", "points_masked"])
def test_masked_bn_train_matches_flax(layout):
    rng = np.random.RandomState(3)
    C = 6
    if layout == "points_masked":
        x = rng.randn(2, 300, C).astype(np.float32) * 3 + 1
        mask = rng.rand(2, 300) > 0.4
    else:
        x = rng.randn(2, 12, 10, C).astype(np.float32) * 3 + 1
        mask = (rng.rand(2, 12, 10) > 0.7) if layout == "maps_masked" \
            else None
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.3, C).astype(np.float32)
    ra_mean = rng.normal(0, 0.2, C).astype(np.float32)
    ra_var = rng.uniform(0.5, 2.0, C).astype(np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)

    bn = JMaskedBatchNorm(C)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": ra_mean, "var": ra_var}}

    def fwd(params, xx):
        return bn.apply({"params": params,
                         "batch_stats": variables["batch_stats"]}, xx,
                        mask=None if mask is None else jnp.asarray(mask),
                        train=True, mutable=["batch_stats"])

    jy, jupd = jax.jit(fwd)(variables["params"], jnp.asarray(x))
    jgrads = jax.jit(jax.grad(
        lambda p, xx: (fwd(p, xx)[0] * cot).sum(), argnums=(0, 1)))(
        variables["params"], jnp.asarray(x))

    tbn = MaskedBatchNorm(C).train()
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
        tbn.running_mean.copy_(torch.from_numpy(ra_mean))
        tbn.running_var.copy_(torch.from_numpy(ra_var))
    if layout == "points_masked":
        tx = torch.from_numpy(x).requires_grad_(True)
        tm = torch.from_numpy(mask)[..., None]
        ty = tbn(tx, tm)
        got = ty
    else:
        tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
        tx.requires_grad_(True)
        tm = None if mask is None else torch.from_numpy(mask)[:, None]
        ty = tbn(tx, None if tm is None else tm.float())
        got = ty.permute(0, 2, 3, 1)
    (got * torch.from_numpy(cot)).sum().backward()

    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(jupd["batch_stats"]["mean"]), **tol)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(jupd["batch_stats"]["var"]), **tol)
    gx = tx.grad if layout == "points_masked" else tx.grad.permute(0, 2, 3, 1)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgrads[1]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tbn.weight.grad.numpy(),
                               np.asarray(jgrads[0]["scale"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tbn.bias.grad.numpy(),
                               np.asarray(jgrads[0]["bias"]), rtol=1e-4,
                               atol=1e-5)


# ---- losses ----------------------------------------------------------------

def _loss_inputs(seed, B=2, C=3, Hm=24, Wm=20, M=12):
    rng = np.random.RandomState(seed)
    hm = np.clip(1 / (1 + np.exp(-rng.randn(B, Hm, Wm, C) * 2)), 1e-4,
                 1 - 1e-4).astype(np.float32)
    target = np.clip(rng.rand(B, Hm, Wm, C) ** 4, 0, 1).astype(np.float32)
    ind = rng.randint(0, Hm * Wm, (B, M)).astype(np.int64)
    mask = (rng.rand(B, M) > 0.3).astype(np.uint8)
    cat = rng.randint(0, C, (B, M)).astype(np.int64)
    box_map = rng.randn(B, Hm, Wm, 8).astype(np.float32)
    target_box = rng.randn(B, M, 8).astype(np.float32)

    def boxes(shape):
        b = np.zeros(shape + (7,), np.float32)
        b[..., :2] = rng.uniform(-20, 20, shape + (2,))
        b[..., 2] = rng.uniform(-2, 1, shape)
        b[..., 3:6] = rng.uniform(0.5, 5, shape + (3,))
        b[..., 6] = rng.uniform(-np.pi, np.pi, shape)
        return b

    pred_boxes = boxes((B, Hm, Wm))
    gt = boxes((B, M))
    # half the objects overlap their prediction: IoU away from 0
    flat = pred_boxes.reshape(B, -1, 7)
    for b in range(B):
        gt[b, ::2] = flat[b, ind[b, ::2]] + rng.normal(0, 0.3, (7,)).astype(
            np.float32)
    gt[..., 3:6] = np.abs(gt[..., 3:6]) + 0.1
    iou_map = rng.randn(B, Hm, Wm, 1).astype(np.float32)
    return dict(hm=hm, target=target, ind=ind, mask=mask, cat=cat,
                box_map=box_map, target_box=target_box, pred_boxes=pred_boxes,
                gt=gt, iou_map=iou_map)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("seed", [0, 1])
def test_losses_match_jax(seed):
    d = _loss_inputs(seed)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    tol = dict(rtol=1e-6, atol=1e-6)

    np.testing.assert_allclose(
        tloss.gather_feat(_nchw(d["box_map"]), t["ind"]).numpy(),
        np.asarray(jloss.gather_feat(j["box_map"], j["ind"])), rtol=0, atol=0)
    np.testing.assert_allclose(
        float(tloss.fast_focal_loss(_nchw(d["hm"]), _nchw(d["target"]),
                                    t["ind"], t["mask"], t["cat"])),
        float(jax.jit(jloss.fast_focal_loss)(j["hm"], j["target"], j["ind"],
                                             j["mask"], j["cat"])), **tol)
    np.testing.assert_allclose(
        tloss.reg_loss(_nchw(d["box_map"]), t["mask"], t["ind"],
                       t["target_box"]).numpy(),
        np.asarray(jax.jit(jloss.reg_loss)(j["box_map"], j["mask"], j["ind"],
                                           j["target_box"])), **tol)
    np.testing.assert_allclose(
        float(tloss.iou_loss(_nchw(d["iou_map"]), t["mask"], t["ind"],
                             _nchw(d["pred_boxes"]), t["gt"])),
        float(jax.jit(jloss.iou_loss)(j["iou_map"], j["mask"], j["ind"],
                                      j["pred_boxes"], j["gt"])), **tol)
    for kind in ("IoU", "GIoU", "DIoU"):
        np.testing.assert_allclose(
            float(tloss.iou_reg_loss(_nchw(d["pred_boxes"]), t["mask"],
                                     t["ind"], t["gt"], kind)),
            float(jax.jit(functools.partial(jloss.iou_reg_loss, kind=kind))(
                j["pred_boxes"], j["mask"], j["ind"], j["gt"])), **tol)


def _loss_cases(d, seed):
    """{loss: (JAX function, its differentiable inputs, the port's)} on the
    inputs of `_loss_inputs`; `reg_loss`'s per-dimension vector is weighted
    by a random vector (as `code_weights` weight it)."""
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    w = np.random.RandomState(seed + 10).rand(8).astype(np.float32)
    cases = {
        "focal": (lambda o: jloss.fast_focal_loss(
            o, j["target"], j["ind"], j["mask"], j["cat"]), ("hm",),
            lambda o: tloss.fast_focal_loss(
                o, _nchw(d["target"]), t["ind"], t["mask"], t["cat"])),
        "reg": (lambda o: jloss.reg_loss(
            o, j["mask"], j["ind"], j["target_box"]) @ jnp.asarray(w),
            ("box_map",),
            lambda o: tloss.reg_loss(o, t["mask"], t["ind"], t["target_box"])
            @ torch.from_numpy(w)),
        "iou": (lambda a, b: jloss.iou_loss(a, j["mask"], j["ind"], b,
                                            j["gt"]),
                ("iou_map", "pred_boxes"),
                lambda a, b: tloss.iou_loss(a, t["mask"], t["ind"], b,
                                            t["gt"])),
    }
    for kind in ("IoU", "GIoU", "DIoU"):
        cases[kind] = (
            functools.partial(lambda b, kind: jloss.iou_reg_loss(
                b, j["mask"], j["ind"], j["gt"], kind), kind=kind),
            ("pred_boxes",),
            functools.partial(lambda b, kind: tloss.iou_reg_loss(
                b, t["mask"], t["ind"], t["gt"], kind), kind=kind))
    return cases


@pytest.mark.parametrize("loss", ["focal", "reg", "iou", "IoU", "GIoU",
                                  "DIoU"])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_gradients_match_jax(seed, loss):
    """torch.autograd.grad of each loss against jax.grad, input by input:
    rtol 1e-4 with atol 1e-6, and atol 1e-5 for `iou_loss`'s box gradient,
    which runs through the rotated polygon clip of the aligned IoU (the
    intersection vertices round differently; ~3e-6 on gradients of ~0.15).
    The zeros (unmasked sites, unselected classes) must coincide."""
    d = _loss_inputs(seed)
    jf, args, tf = _loss_cases(d, seed)[loss]
    want = jax.jit(jax.grad(jf, argnums=tuple(range(len(args)))))(
        *[jnp.asarray(d[a]) for a in args])
    inputs = [_nchw(d[a]).requires_grad_(True) for a in args]
    got = torch.autograd.grad(tf(*inputs), inputs)
    for name, g, w in zip(args, got, want):
        w = np.asarray(w)
        assert np.count_nonzero(w) > 0, name
        atol = 1e-5 if (loss, name) == ("iou", "pred_boxes") else 1e-6
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   rtol=1e-4, atol=atol, err_msg=name)


def test_focal_loss_without_objects_has_a_finite_gradient():
    d = _loss_inputs(2)
    mask = np.zeros_like(d["mask"])
    want = float(jax.jit(jloss.fast_focal_loss)(
        jnp.asarray(d["hm"]), jnp.asarray(d["target"]), jnp.asarray(d["ind"]),
        jnp.asarray(mask), jnp.asarray(d["cat"])))
    out = _nchw(d["hm"]).requires_grad_(True)
    got = tloss.fast_focal_loss(out, _nchw(d["target"]),
                                torch.from_numpy(d["ind"]),
                                torch.from_numpy(mask),
                                torch.from_numpy(d["cat"]))
    got.backward()
    np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=1e-6)
    assert bool(torch.isfinite(out.grad).all())


# ---- targets ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
def test_synth_scene_equals_the_demo_dataset(seed):
    cfg = load_config(DEMO)
    rng_range = cfg["point_cloud_range"]
    jds = DemoDataset(num_points=4096, pc_range=rng_range,
                      class_names=cfg["class_names"], seed=seed)
    for idx in range(3):
        want = jds._synth_frame(idx)
        got = synth_scene(seed + idx, 4096, rng_range, cfg["class_names"])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _jax_targets(cfg, points, boxes, names):
    res = {"type": "DemoDataset", "mode": "train", "metadata": {},
           "lidar": {"combined": points,
                     "annotations": {"boxes": boxes.copy(), "names": names}}}
    stages = [
        jpre.Preprocess(cfg=dict(mode="train", shuffle_points=False,
                                 no_augmentation=True,
                                 global_rot_noise=None,
                                 global_scale_noise=None,
                                 class_names=cfg["class_names"])),
        jpre.AssignLabel(cfg=cfg["train_cfg"]["assigner"]),
        jfmt.Reformat(),
    ]
    info = None
    for stage in stages:
        res, info = stage(res, info)
    return res


@pytest.mark.parametrize("path, num_boxes", [(DEMO, (3, 9)),
                                             (FLAGSHIP, (10, 31))],
                         ids=["demo", "flagship"])
def test_assign_label_arrays_equal_the_jax_package(path, num_boxes):
    cfg = load_config(path)
    ds = SynthDataset(cfg, 3, 4096, seed=11, num_boxes=num_boxes)
    for i in range(len(ds)):
        got = ds[i]
        pts, boxes, names = synth_scene(11 + i, 4096, ds.pc_range,
                                        ds.class_names, num_boxes)
        want = _jax_targets(cfg, pts, boxes, names)
        np.testing.assert_array_equal(got["points"], want["points"])
        for key in ("hm", "anno_box", "ind", "mask", "cat", "gt_box"):
            assert len(got[key]) == len(cfg["model"]["bbox_head"]["tasks"])
            for a, b in zip(got[key], want[key]):
                assert a.dtype == b.dtype and a.shape == b.shape, key
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got["gt_boxes_and_cls"],
                                      want["gt_boxes_and_cls"])
        assert sum(m.sum() for m in got["mask"]) > 0


# ---- the optimizer ---------------------------------------------------------

LR_CONFIG = dict(type="one_cycle", lr_max=1e-3, moms=[0.95, 0.85],
                 div_factor=10.0, pct_start=0.4)


@pytest.mark.parametrize("total_steps", [8, 37, 1000])
def test_one_cycle_schedules_match_jax(total_steps):
    args = (total_steps, 1e-3, (0.95, 0.85), 10.0, 0.4)
    jlr, jmom = joptim.one_cycle_schedules(*args)
    tlr, tmom = one_cycle_schedules(*args)
    steps = np.arange(total_steps + 2)
    want_lr = np.asarray(jax.jit(jax.vmap(jlr))(steps))
    want_mom = np.asarray(jax.jit(jax.vmap(jmom))(steps))
    np.testing.assert_allclose([tlr(int(s)) for s in steps], want_lr,
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose([tmom(int(s)) for s in steps], want_mom,
                               rtol=1e-6, atol=1e-9)


def test_adamw_with_clip_matches_optax_over_five_steps():
    """8 steps of one-cycle (pct_start at step 3), 5 taken: warm-up,
    the peak and the way down; gradients above and below the clip norm."""
    rng = np.random.RandomState(4)
    shapes = {"a": (16, 8, 3, 3), "b": (8,), "c": (5, 7)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    scales = [100.0, 0.5, 40.0, 1e-3, 10.0]
    grads = [{k: (rng.randn(*s) * g).astype(np.float32)
              for k, s in shapes.items()} for g in scales]

    tx = joptim.build_optimizer(dict(type="adam", wd=0.01), LR_CONFIG, 8,
                                grad_clip_norm=35.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)

    @jax.jit
    def update(g, st, p):
        upd, st = tx.update(g, st, p)
        return optax.apply_updates(p, upd), st

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = build_optimizer(list(tp.values()), dict(type="adam", wd=0.01),
                          LR_CONFIG, 8, grad_clip_norm=35.0)
    for g in grads:
        jp, state = update({k: jnp.asarray(v) for k, v in g.items()}, state,
                           jp)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        norm = opt.step()
        want_norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                for v in g.values()))
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-9)
    assert opt.count == 5


def test_adamw_with_all_zero_gradients_matches_optax():
    """A global norm of 0: optax's clip selects the gradients as they are
    and never reads g / 0; the update is the weight decay alone."""
    rng = np.random.RandomState(6)
    params = {"a": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    tx = joptim.build_optimizer(dict(type="adam", wd=0.01), LR_CONFIG, 8,
                                grad_clip_norm=35.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    zeros = {k: jnp.zeros_like(v) for k, v in jp.items()}
    upd, _ = tx.update(zeros, tx.init(jp), jp)
    want = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = build_optimizer(list(tp.values()), dict(type="adam", wd=0.01),
                          LR_CONFIG, 8, grad_clip_norm=35.0)
    for p in tp.values():
        p.grad = torch.zeros_like(p)
    assert float(opt.step()) == 0.0
    for k, p in tp.items():
        assert bool(torch.isfinite(p).all()), k
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-9)
        assert not np.array_equal(p.detach().numpy(), params[k])


def test_adamw_state_round_trips():
    p = torch.nn.Parameter(torch.ones(3))
    opt = build_optimizer([p], dict(type="adam"), LR_CONFIG, 10, 35.0)
    p.grad = torch.full((3,), 0.5)
    opt.step()
    q = torch.nn.Parameter(p.detach().clone())
    other = build_optimizer([q], dict(type="adam"), LR_CONFIG, 10, 35.0)
    other.load_state_dict(opt.state_dict())
    p.grad = q.grad = torch.full((3,), -0.25)
    opt.step()
    other.step()
    assert other.count == 2
    torch.testing.assert_close(q, p, rtol=0, atol=0)


# ---- the port alone --------------------------------------------------------

def test_built_models_are_in_eval_mode_and_train_switches_every_module():
    model = build_model_from_cfg(load_config(DEMO), device="cpu")
    assert not any(m.training for m in model.modules())
    model.train()
    assert all(m.training for m in model.modules())


def test_training_path_imports_no_jax(tmp_path):
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "from pillarnet_lts_torch.apis import (build_model_from_cfg, "
        "load_config, train_detector)\n"
        "from pillarnet_lts_torch.datasets import SynthDataset\n"
        "from pillarnet_lts_torch.parallel import dist, mesh\n"
        "cfg = load_config('configs/demo/pillarnet18_demo.py')\n"
        "cfg['data'] = dict(cfg['data'], samples_per_gpu=2, max_points=2048)\n"
        "cfg['total_epochs'] = 1\n"
        "model = build_model_from_cfg(cfg, device='cpu')\n"
        "tr = train_detector(model, SynthDataset(cfg, 2, 2048), cfg,\n"
        "                    work_dir=sys.argv[1])\n"
        "assert tr.iter == 1\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'pillarnet_lts_tpu')]\n"
        "assert not bad, bad\n"
        "print('no-jax ok')\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "no-jax ok" in out.stdout
