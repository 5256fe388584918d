"""PyTorch port, the legacy generic `RPN` neck, `MaskedGroupNorm`, the
norm-layer factory (`build_norm`, `get_norm_kwargs`) and the NMS audit
`greedy_suppress_with_convergence`, each against the JAX package on the
same numpy inputs.

Tolerances:
- RPN f32 eval: rtol = atol = 1e-4 (f32 convolutions sum in XLA's and
  ATen's orders), as `test_torch_port_modules.py`.
- RPN int8 eval (f32 activations, the JAX package's calibrated scales
  carried over): the quantized units' int8 codes equal in all but 1e-4 of
  their elements (an entry conv's f32 sums in the two orders can move a
  value across a rounding edge, by one code), the output within 1e-3 of
  its max |value|. The JAX side compiles without XLA's fusion pass
  (`test_torch_port_int8.py::jit_nofma`) and its BN variances make rsqrt
  exact (`int8_variables`).
- RPN training: outputs and running statistics rtol = atol = 1e-4; every
  parameter's gradient within 1e-3 of JAX's in norm (the
  `test_torch_port_train_step.py` leaf tolerance).
- GroupNorm: rtol = atol = 1e-5 (f32 sums in two orders); inactive sites
  exactly 0.
- the NMS audit: keep sets and flags equal (0/1 matvecs, exact).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillarnet_lts_tpu.models.necks.rpn import RPN as JRPN
from pillarnet_lts_tpu.models.utils.norm import (
    MaskedBatchNorm as JMaskedBatchNorm,
    MaskedGroupNorm as JMaskedGroupNorm,
    build_norm as jbuild_norm,
    get_norm_kwargs as jget_norm_kwargs,
)
from pillarnet_lts_tpu.ops.nms import (
    greedy_suppress_with_convergence as jgreedy_conv,
)
from pillarnet_lts_torch.apis import build_model_from_cfg, load_config
from pillarnet_lts_torch.models.backbones import base as tbase
from pillarnet_lts_torch.models.necks.rpn import RPN
from pillarnet_lts_torch.models.registry import NECKS
from pillarnet_lts_torch.models.utils import (MaskedBatchNorm,
                                              MaskedGroupNorm, build_norm,
                                              get_norm_kwargs, init_weights)
from pillarnet_lts_torch.ops import quant
from pillarnet_lts_torch.ops.nms import greedy_suppress_with_convergence
from pillarnet_lts_torch.runtime.convert import load_jax_variables
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_torch_port_int8 import int8_variables, jit_nofma
from test_torch_port_modules import random_variables

# CenterPoint's PointPillars neck widths (the smoke's 24e override),
# narrowed 4x in depth and width for the CPU: two stages at strides 1 and
# 2, up strides 1 and 2 (the stride-1 up path is a 1x1 conv)
RPN_KW = dict(layer_nums=[2, 1], ds_layer_strides=[1, 2],
              ds_num_filters=[32, 64], us_layer_strides=[1, 2],
              us_num_filters=[32, 32], in_channels=32)
SHAPES = {"conv4": (2, 16, 16, 24), "conv5": (2, 8, 8, 32)}


def _feats(seed):
    rng = np.random.RandomState(seed)
    return {k: np.abs(rng.randn(*s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _port_feats(feats):
    return {k: (torch.from_numpy(v).permute(0, 3, 1, 2).contiguous(), None)
            for k, v in feats.items()}


def _port_rpn(quant_=False, **kw):
    return RPN(**{**RPN_KW, **kw}, quant=quant_,
               backbone_channels={k: s[-1] for k, s in SHAPES.items()})


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_rpn_is_registered_and_reads_the_last_backbone_key():
    assert NECKS.get("RPN") is RPN
    feats = _feats(0)
    tm = init_weights(_port_rpn(), 0).eval()
    with torch.inference_mode():
        (out,) = tm(_port_feats(feats))
        (alone,) = tm(_port_feats(feats)["conv5"])
    # conv5 (8 x 8) is read: stage 0 keeps it, stage 1 halves and doubles
    assert out.shape == (2, 64, 8, 8) and tm.out_channels == (64,)
    assert torch.equal(out, alone) and bool(torch.isfinite(out).all())
    for bad in (dict(us_layer_strides=[1, 0.5]),
                dict(ds_layer_strides=[1])):
        with pytest.raises(ValueError):
            _port_rpn(**bad)


def test_legacy_rpn_eval_matches_flax():
    feats = _feats(1)
    jm = JRPN(**RPN_KW)
    jfeats = {k: (jnp.asarray(v), None) for k, v in feats.items()}
    variables = random_variables(jm, 2, jfeats, train=False)
    (want,) = jax.jit(lambda v, f: jm.apply(v, f, train=False))(variables,
                                                                jfeats)
    tm = load_jax_variables(_port_rpn().eval(), variables)
    with torch.inference_mode():
        (got,) = tm(_port_feats(feats))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # every flax leaf consumed: the entry convs, BNs, units and up paths
    names = set(variables["params"])
    assert {"block0_conv0", "block0_bn0", "block0_conv2", "block1_conv1",
            "deblock0", "deblock0_bn", "deblock1", "deblock1_bn"} <= names
    assert variables["params"]["deblock0"]["kernel"].shape == (1, 1, 32, 32)
    assert variables["params"]["deblock1"]["kernel"].shape == (2, 2, 64, 32)


def _recording_int8(calls):
    real = tbase.int8_conv_bn_act

    def rec(x, w_q, inv_s, *a, **k):
        calls.append(quant.quantize(x, inv_s).numpy())
        return real(x, w_q, inv_s, *a, **k)
    return rec


def test_legacy_rpn_int8_matches_jax():
    """f32 activations, the units on K4's f32 variant (its plain version
    here) with the JAX package's calibrated per-tensor scales."""
    from pillarnet_lts_tpu.models.backbones import base as jbase

    feats = _feats(3)
    jm = JRPN(**RPN_KW, quant=True)
    jfeats = {k: (jnp.asarray(v), None) for k, v in feats.items()}
    variables = int8_variables(jm, 4, jfeats, train=False)
    variables.pop("quant", None)
    _, calib = jax.jit(lambda v, f: jm.apply(
        v, f, train=False, mutable=["quant"]))(variables, jfeats)
    variables["quant"] = jax.tree_util.tree_map(np.asarray, calib["quant"])
    # the quantized units of the two stages: 2 + 1
    assert len(jax.tree_util.tree_leaves(variables["quant"])) == 3

    jcodes = []
    real = jbase.conv_core_int8

    def spy(xq, wq, *a):
        jcodes.append(xq)
        return real(xq, wq, *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbase, "conv_core_int8", spy)
        want, codes = jit_nofma(
            lambda v, f: (jm.apply(v, f, train=False)[0], list(jcodes)),
            variables, jfeats)

    tm = load_jax_variables(_port_rpn(quant_=True).eval(), variables)
    assert all(m.quant_ready() for m in tm.modules()
               if getattr(m, "quant", False))
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbase, "int8_conv_bn_act", _recording_int8(calls))
        with torch.inference_mode():
            (got,) = tm(_port_feats(feats))
    assert len(calls) == len(codes) == 3
    for g, w in zip(calls, codes):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.mean(g != w) <= 1e-4 and np.abs(
            g.astype(int) - w.astype(int)).max() <= 1
    want = np.asarray(want)
    np.testing.assert_allclose(_nhwc(got), want, rtol=0,
                               atol=1e-3 * np.abs(want).max())


def test_legacy_rpn_training_matches_flax():
    feats = _feats(5)
    jm = JRPN(**RPN_KW)
    jfeats = {k: (jnp.asarray(v), None) for k, v in feats.items()}
    variables = random_variables(jm, 6, jfeats, train=False)
    rng = np.random.RandomState(7)
    cot = rng.randn(2, 8, 8, 64).astype(np.float32)

    def loss(params, f):
        (y,), upd = jm.apply({"params": params,
                              "batch_stats": variables["batch_stats"]}, f,
                             train=True, mutable=["batch_stats"])
        return (y * cot).sum(), (y, upd)

    (_, (want, upd)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"], jfeats)

    tm = load_jax_variables(_port_rpn(), variables).train()
    (got,) = tm(_port_feats(feats))
    (got * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    stats = load_jax_variables(
        _port_rpn(), {"params": variables["params"],
                      "batch_stats": jax.tree_util.tree_map(
                          np.asarray, upd["batch_stats"])})
    for (name, b), (_, w) in zip(tm.named_buffers(), stats.named_buffers()):
        torch.testing.assert_close(b, w, rtol=1e-4, atol=1e-4, msg=name)
    want_g = load_jax_variables(
        _port_rpn(), {"params": jax.tree_util.tree_map(np.asarray, grads),
                      "batch_stats": variables["batch_stats"]})
    jg = dict(want_g.named_parameters())
    for name, p in tm.named_parameters():
        ref = jg[name].detach()
        assert float(ref.norm()) > 0, name
        rel = float((p.grad - ref).norm() / ref.norm())
        assert rel <= 1e-3, (name, rel)


def test_pillarnet34_nusc_builds_with_the_legacy_rpn():
    """The smoke's 24e override on the flagship config (meta device): the
    neck reads conv5 (stride 16) and its up paths meet the head's
    stride 8."""
    cfg = load_config("configs/pillarnet/pillarnet34_nusc.py")
    cfg["model"]["neck"] = dict(
        type="RPN", layer_nums=[3, 5, 5], ds_layer_strides=[1, 2, 1],
        ds_num_filters=[64, 128, 256], us_layer_strides=[2, 4, 4],
        us_num_filters=[128, 128, 128], in_channels=256)
    cfg["model"]["bbox_head"]["in_channels"] = [384]
    model = build_model_from_cfg(cfg, device="meta")
    neck = model.neck_net
    assert isinstance(neck, RPN) and neck.out_channels == (384,)
    assert model.head_net.share_conv0.weight.shape[1] == 384
    x = torch.zeros((1, 256, 90, 90), device="meta")
    (out,) = neck({"conv4": (x, None), "conv5": (x, None)})
    assert out.shape == (1, 384, 180, 180)


# ---- GroupNorm and the factory ---------------------------------------------

@pytest.mark.parametrize("layout", ["maps", "maps_masked", "rows_masked"])
def test_masked_group_norm_matches_jax(layout):
    rng = np.random.RandomState(len(layout))
    C, G = 16, 4
    if layout == "rows_masked":
        x = rng.randn(2, 50, C).astype(np.float32) * 2 + 1
        mask = rng.rand(2, 50) > 0.4
    else:
        x = rng.randn(2, 7, 9, C).astype(np.float32) * 2 + 1
        mask = rng.rand(2, 7, 9) > 0.6 if layout == "maps_masked" else None
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.3, C).astype(np.float32)
    jm = JMaskedGroupNorm(C, num_groups=G)
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(
        v, xx, None if mask is None else jnp.asarray(mask)))(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x)))

    tm = load_jax_variables(MaskedGroupNorm(C, num_groups=G),
                            {"params": {"scale": scale, "bias": bias}})
    if layout == "rows_masked":
        tx = torch.from_numpy(x)
        tmask = torch.from_numpy(mask)[..., None]
        got = tm(tx, tmask).detach().numpy()
    else:
        tx = torch.from_numpy(x).permute(0, 3, 1, 2)
        tmask = None if mask is None else \
            torch.from_numpy(mask)[:, None].float()
        got = _nhwc(tm(tx, tmask))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if mask is not None:
        assert not got[~mask].any()
    # eval and training alike (no running statistics)
    assert torch.equal(tm.eval()(tx, tmask), tm.train()(tx, tmask))


def test_masked_group_norm_in_bf16_and_its_divisibility_check():
    rng = np.random.RandomState(9)
    x = rng.randn(1, 8, 5, 6).astype(np.float32)
    tm = MaskedGroupNorm(8, num_groups=2).requires_grad_(False)
    got = tm(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               tm(torch.from_numpy(x).to(torch.bfloat16)
                                  .float()).numpy(), rtol=2 ** -7, atol=0)
    with pytest.raises(ValueError, match="not divisible"):
        MaskedGroupNorm(10, num_groups=4)(torch.zeros(1, 10, 2, 2))
    with pytest.raises(ValueError, match="not divisible"):
        JMaskedGroupNorm(10, num_groups=4).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 2, 2, 10)))


@pytest.mark.parametrize("cfg", [
    None, dict(type="BN"), dict(type="BN1d", momentum=0.05, eps=1e-4),
    dict(type="SyncBN", requires_grad=True), dict(type="GN"),
    dict(type="GN", num_groups=8, eps=1e-6), dict(type="LN"),
], ids=["none", "BN", "BN1d", "SyncBN", "GN", "GN8", "LN"])
def test_build_norm_and_get_norm_kwargs_dispatch_as_jax(cfg):
    if cfg is not None and cfg["type"] == "LN":
        for fn in (build_norm, jbuild_norm):
            with pytest.raises(NotImplementedError, match="LN"):
                fn(copy.deepcopy(cfg), 16)
        for fn in (get_norm_kwargs, jget_norm_kwargs):
            with pytest.raises(NotImplementedError, match="LN"):
                fn(cfg)
        return
    got = build_norm(copy.deepcopy(cfg), 16)
    want = jbuild_norm(copy.deepcopy(cfg), 16)
    if isinstance(want, JMaskedBatchNorm):
        assert isinstance(got, MaskedBatchNorm)
        assert (got.momentum, got.eps) == (want.momentum, want.eps)
        assert get_norm_kwargs(cfg) == jget_norm_kwargs(cfg)
    else:
        assert isinstance(got, MaskedGroupNorm)
        assert (got.num_groups, got.eps) == (want.num_groups, want.eps)
        with pytest.raises(NotImplementedError):
            get_norm_kwargs(cfg)
        with pytest.raises(NotImplementedError):
            jget_norm_kwargs(cfg)
    assert got.weight.shape == (16,)


def test_build_norm_momentum_moves_the_running_statistics():
    """A BN from `build_norm(dict(momentum=m))` updates its running mean by
    m, as the JAX module built by the same config."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 4, 5, 8).astype(np.float32) + 3
    jm = jbuild_norm(dict(type="BN", momentum=0.3), 8)
    v = {"params": {"scale": np.ones(8, np.float32),
                    "bias": np.zeros(8, np.float32)},
         "batch_stats": {"mean": np.zeros(8, np.float32),
                         "var": np.ones(8, np.float32)}}
    _, upd = jm.apply(v, jnp.asarray(x), None, True, mutable=["batch_stats"])
    tm = load_jax_variables(build_norm(dict(type="BN", momentum=0.3), 8), v)
    tm.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tm.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    assert float(tm.running_mean.abs().min()) > 0.5


# ---- the NMS audit -----------------------------------------------------------

def _chain_iou(k, depth):
    """A suppression chain of `depth` links (box i overlaps box i + 1 only)
    among `k` boxes, the rest isolated."""
    iou = np.zeros((k, k), np.float32)
    for i in range(depth):
        iou[i, i + 1] = iou[i + 1, i] = 0.5
    return iou


@pytest.mark.parametrize("depth,sweeps", [(3, 16), (20, 16), (20, 21),
                                          (6, 4)])
def test_greedy_suppress_with_convergence_matches_jax(depth, sweeps):
    """A chain deeper than the sweeps does not converge (the flag says
    so); one within them does, and the keep set is greedy's (every other
    box of the chain)."""
    k = 32
    rng = np.random.RandomState(depth)
    ious = np.stack([_chain_iou(k, depth),
                     _chain_iou(k, depth) * (rng.rand(k, k) > 0.3)])
    valid = np.ones((2, k), bool)
    valid[1, -3:] = False
    keep, conv = greedy_suppress_with_convergence(
        torch.from_numpy(ious), torch.from_numpy(valid), 0.3, sweeps=sweeps)
    for r in range(2):
        jkeep, jconv = jax.jit(lambda i, v: jgreedy_conv(
            i, v, 0.3, sweeps=sweeps))(ious[r], valid[r])
        np.testing.assert_array_equal(keep[r].numpy(), np.asarray(jkeep))
        assert bool(conv[r]) == bool(jconv)
    assert bool(conv[0]) == (depth <= sweeps)
    if depth <= sweeps:
        want = np.ones(k, bool)
        want[1:depth + 1:2] = False
        np.testing.assert_array_equal(keep[0].numpy(), want)
