"""PyTorch port: each model module against its flax counterpart, with the
same weights carried across by `runtime/convert.py::load_jax_variables`.

Weights and inputs are drawn with numpy from fixed seeds; batch statistics
are non-trivial (random means, variances and affines), so a wrong BN fold,
weight layout or ConvTranspose flip shows. The JAX side runs the plain
layout (`s2d_stage1=False, hpack=False, chunk_nc=0`), which the JAX
package's own tests pin equal to its TPU recasts. Tolerance: rtol = atol =
1e-4 (f32 convolutions accumulate in different orders in XLA and ATen).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillarnet_lts_tpu.models.backbones.pillar_resnet import (
    PillarResNet34 as JPillarResNet34,
)
from pillarnet_lts_tpu.models.bbox_heads.center_head import (
    CenterHead as JCenterHead,
)
from pillarnet_lts_tpu.models.necks.rpn import RPNV1 as JRPNV1
from pillarnet_lts_tpu.models.necks.rpn import RPNV2 as JRPNV2
from pillarnet_lts_tpu.models.readers.dynamic_pillar_encoder import (
    DynamicPFE as JDynamicPFE,
)
from pillarnet_lts_torch.models.backbones.pillar_resnet import PillarResNet34
from pillarnet_lts_torch.models.bbox_heads.center_head import CenterHead
from pillarnet_lts_torch.models.necks.rpn import RPNV1, RPNV2
from pillarnet_lts_torch.models.readers.dynamic_pillar_encoder import (
    DynamicPFE,
)
from pillarnet_lts_torch.runtime.convert import load_jax_variables
import test_torch_port_threads  # noqa: F401  (one torch thread)

TOL = dict(rtol=1e-4, atol=1e-4)
PC_RANGE = (-16.0, -16.0, -4.0, 16.0, 16.0, 2.0)


def random_variables(module, seed, *args, **kwargs):
    """numpy variables of a flax module: He-like kernels (1/fan_in), random
    BN affines and batch statistics. Shapes come from an abstract init."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        coll, name = path[0].key, path[-1].key
        if coll == "batch_stats":
            v = (rng.normal(0, 0.2, s.shape) if name == "mean"
                 else rng.uniform(0.5, 2.0, s.shape))
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name == "bias":
            v = rng.normal(0, 0.1, s.shape)
        else:
            v = rng.normal(0, (1.0 / np.prod(s.shape[:-1])) ** 0.5, s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jit_apply(module, variables, *args):
    """Eval forward of a flax module under one `jax.jit` (op-by-op eager
    dispatch costs seconds per test on the CPU)."""
    return jax.jit(functools.partial(module.apply, train=False))(
        variables, *args)


def nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def sparse_grid(seed, B, H, W, C, occupancy=0.15):
    rng = np.random.RandomState(seed)
    occ = rng.rand(B, H, W) < occupancy
    grid = np.abs(rng.randn(B, H, W, C)).astype(np.float32) * occ[..., None]
    return grid, occ


def test_dynamic_pfe_matches_flax():
    rng = np.random.RandomState(0)
    B, N = 2, 3000
    pts = np.zeros((B, N, 5), np.float32)
    pts[..., :2] = rng.uniform(-17, 17, (B, N, 2))
    pts[..., 2] = rng.uniform(-4, 2, (B, N))
    pts[..., 3] = rng.uniform(0, 255, (B, N))
    pts[..., 4] = rng.uniform(0, 0.45, (B, N))
    mask = rng.rand(B, N) > 0.05
    kw = dict(in_channels=5, num_filters=(16,), pillar_size=0.25,
              pc_range=PC_RANGE)
    jm = JDynamicPFE(**kw)
    variables = random_variables(jm, 1, jnp.asarray(pts), jnp.asarray(mask),
                                 train=False)
    want_grid, want_occ = jit_apply(jm, variables, jnp.asarray(pts),
                                    jnp.asarray(mask))

    tm = load_jax_variables(DynamicPFE(**kw).eval(), variables)
    with torch.inference_mode():
        grid, occ = tm(torch.from_numpy(pts), torch.from_numpy(mask))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want_occ))
    np.testing.assert_allclose(grid.numpy(), np.asarray(want_grid), **TOL)
    assert occ.sum() > 100


def test_pillar_resnet34_matches_flax():
    grid, occ = sparse_grid(2, B=2, H=64, W=64, C=8)
    jm = JPillarResNet34(in_channels=8, s2d_stage1=False, hpack=False,
                         chunk_nc=0)
    args = (jnp.asarray(grid), jnp.asarray(occ))
    variables = random_variables(jm, 3, *args, train=False)
    want = jit_apply(jm, variables, *args)

    tm = load_jax_variables(PillarResNet34(in_channels=8).eval(),
                            variables)
    with torch.inference_mode():
        got = tm(torch.from_numpy(grid), torch.from_numpy(occ))
    assert sorted(got) == sorted(want) == [f"conv{i}" for i in range(1, 6)]
    for k, (x, m) in got.items():
        wx, wm = want[k]
        if m is None:
            assert wm is None
        else:
            np.testing.assert_array_equal(m.numpy(), np.asarray(wm))
            # inactive sites are exactly zero between stages
            assert not nhwc(x)[~m.numpy()].any()
        np.testing.assert_allclose(nhwc(x), np.asarray(wx), err_msg=k, **TOL)


@pytest.mark.parametrize("neck", ["RPNV1", "RPNV2"])
def test_rpn_matches_flax(neck):
    rng = np.random.RandomState(4)
    B = 2
    shapes = {"conv3": (B, 16, 16, 24), "conv4": (B, 8, 8, 40),
              "conv5": (B, 4, 4, 40)}
    feats = {k: np.abs(rng.randn(*s)).astype(np.float32)
             for k, s in shapes.items()}
    if neck == "RPNV1":
        kw = dict(layer_nums=[2, 2], num_filters=32, in_channels=[48, 16])
        jm, tcls = JRPNV1(**kw), RPNV1
    else:
        kw = dict(layer_nums=[1, 2], num_filters=32, in_channels=[48, 16])
        jm, tcls = JRPNV2(**kw), RPNV2
    jfeats = {k: (jnp.asarray(v), None) for k, v in feats.items()}
    variables = random_variables(jm, 5, jfeats, train=False)
    (want,) = jit_apply(jm, variables, jfeats)

    tm = load_jax_variables(
        tcls(**kw, backbone_channels={k: s[-1] for k, s in shapes.items()})
        .eval(), variables)
    tfeats = {k: (torch.from_numpy(v).permute(0, 3, 1, 2), None)
              for k, v in feats.items()}
    with torch.inference_mode():
        (got,) = tm(tfeats)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_center_head_matches_flax():
    rng = np.random.RandomState(6)
    x = np.abs(rng.randn(2, 16, 16, 32)).astype(np.float32)
    kw = dict(
        tasks=[dict(stride=4, class_names=["car"]),
               dict(stride=4, class_names=["truck", "bus"]),
               dict(stride=4, class_names=["ped", "cyc", "cone"])],
        in_channels=[32],
        code_weights=[1.0] * 10,
        common_heads={"reg": (2, 2), "height": (1, 2), "dim": (3, 2),
                      "rot": (2, 2), "vel": (2, 2), "iou": (1, 2)},
        share_channel=48,
    )
    jm = JCenterHead(**kw)
    variables = random_variables(jm, 7, (jnp.asarray(x),), train=False)
    want = jit_apply(jm, variables, (jnp.asarray(x),))

    tm = load_jax_variables(CenterHead(**kw).eval(), variables)
    with torch.inference_mode():
        got = tm((torch.from_numpy(x).permute(0, 3, 1, 2),))
    assert len(got) == len(want) == 3
    for t, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for h in g:
            np.testing.assert_allclose(g[h].numpy(), np.asarray(w[h]),
                                       err_msg=f"task{t}/{h}", **TOL)


def _neck_and_variables():
    kw = dict(layer_nums=[1, 1], num_filters=16, in_channels=[16, 8])
    jm = JRPNV1(**kw)
    feats = {"conv4": (jnp.zeros((1, 4, 4, 8)), None),
             "conv5": (jnp.zeros((1, 2, 2, 8)), None)}
    variables = random_variables(jm, 8, feats, train=False)
    tm = RPNV1(**kw, backbone_channels={"conv4": 8, "conv5": 8})
    return tm, jax.tree_util.tree_map(np.asarray, variables)


def test_load_jax_variables_raises_on_missing_leaf():
    tm, variables = _neck_and_variables()
    del variables["batch_stats"]["deblock_5"]["MaskedBatchNorm_0"]["var"]
    with pytest.raises(KeyError, match="deblock_5/MaskedBatchNorm_0/var"):
        load_jax_variables(tm, variables)


def test_load_jax_variables_raises_on_extra_leaf():
    tm, variables = _neck_and_variables()
    variables["params"]["block_4"]["conv1"]["Conv_0"]["bias"] = np.zeros(
        16, np.float32)
    with pytest.raises(KeyError, match="block_4/conv1/Conv_0/bias"):
        load_jax_variables(tm, variables)


def test_load_jax_variables_raises_on_shape_mismatch():
    tm, variables = _neck_and_variables()
    k = variables["params"]["block_5"]["conv0"]["Conv_0"]
    k["kernel"] = k["kernel"][:, :, :4]
    with pytest.raises(ValueError, match="block_5/conv0/Conv_0/kernel"):
        load_jax_variables(tm, variables)
