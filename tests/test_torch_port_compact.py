"""PyTorch port of the compact sparse path against the JAX package (CPU).

`pillarnet_lts_torch/ops/compact.py`, `models/backbones/compact_exec.py`
and their hooks in the reader, the blocks and `PillarResNet` against
`pillarnet_lts_tpu`'s, on the same numpy inputs and weights
(`load_jax_variables`). The port's functions are batched; the JAX ones
run per sample under `jax.vmap`, as their callers run them.

Tolerances: every integer output (site ids, counts, neighbour tables,
coarse sites, occupancies) and the segment-max rows are bit-equal,
truncation by the budget included; the segment-max gradient at exact ties
equal to JAX's within 1e-6 (half-splits at each scan step, exact in
binary, summed in another order); convolutions rtol = atol = 1e-4 (f32
sums in other orders), gradients of a squared-output loss 2e-3 (the JAX
package's own compact-vs-dense bound, `tests/test_compact_backbone.py`);
detections: masks and labels equal, boxes 1e-3 m and scores 1e-4 against
JAX; compact against the port's dense path 5e-3 / 1e-3
(`tests/test_compact_backbone.py:164-172`).
"""

import copy
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillarnet_lts_tpu.models import build_detector as build_jax_detector
from pillarnet_lts_tpu.models.backbones.compact_exec import (
    CompactPillars as JCompactPillars,
)
from pillarnet_lts_tpu.models.backbones.pillar_resnet import (
    PillarResNet18S as JPillarResNet18S,
)
from pillarnet_lts_tpu.ops import compact as jc
from pillarnet_lts_tpu.runtime.quantize import (
    enable_backbone_quant as jax_enable_backbone_quant,
)
from pillarnet_lts_torch.apis import load_config
from pillarnet_lts_torch.models import build_detector
from pillarnet_lts_torch.models.backbones.compact_exec import CompactPillars
from pillarnet_lts_torch.models.backbones.pillar_resnet import PillarResNet18S
from pillarnet_lts_torch.ops import compact as tc
from pillarnet_lts_torch.runtime.convert import (load_jax_variables,
                                                 variables_of)
from pillarnet_lts_torch.runtime.quantize import enable_backbone_quant
from test_torch_port_e2e import spread_both_heads
from test_torch_port_modules import jit_apply, random_variables

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DEMO = os.path.join(ROOT, "configs", "demo", "pillarnet18_demo.py")
TOL = dict(rtol=1e-4, atol=1e-4)


def scene(seed, B=2, H=24, W=20, N=400, C=6, occupancy=0.12, edges=False):
    """(feats, ids, valid) numpy: N points on a random set of sites, a
    tenth invalid; `edges` puts sites on the grid's corners and row ends."""
    rng = np.random.RandomState(seed)
    n_sites = max(1, int(H * W * occupancy))
    feats = rng.randn(B, N, C).astype(np.float32)
    ids = np.zeros((B, N), np.int32)
    for b in range(B):
        sites = rng.choice(H * W, n_sites, replace=False)
        if edges:
            sites[:6] = [0, W - 1, W, H * W - W, H * W - 1, 2 * W - 1]
        ids[b] = sites[rng.randint(0, n_sites, N)]
    valid = rng.rand(B, N) > 0.1
    ids = np.where(valid, ids, H * W).astype(np.int32)
    return feats, ids, valid


def jax_segment_max(feats, ids, valid, hw, kmax):
    return jax.jit(jax.vmap(
        lambda f, i, v: jc.compact_segment_max(f, i, v, hw, kmax)))(
            feats, ids, valid)


def port_segment_max(feats, ids, valid, hw, kmax):
    return tc.compact_segment_max(torch.from_numpy(feats),
                                  torch.from_numpy(ids),
                                  torch.from_numpy(valid), hw, kmax)


def assert_int_equal(got, want, what):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == np.int32 and want.dtype == np.int32, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def test_searchsorted_left_matches_jax():
    rng = np.random.RandomState(0)
    for n in (1, 7, 64, 257):
        table = np.sort(rng.randint(0, 50, (3, n)), axis=1).astype(np.int32)
        table[1, n // 2:] = 500  # a padded tail of equal ids
        q = rng.randint(-5, 510, (3, 333)).astype(np.int32)
        q[:, :3] = [[-1], [500], [501]]
        want = jax.vmap(jc.searchsorted_left)(jnp.asarray(table),
                                              jnp.asarray(q))
        got = tc.searchsorted_left(torch.from_numpy(table),
                                   torch.from_numpy(q))
        assert_int_equal(got, want, f"n={n}")


def test_lookup_ids_and_ranks_match_jax():
    rng = np.random.RandomState(1)
    table = np.sort(rng.choice(200, (2, 40)), axis=1).astype(np.int32)
    for b in range(2):
        table[b] = np.unique(np.concatenate(
            [table[b], rng.choice(200, 60)]))[:40]
    valid_n = np.array([40, 25], np.int32)
    table[1, 25:] = 200  # padding holds an id above every real query
    q = rng.randint(-3, 204, (2, 17, 9)).astype(np.int32)
    want = jax.vmap(lambda t, v, x: jc.lookup_ids(t, v, x, 40))(
        table, valid_n, q)
    got = tc.lookup_ids(torch.from_numpy(table), torch.from_numpy(valid_n),
                        torch.from_numpy(q), 40)
    assert_int_equal(got, want, "lookup_ids")
    flags = rng.rand(2, 50) > 0.6
    assert_int_equal(tc.compact_ranks(torch.from_numpy(flags)),
                     jax.vmap(jc.compact_ranks)(flags), "compact_ranks")


# (name, scene kwargs) on an odd 23 x 19 grid (the coarse grid floors to
# 11 x 9) at budgets of 128 fine and 80 coarse sites: every site fits
# (and the second frame is empty), the fine table truncates (~135 sites),
# the coarse table truncates (~105 fine, ~89 coarse), sites on the grid's
# edges, four sites holding every point
TH, TW, KMAX, K2MAX = 23, 19, 128, 80
CASES = [
    ("fits", dict(seed=0)),
    ("fine_truncates", dict(seed=1, occupancy=0.35)),
    ("coarse_truncates", dict(seed=2, occupancy=0.25)),
    ("edges", dict(seed=3, edges=True)),
    ("few_sites", dict(seed=4, occupancy=0.01)),
]


def port_tables(site_ids, k, H, W, kmax, k2max):
    """Every integer table of the compact path (nbr1, ids2, k2, nbr_down,
    nbr2), as `PillarResNet._forward_compact` builds them."""
    nbr1 = tc.subm_neighbor_table(site_ids, k, H, W, kmax)
    ids2, k2 = tc.downsample_site_ids(site_ids, k, H, W, k2max)
    nbr_down = tc.down_conv_neighbor_table(ids2, k2, site_ids, k, H, W, kmax)
    nbr2 = tc.subm_neighbor_table(ids2, k2, H // 2, W // 2, k2max)
    return nbr1, ids2, k2, nbr_down, nbr2


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6))
def jax_tables(rows, site_ids, k, H, W, kmax, k2max):
    """The same tables and the densified rows by the JAX package, vmapped
    over the batch as its backbone does (one compile)."""
    def one(r, s, kk):
        ids2, k2 = jc.downsample_site_ids(s, kk, H, W, k2max)
        return (jc.subm_neighbor_table(s, kk, H, W, kmax), ids2, k2,
                jc.down_conv_neighbor_table(ids2, k2, s, kk, H, W, kmax),
                jc.subm_neighbor_table(ids2, k2, H // 2, W // 2, k2max),
                jc.compact_to_dense(r, s, kk, H, W))
    return jax.vmap(one)(rows, site_ids, k)


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_compact_tables_bit_equal_jax(name, kw):
    H, W, kmax, k2max = TH, TW, KMAX, K2MAX
    feats, ids, valid = scene(H=H, W=W, **kw)
    if name == "fits":  # the second frame empty: every point invalid
        valid[1] = False
        ids[1] = H * W
    jrows, jsites, jk = jax_segment_max(feats, ids, valid, H * W, kmax)
    rows, sites, k = port_segment_max(feats, ids, valid, H * W, kmax)
    assert_int_equal(sites, jsites, "site_ids")
    assert_int_equal(k, jk, "k_valid")
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    if name == "fine_truncates":
        assert (k == kmax).all()
    if name == "fits":
        assert int(k[1]) == 0 and (sites[1] == H * W).all()
    assert not rows.numpy()[np.arange(kmax + 1)[None] >= k.numpy()[:, None]
                            ].any()

    *want, (jgrid, jocc) = jax_tables(jrows, jsites, jk, H, W, kmax, k2max)
    got = port_tables(sites, k, H, W, kmax, k2max)
    for what, g, w in zip(("nbr1", "ids2", "k2", "nbr_down", "nbr2"),
                          got, want):
        assert_int_equal(g, w, what)
    if name == "coarse_truncates":
        assert (got[2] == k2max).all()

    grid, occ = tc.compact_to_dense(rows, sites, k, H, W)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jgrid))


def _readers(idx, k_rows, valid_out):
    """{row: sorted entries i * 9 + d of idx that read it}, from the valid
    output rows alone."""
    out = {}
    for i in range(idx.shape[0]):
        if valid_out[i]:
            for d in range(9):
                if idx[i, d] < k_rows:
                    out.setdefault(int(idx[i, d]), []).append(i * 9 + d)
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_reverse_tables_list_every_reader(name, kw):
    """`subm_reverse` and `down_conv_reverse` list, for every valid row,
    exactly the entries of the valid output rows that read it; other rows
    none (padding rows read nothing that carries a gradient)."""
    H, W = TH, TW
    feats, ids, valid = scene(H=H, W=W, **kw)
    _, sites, k = port_segment_max(feats, ids, valid, H * W, KMAX)
    nbr1, ids2, k2, nbr_down, nbr2 = port_tables(sites, k, H, W, KMAX, K2MAX)
    revs = ((nbr1, tc.subm_reverse(nbr1, k), k, k, KMAX),
            (nbr_down, tc.down_conv_reverse(sites, k, ids2, k2, H, W, K2MAX),
             k, k2, K2MAX),
            (nbr2, tc.subm_reverse(nbr2, k2), k2, k2, K2MAX))
    for idx, rev, k_in, k_out, ko in revs:
        for b in range(2):
            want = _readers(idx[b].numpy(), int(k_in[b]),
                            np.arange(ko) < int(k_out[b]))
            got = {j: sorted(int(e) for e in rev[b, j] if e < ko * 9)
                   for j in range(rev.shape[1])}
            assert {j: v for j, v in got.items() if v} == want


def test_reverse_gathers_match_autograds_index_put():
    """The gradients through the reverse tables (`gather_rows`) equal
    autograd's own backward of the index (`index_put_` with accumulate)
    within f32 summation order, through the whole pillarnet18_demo reader
    and backbone in training, both budgets truncating; the conv biases
    that a BN follows carry rounding noise only and are left out."""
    from pillarnet_lts_torch.apis import build_model_from_cfg
    from pillarnet_lts_torch.runtime.train_step import bn_shifted_biases

    cfg = load_config(DEMO)
    cfg["model"]["reader"]["compact_kmax"] = 800
    pts, msk = _demo_cloud(2)
    pts[:, 500:520] = pts[:, 480:500]  # exact ties in the segment max
    pts, msk = torch.from_numpy(pts), torch.from_numpy(msk)
    model = build_model_from_cfg(cfg, device="cpu").train()
    state = copy.deepcopy(model.state_dict())

    def grads():
        model.load_state_dict(state)
        model.zero_grad()
        feats = model.backbone_net(*model.reader_net(pts, msk))
        sum((x * x).sum() for x, _ in feats.values()).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()
                if p.grad is not None}

    got = grads()
    real = tc.gather_rows
    tc.gather_rows = lambda rows, idx, rev=None: tc._take(rows, idx)
    try:
        want = grads()
    finally:
        tc.gather_rows = real
    shifted = set(bn_shifted_biases(model))
    assert sorted(got) == sorted(want) and len(want) > 40
    for n, w in want.items():
        if n not in shifted:
            assert float((got[n] - w).norm() / w.norm()) < 1e-5, n


def test_gather_conv_matches_jax():
    H, W, Cin, Cout, kmax = 24, 20, 6, 8, 128
    rng = np.random.RandomState(3)
    kernel = rng.randn(3, 3, Cin, Cout).astype(np.float32) * 0.2
    bias = rng.randn(Cout).astype(np.float32)
    feats, ids, valid = scene(5, C=Cin)
    rows, sites, k = port_segment_max(feats, ids, valid, H * W, kmax)
    nbr = tc.subm_neighbor_table(sites, k, H, W, kmax)
    w2 = kernel.reshape(9 * Cin, Cout)
    want = jax.vmap(lambda r, n: jc.gather_conv(r, n, w2, bias))(
        rows.numpy(), nbr.numpy())
    got = tc.gather_conv(rows, nbr, torch.from_numpy(w2),
                         torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_segment_max_gradient_at_ties_matches_jax():
    """Points duplicated onto others (exact ties, up to 6 equal points in
    a pillar): the gradient JAX's scan gives, split in half at every step
    where two equal values meet, not shared evenly."""
    H, W, N, C, kmax = 16, 16, 300, 4, 64
    feats, ids, valid = scene(6, H=H, W=W, N=N, C=C, occupancy=0.1)
    valid[:] = True
    ids = np.where(ids == H * W, 7, ids).astype(np.int32)
    rng = np.random.RandomState(7)
    for b in range(2):
        for src in rng.choice(N, 40, replace=False):
            dst = rng.choice(N, rng.randint(1, 6), replace=False)
            feats[b, dst] = feats[b, src]
            ids[b, dst] = ids[b, src]
    valid[:, :10] = False
    ct = rng.randn(2, kmax + 1, C).astype(np.float32)

    def jloss(f):
        rows, _, _ = jax.vmap(lambda a, i, v: jc.compact_segment_max(
            a, i, v, H * W, kmax))(f, ids, valid)
        return jnp.sum(rows * ct)

    want = jax.jit(jax.grad(jloss))(feats)
    f = torch.from_numpy(feats).requires_grad_()
    rows, _, _ = tc.compact_segment_max(f, torch.from_numpy(ids),
                                        torch.from_numpy(valid), H * W, kmax)
    (rows * torch.from_numpy(ct)).sum().backward()
    got = f.grad.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    # ties were met: some point takes a half (or quarter) share
    share = np.abs(got).sum(-1)
    assert ((share > 0) & (np.abs(want).sum(-1) > 0)).sum() > 40
    assert not got[:, :10].any()


# the backbone: the shapes of tests/test_compact_backbone.py
BH = BW = 32
BC = 8
BKMAX = 160


def _backbone_inputs(seed):
    feats, ids, valid = scene(seed, B=2, H=BH, W=BW, N=300, C=BC,
                              occupancy=60 / (BH * BW))
    rows, sites, k = jax_segment_max(feats, ids, valid, BH * BW, BKMAX)
    jcp = JCompactPillars(rows=rows[:, :BKMAX], site_ids=sites, k_valid=k,
                          height=BH, width=BW)
    tcp = CompactPillars(*(torch.from_numpy(np.array(a)) for a in (
        rows[:, :BKMAX], sites, k)), BH, BW)
    grid = np.zeros((2, BH * BW + 1, BC), np.float32)  # for init's shapes
    return jcp, tcp, grid[:, :-1].reshape(2, BH, BW, BC)


def _backbones(seed):
    jm = JPillarResNet18S(in_channels=BC, s2d_stage1=False, hpack=False,
                          chunk_nc=0, compact_kmax2=256)
    jcp, tcp, grid = _backbone_inputs(seed)
    variables = random_variables(jm, seed + 10, jnp.asarray(grid),
                                 jnp.asarray(grid[..., 0] > 0), train=False)
    tm = load_jax_variables(
        PillarResNet18S(in_channels=BC, compact_kmax2=256).eval(), variables)
    return jm, tm, variables, jcp, tcp


def _assert_outputs(got, want):
    assert sorted(got) == sorted(want)
    for key, (x, m) in got.items():
        wx, wm = want[key]
        np.testing.assert_array_equal(m.numpy(), np.asarray(wm),
                                      err_msg=key)
        np.testing.assert_allclose(x.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(wx), err_msg=key, **TOL)
        assert not x.detach().permute(0, 2, 3, 1).numpy()[~m.numpy()].any()


def test_compact_backbone_eval_matches_jax():
    jm, tm, variables, jcp, tcp = _backbones(0)
    want = jax.jit(lambda v, cp: jm.apply(v, cp, None, train=False))(
        variables, jcp)
    with torch.inference_mode():
        got = tm(tcp, None)
    _assert_outputs(got, want)
    for key in ("conv1", "conv2"):  # the densified maps' layout (f32)
        assert got[key][0].is_contiguous()


def test_compact_backbone_train_matches_jax():
    """Training: outputs, BN running statistics and the gradients of a
    squared-output loss."""
    jm, tm, variables, jcp, tcp = _backbones(1)

    def jloss(params):
        out, mut = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            jcp, None, train=True, mutable=["batch_stats"])
        return sum(jnp.sum(x * x) for x, _ in out.values()), (out, mut)

    (_, (want, jmut)), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    tm.train()
    got = tm(tcp, None)
    sum((x * x).sum() for x, _ in got.values()).backward()
    _assert_outputs(got, want)

    tvars = variables_of(tm)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, np.asarray(b), **TOL),
        tvars["batch_stats"], jax.tree_util.tree_map(np.asarray,
                                                     jmut["batch_stats"]))
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(p.grad)
    grads = variables_of(tm)["params"]
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=2e-3,
                                                atol=2e-3),
        grads, jax.tree_util.tree_map(np.asarray, jgrads))


def _demo_cloud(seed=0, B=2, N=1024):
    """tests/test_compact_backbone.py's detector input."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((B, N, 5), np.float32)
    pts[..., 0] = rng.uniform(-15, 15, (B, N))
    pts[..., 1] = rng.uniform(-15, 15, (B, N))
    pts[..., 2] = rng.uniform(-2, 1, (B, N))
    pts[..., 3] = rng.uniform(0, 255, (B, N))
    return pts, rng.rand(B, N) > 0.05


def _detections(port, pts, msk):
    with torch.inference_mode():
        return port.predict({}, port(torch.from_numpy(pts),
                                     torch.from_numpy(msk)))


def _assert_same_detections(got, want, box_tol, score_tol):
    m = np.asarray(want["mask"])
    np.testing.assert_array_equal(got["mask"].numpy(), m)
    assert m.sum() > 0
    np.testing.assert_array_equal(got["label_preds"].numpy()[m],
                                  np.asarray(want["label_preds"])[m])
    np.testing.assert_allclose(got["box3d_lidar"].numpy()[m],
                               np.asarray(want["box3d_lidar"])[m],
                               atol=box_tol, rtol=0)
    np.testing.assert_allclose(got["scores"].numpy()[m],
                               np.asarray(want["scores"])[m], atol=score_tol,
                               rtol=0)


def test_demo_detector_compact_matches_jax_and_the_dense_path():
    """pillarnet18_demo with compact_kmax=1024: the port's compact path
    against the JAX package's (the default conv2 budget, 640 coarse
    sites, truncates both the same way), then, with compact_kmax2=1024
    (no truncation), against the port's dense path from the same
    weights."""
    cfg = load_config(DEMO)
    mcfg, tcfg = cfg["model"], cfg["test_cfg"]
    mcfg["reader"]["compact_kmax"] = 1024
    pts, msk = _demo_cloud()
    jmodel = build_jax_detector(copy.deepcopy(mcfg), test_cfg=tcfg)
    dense = copy.deepcopy(mcfg)
    del dense["reader"]["compact_kmax"]
    # one parameter tree for both paths; the dense init traces faster
    variables = random_variables(
        build_jax_detector(copy.deepcopy(dense), test_cfg=tcfg), 21,
        jnp.asarray(pts), jnp.asarray(msk), train=False)
    variables = jax.tree_util.tree_map(np.array, variables)
    port = build_detector(copy.deepcopy(mcfg), test_cfg=tcfg)
    spread_both_heads(port, variables, torch.from_numpy(pts),
                      torch.from_numpy(msk))
    jpreds = jit_apply(jmodel, variables, jnp.asarray(pts), jnp.asarray(msk))
    jdet = jax.jit(lambda p: jmodel.predict(
        {}, p, jmodel.processed_test_cfg()))(jpreds)
    with torch.inference_mode():
        cp, _ = port.reader_net(torch.from_numpy(pts),
                                torch.from_numpy(msk))
    ids2, k2 = tc.downsample_site_ids(cp.site_ids, cp.k_valid, cp.height,
                                      cp.width, 4096)
    assert (k2 > 640).all()  # the default budget truncates
    _assert_same_detections(_detections(port, pts, msk), jdet, 1e-3, 1e-4)

    compact = copy.deepcopy(mcfg)
    compact["backbone"]["compact_kmax2"] = 1024
    want = _detections(load_jax_variables(
        build_detector(dense, test_cfg=tcfg), variables), pts, msk)
    got = _detections(load_jax_variables(
        build_detector(compact, test_cfg=tcfg), variables), pts, msk)
    _assert_same_detections(got, want, 5e-3, 1e-3)


def test_int8_with_compact_raises_as_in_jax():
    cfg = load_config(DEMO)
    mcfg = cfg["model"]
    mcfg["reader"]["compact_kmax"] = 1024
    pts, msk = _demo_cloud(1, B=1, N=256)
    jcfg = copy.deepcopy(mcfg)
    jax_enable_backbone_quant(jcfg)
    jmodel = build_jax_detector(jcfg, test_cfg=cfg["test_cfg"])
    with pytest.raises(NotImplementedError, match="compact_kmax=0"):
        jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(msk),
            train=False))
    enable_backbone_quant(mcfg)
    port = build_detector(mcfg, test_cfg=cfg["test_cfg"])
    with pytest.raises(NotImplementedError, match="compact_kmax=0"):
        with torch.inference_mode():
            port(torch.from_numpy(pts), torch.from_numpy(msk))


def _configs(prefix):
    d = os.path.join(ROOT, "configs", prefix)
    return sorted(os.path.join(prefix, f) for f in os.listdir(d)
                  if f.endswith(".py"))


@pytest.mark.parametrize("path", _configs("pillarnet") + _configs("pillarrcnn"))
def test_every_pillarnet_config_builds_with_compact(path):
    """`reader.compact_kmax` = the config's max_points on every PillarNet
    and PillarRCNN config: the reader and backbone take the keys (the
    two-stage model through `single_det`)."""
    cfg = load_config(os.path.join(ROOT, "configs", path))
    kmax = int(cfg["data"]["max_points"])
    mcfg = copy.deepcopy(cfg["model"])
    inner = mcfg.get("first_stage_cfg", mcfg)
    inner["reader"]["compact_kmax"] = kmax
    inner["backbone"]["compact_kmax2"] = 8 * (kmax // 16)
    with torch.device("meta"):
        model = build_detector(mcfg, test_cfg=cfg["test_cfg"], device="meta")
    det = getattr(model, "single_det", model)
    assert det.reader_net.compact_kmax == kmax
    assert det.backbone_net.compact_kmax2 == 8 * (kmax // 16)
