"""PyTorch port, spatial (BEV-grid) sharding over `torch.distributed`
(`pillarnet_lts_torch/parallel/spatial.py`, `models/backbones/band_exec.py`,
the detector's `spatial_axis`), on the CPU.

The ranks are gloo processes with torchrun's environment, spawned once per
module for 2 and for 4 ranks (`chip_smoke.run_spatial` ->
`chip_smoke.spatial_rank`, one intra-op thread each); each holds the whole
model and the same points and runs the jobs of `chip_smoke.sp_job` on the
model with `spatial_axis` set. The same jobs run here in one process on
the unsharded port (`chip_smoke.sp_run`), and the JAX package runs in this
process on the 8 host devices (`tests/conftest.py`), with a mesh as large
as the ranks' world.

Tolerances and why:
- the collectives alone (`sharded_conv3x3`, `sharded_subm_conv3x3`) against
  the JAX package's `make_spatial_conv`: 1e-4, `tests/test_spatial_sharding.
  py`'s; inactive sites exactly 0; an uneven last band (62 rows), the
  halo's and the gather's gradients, a stride-2 stage in eval (bit-equal)
  and training (1e-5: the BN sums add the bands' partial sums) against the
  unsharded port;
- the f32 demo served over 2 and 4 ranks against the unsharded port: head
  outputs within 1e-5 of their largest |value| (the CPU's conv picks its
  accumulation order by the map's extent: a band's 32 x 18 conv2 map sums
  otherwise than the whole 32 x 32 one, measured ~1e-6 relative), the kept
  detections within 1e-3 m / 1e-4 (phase 14e's); against the JAX package's
  unsharded forward within rtol 1e-3 / atol 5e-3
  (`test_spatial_sharding.py:114-120`), and its sharded one (slow);
- the int8 demo (bf16, K4's plain version; and with the fused stage K5):
  the gathered conv1 and conv2 maps and the detections bit-equal to one
  process (integer convs), the scales the ranks calibrate under the group
  equal to one process's;
- one training step over 2 ranks against the one-process step: losses
  within 1e-5, gradients by module group within phase 19's bound (max(2 x
  the one process's own spread under a 1e-6 weight nudge, 1e-3), at most
  0.1), running statistics within 1e-4; only the sharded stages' norms sum
  over the group and only the reader's, conv1's and conv2's gradients;
- the two-stage demo served over 2 ranks: phase 14e's tolerances.
"""

import copy
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pillarnet_lts_tpu.models import build_detector as build_jax_detector
from pillarnet_lts_tpu.parallel.spatial import make_spatial_conv
from pillarnet_lts_torch.apis import build_model_from_cfg, load_config
from pillarnet_lts_torch.datasets import SynthDataset, collate_batch
from pillarnet_lts_torch.models import build_detector
from pillarnet_lts_torch.models.utils.norm import MaskedBatchNorm
from pillarnet_lts_torch.parallel.spatial import row_bands
from pillarnet_lts_torch.runtime.convert import variables_of

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
import test_torch_port_threads  # noqa: F401, E402  (one torch thread)
from test_torch_port_modules import jit_apply  # noqa: E402

POINTS = 4096
CPU = torch.device("cpu")
K5_EDIT = {"dtype": "bfloat16", "reader": {"num_filters": (32,)},
           "backbone": {"in_channels": 32, "s2d_pallas": True}}


def _jobs(tmp):
    """The module's jobs and their inputs, written under `tmp`: 2 clouds
    of the demo, weights with spread heads (the int8 ones calibrated in
    one process), a 2-frame training batch."""
    cfg = load_config(cs.DEMO)
    clouds = cs.sp_clouds(cfg, 2, POINTS, 250)
    path = os.path.join(tmp, "clouds.pt")
    torch.save(clouds, path)

    def at(name):
        return os.path.join(tmp, name)

    jobs = [
        cs.sp_job("f32", "serve", cs.DEMO, clouds=path, weights=at("f32.pt")),
        cs.sp_job("int8", "serve", cs.DEMO, clouds=path, int8=True,
                  weights=at("int8.pt"), calibrate=True, conv12=True,
                  edit={"dtype": "bfloat16"}),
        cs.sp_job("int8_k5", "serve", cs.DEMO, clouds=path, int8=True,
                  weights=at("k5.pt"), calibrate=True, conv12=True,
                  edit=K5_EDIT),
        cs.sp_job("train", "train", cs.DEMO, weights=at("f32.pt"),
                  batch=at("batch.pkl")),
        cs.sp_job("rcnn", "serve", cs.RCNN_DEMO, clouds=path,
                  weights=at("rcnn.pt")),
    ]
    for job in jobs:
        if job["kind"] == "serve":
            cs.sp_weights(torch, job, CPU, clouds, job["weights"])
    ds = SynthDataset(cfg, 2, POINTS, seed=260, num_boxes=(10, 21))
    with open(jobs[3]["batch"], "wb") as f:
        pickle.dump(collate_batch([ds[0], ds[1]], POINTS), f)
    return jobs


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("spatial"))
    jobs = {j["name"]: j for j in _jobs(tmp)}
    one = {name: cs.sp_run(torch, job, CPU) for name, job in jobs.items()}
    spread = cs.sp_spread(torch, jobs["train"], CPU, one["train"], 2,
                          os.path.join(tmp, "nudged.pt"))
    return tmp, jobs, one, spread


def _ranks(prepared, world, names):
    tmp, jobs, _, _ = prepared
    spec = cs.sp_spec("cpu", "gloo", os.path.join(tmp, f"world{world}"),
                      [jobs[n] for n in names], threads=1, ops=True)
    ranks, _ = cs.run_spatial(spec, f"spatial x{world}", world=world,
                              timeout=300)
    return ranks


@pytest.fixture(scope="module")
def ranks2(prepared):
    return _ranks(prepared, 2, list(prepared[1]))


@pytest.fixture(scope="module")
def ranks4(prepared):
    return _ranks(prepared, 4, ["f32"])


@pytest.fixture(params=[2, 4])
def ranks(request):
    return request.getfixturevalue(f"ranks{request.param}")


# ---- the bands --------------------------------------------------------------


@pytest.mark.parametrize("height, world, want", [
    (64, 2, [(0, 32), (32, 64)]),
    (64, 4, [(0, 16), (16, 32), (32, 48), (48, 64)]),
    (62, 4, [(0, 16), (16, 32), (32, 48), (48, 62)]),
    (1440, 2, [(0, 720), (720, 1440)]),
    (1504, 4, [(0, 376), (376, 752), (752, 1128), (1128, 1504)]),
    (9, 2, [(0, 6), (6, 9)]),
])
def test_row_bands_split_at_even_rows(height, world, want):
    assert row_bands(height, world) == want
    assert all(start % 2 == 0 for start, _ in want)


def test_row_bands_without_a_split_raise():
    with pytest.raises(ValueError, match="do not split"):
        row_bands(6, 4)


# ---- the collectives alone --------------------------------------------------


def test_sharded_convs_match_jax(ranks):
    """`sharded_conv3x3` and `sharded_subm_conv3x3` on every rank's band,
    gathered, against `make_spatial_conv` over a JAX mesh of the ranks'
    world, on `tests/test_spatial_sharding.py`'s shapes and seeds."""
    world = len(ranks)
    mesh = Mesh(np.array(jax.devices()[:world]), ("sp",))
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 32, 8).astype(np.float32)
    k = (rng.randn(3, 3, 8, 16) * 0.1).astype(np.float32)
    want = make_spatial_conv(mesh, jnp.asarray(k))(jax.device_put(
        jnp.asarray(x), NamedSharding(mesh, P(None, "sp", None, None))))
    rng = np.random.RandomState(1)
    mask = rng.rand(1, 64, 32) > 0.6
    xm = (rng.randn(1, 64, 32, 4) * mask[..., None]).astype(np.float32)
    km = (rng.randn(3, 3, 4, 4) * 0.1).astype(np.float32)
    want_m = make_spatial_conv(mesh, jnp.asarray(km), masked=True)(
        jax.device_put(jnp.asarray(xm),
                       NamedSharding(mesh, P(None, "sp", None, None))),
        jax.device_put(jnp.asarray(mask),
                       NamedSharding(mesh, P(None, "sp", None))))
    for rk in ranks:
        np.testing.assert_allclose(rk["ops"]["conv"], np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
        got = rk["ops"]["subm"]
        np.testing.assert_allclose(got, np.asarray(want_m), rtol=1e-4,
                                   atol=1e-4)
        assert np.all(got[~mask] == 0.0)


def test_uneven_band_and_down_stage_match_unsharded(ranks):
    """62 rows over the ranks (the last band shorter): the SubM conv and
    its input's gradient through the halo's and the gather's backward, a
    2-row halo exchange, and a stride-2 `SparseDownStage` in eval
    (bit-equal) and in training (BN statistics over the group) against
    the unsharded port."""
    import torch.nn.functional as F

    from pillarnet_lts_torch.models.backbones.base import SparseDownStage
    from pillarnet_lts_torch.models.utils import init_weights

    g = torch.Generator().manual_seed(7)
    H = 62
    occ = torch.rand(2, H, 20, generator=g) > 0.7
    x = torch.randn(2, 8, H, 20, generator=g) * occ[:, None]
    w = torch.randn(8, 8, 3, 3, generator=g) * 0.1
    R = torch.randn(2, 8, H, 20, generator=g)
    xx = x.clone().requires_grad_(True)
    y = F.conv2d(xx, w, padding=1) * occ[:, None]
    (y * R).sum().backward()
    bands = row_bands(H, len(ranks))
    for rk in ranks:
        u = rk["ops"]["uneven"]
        assert torch.equal(u["y"], y.detach())
        torch.testing.assert_close(u["grad"], xx.grad, rtol=1e-6, atol=1e-6)
        assert torch.equal(u["halo2"], x)
        start, stop = bands[rk["rank"]]
        want = F.pad(x, (0, 0, 2, 2))[:, :, start:stop + 4]
        assert torch.equal(u["halo2_rows"], want)
    for mode in ("eval", "train"):
        stage = init_weights(SparseDownStage(8, 16, 1), 11)
        stage.train(mode == "train")
        xx = x.clone().requires_grad_(True)
        y, m2 = stage(xx, occ)
        (y * F.avg_pool2d(R, 2, ceil_mode=True).repeat(1, 2, 1, 1)
         ).sum().backward()
        tol = 0.0 if mode == "eval" else 1e-5
        for rk in ranks:
            o = rk["ops"][f"down_{mode}"]
            assert torch.equal(o["occ"], m2)
            torch.testing.assert_close(o["y"], y.detach(), rtol=tol, atol=tol)
            torch.testing.assert_close(o["grad"], xx.grad, rtol=1e-5,
                                       atol=1e-5)
            for k, v in stage.state_dict().items():
                if "running" in k:
                    torch.testing.assert_close(o["stats"][k], v, rtol=1e-6,
                                               atol=1e-6)


# ---- the demo served --------------------------------------------------------


def _jax_demo(spatial_axis=None):
    cfg = load_config(cs.DEMO)
    mcfg = dict(cfg["model"])
    if spatial_axis:
        mcfg["spatial_axis"] = spatial_axis
    return build_jax_detector(copy.deepcopy(mcfg),
                              train_cfg=cfg["train_cfg"],
                              test_cfg=cfg["test_cfg"])


def _port(job, axis=None):
    return cs.sp_model(torch, job, CPU, axis)[1]


def _variables(port):
    """The port's weights as a flax tree, copied (`variables_of` shares the
    CPU tensors' memory, and JAX may read it after a later in-place
    load)."""
    return jax.tree_util.tree_map(np.array, variables_of(port))


def _f32(v):
    if torch.is_tensor(v):
        return v.float().numpy()
    return np.asarray(v, np.float32)


def _assert_preds_close(got, want, frac=None, rtol=None, atol=None):
    for t, (g, w) in enumerate(zip(got, want)):
        for h in w:
            gv, wv = _f32(g[h]), _f32(w[h])
            if frac is not None:
                err = float(np.abs(gv - wv).max())
                scale = float(np.abs(wv).max()) + 1e-6
                assert err <= frac * scale, f"task{t}/{h}: {err} > {frac} x "
            else:
                np.testing.assert_allclose(gv, wv, rtol=rtol, atol=atol,
                                           err_msg=f"task{t}/{h}")


def test_demo_served_equals_unsharded_and_jax(prepared, ranks):
    """`pillarnet18_demo` with `spatial_axis` over the ranks: the head
    outputs of the first cloud against the unsharded port (1e-5 of the
    largest |value|) and the JAX package's unsharded forward on the same
    weights (rtol 1e-3, atol 5e-3); the detections of both clouds against
    one process (phase 14e); every request issues the same all_reduce
    calls (9 halo exchanges and conv2's gather)."""
    _, jobs, one, _ = prepared
    port = _port(jobs["f32"])
    pts, msk = torch.load(jobs["f32"]["clouds"], weights_only=False)[0]
    jpreds = jit_apply(_jax_demo(), _variables(port), jnp.asarray(pts),
                       jnp.asarray(msk))
    for rk in ranks:
        got = rk["jobs"]["f32"]
        _assert_preds_close(got["preds"], one["f32"]["preds"], frac=1e-5)
        _assert_preds_close(got["preds"], jpreds, rtol=1e-3, atol=5e-3)
        cs.compare_sp_detections(f"rank {rk['rank']}", got["detections"],
                                 one["f32"]["detections"])
        assert got["collectives"] == [10, 10]
        assert sum(int(d["mask"].sum()) for d in got["detections"]) > 0


@pytest.mark.slow
def test_demo_served_equals_jax_sharded(prepared, ranks2):
    """The ranks' head outputs against the JAX package's forward with
    `spatial_axis` under a 2-device mesh (GSPMD), on the same weights."""
    _, jobs, _, _ = prepared
    variables = _variables(_port(jobs["f32"]))
    pts, msk = torch.load(jobs["f32"]["clouds"], weights_only=False)[0]
    model = _jax_demo("sp")
    with jax.set_mesh(Mesh(np.array(jax.devices()[:2]), ("sp",))):
        want = jax.jit(lambda v, p, m: model.apply(v, p, m, train=False))(
            variables, jnp.asarray(pts), jnp.asarray(msk))
    for rk in ranks2:
        _assert_preds_close(rk["jobs"]["f32"]["preds"], want, rtol=1e-3,
                            atol=5e-3)


# ---- training ---------------------------------------------------------------


def test_training_step_equals_one_process(prepared, ranks2):
    """One `train_step` of the demo over 2 ranks on the same 2 frames
    against the one-process step (`chip_smoke.check_sp_training`), and
    which collectives ran: the sharded stages' norms (conv1's blocks and
    conv2) sum over the group, the reader's and those of conv3 onward do
    not; the reader's, conv1's and conv2's gradients are summed, and rank
    0's of every other parameter is taken."""
    _, jobs, one, spread = prepared
    got = [rk["jobs"]["train"] for rk in ranks2]
    res = cs.check_sp_training(torch, "demo", got, one["train"], spread)
    assert max(res["loss_rel"].values()) <= 1e-5
    port = _port(jobs["train"])
    norms = [n for n, m in port.named_modules()
             if isinstance(m, MaskedBatchNorm)]
    sharded = [n for n in norms if n.startswith(
        ("backbone_net.conv1_block", "backbone_net.conv2."))]
    assert got[0]["bn_summed"] == sorted(sharded)
    assert "reader_net.pfn_bn_0" in norms
    assert any(n.startswith("backbone_net.conv3.") for n in norms)
    summed = got[0]["summed"]
    assert summed and all(n.startswith((
        "reader_net.", "backbone_net.conv1_block", "backbone_net.conv2."))
        for n in summed)
    assert "reader_net.pfn_dense_0.weight" in summed
    assert not any(n.startswith(("backbone_net.conv3", "neck_net",
                                 "head_net")) for n in summed)


@pytest.mark.slow
def test_training_statistics_equal_jax_sharded(prepared, ranks2):
    """The running statistics after the ranks' training forward against
    the JAX package's train-mode forward with `spatial_axis` under a
    2-device mesh (`test_spatial_sharding.py:122-138`'s tolerances)."""
    _, jobs, _, _ = prepared
    port = _port(jobs["train"])
    variables = _variables(port)
    with open(jobs["train"]["batch"], "rb") as f:
        batch = pickle.load(f)
    model = _jax_demo("sp")
    with jax.set_mesh(Mesh(np.array(jax.devices()[:2]), ("sp",))):
        _, upd = jax.jit(lambda v, p, m: model.apply(
            v, p, m, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(batch["points"]),
            jnp.asarray(batch["points_mask"]))
    port.load_state_dict(ranks2[0]["jobs"]["train"]["state"])
    got = variables_of(port)["batch_stats"]
    for a, b in zip(jax.tree_util.tree_leaves(upd["batch_stats"]),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-3, atol=5e-3)


# ---- int8 -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["int8", "int8_k5"])
def test_int8_maps_bit_equal_to_one_process(prepared, ranks2, name):
    """The int8 demo in bf16 on K4's plain version (`int8`) and with the
    fused stage (K5's plain version on an n-row halo, `int8_k5`): the
    scales the ranks calibrate under the group equal one process's; on
    one process's scales the gathered conv1 and conv2 maps and the
    detections bit-equal."""
    _, jobs, one, _ = prepared
    if name == "int8_k5":
        assert _port(jobs[name]).backbone_net.fused_stage1_params() \
            is not None
    for rk in ranks2:
        got = rk["jobs"][name]
        assert cs.absmax_rel(torch, got["absmax"], one[name]["absmax"]) == 0
        for k in ("conv1", "conv2"):
            assert got["conv"][k].dtype == torch.bfloat16
            assert torch.equal(got["conv"][k], one[name]["conv"][k]), k
        cs.compare_sp_detections(name, got["detections"],
                                 one[name]["detections"], exact=True)


@pytest.mark.slow
def test_int8_equals_jax_sharded(tmp_path):
    """The shrunk int8 slice of `tests/test_torch_port_int8_e2e.py` served
    over 2 ranks against the JAX package's int8 forward with
    `spatial_axis` under a 2-device mesh (`tests/test_quant_int8.py:
    177-222`): the head outputs within 2e-2 of their scale (bf16)."""
    from test_torch_port_int8_e2e import shrunk_int8_cfg, _clouds
    from test_torch_port_int8 import int8_variables
    from test_torch_port_int8_e2e import quant_collection
    from pillarnet_lts_torch.runtime.convert import load_jax_variables
    from pillarnet_lts_torch.runtime.quantize import calibrate

    mcfg, tcfg = shrunk_int8_cfg()
    pts, msk = _clouds([5])[0]
    jmodel = build_jax_detector(copy.deepcopy(mcfg), test_cfg=tcfg)
    variables = int8_variables(jmodel, 12, jnp.asarray(pts),
                               jnp.asarray(msk), train=False)
    variables.pop("quant", None)
    port = load_jax_variables(build_detector(mcfg, test_cfg=tcfg), variables)
    calibrate(port, [(torch.from_numpy(pts), torch.from_numpy(msk))])
    vq = dict(variables, quant=quant_collection(port))
    config = os.path.join(tmp_path, "int8_slice.py")
    with open(config, "w") as f:
        f.write(f"model = {mcfg!r}\ntest_cfg = {tcfg!r}\n"
                "train_cfg = None\npoint_cloud_range = "
                f"{mcfg['reader']['pc_range']!r}\n")
    weights = os.path.join(tmp_path, "w.pt")
    torch.save(port.state_dict(), weights)
    clouds = os.path.join(tmp_path, "clouds.pt")
    torch.save([(pts, msk)], clouds)
    job = cs.sp_job("slice", "serve", config, clouds=clouds, int8=True,
                    weights=weights)
    ranks, _ = cs.run_spatial(cs.sp_spec(
        "cpu", "gloo", os.path.join(tmp_path, "r"), [job], threads=1),
        "int8 slice", timeout=600)
    jsp = build_jax_detector({**copy.deepcopy(mcfg), "spatial_axis": "sp"},
                             test_cfg=tcfg)
    with jax.set_mesh(Mesh(np.array(jax.devices()[:2]), ("sp",))):
        want = jax.jit(lambda v, p, m: jsp.apply(v, p, m, train=False))(
            vq, jnp.asarray(pts), jnp.asarray(msk))
    for rk in ranks:
        _assert_preds_close(rk["jobs"]["slice"]["preds"], want, frac=2e-2)


# ---- two-stage --------------------------------------------------------------


def test_two_stage_served_equals_one_process(prepared, ranks2):
    """`pillarrcnn18_demo` with `spatial_axis` in `first_stage_cfg` over 2
    ranks: its second stage pools conv3 of the gathered map, and its
    detections equal one process's (phase 14e's tolerances)."""
    _, jobs, one, _ = prepared
    port = _port(jobs["rcnn"], "sp")
    assert port.single_det.spatial_axis == "sp"
    assert not port.single_det.spatial_conv1
    for rk in ranks2:
        got = rk["jobs"]["rcnn"]
        cs.compare_sp_detections(f"rank {rk['rank']}", got["detections"],
                                 one["rcnn"]["detections"])
        assert sum(int(d["mask"].sum()) for d in got["detections"]) > 0


def test_a_second_stage_reading_conv1_gets_it_gathered():
    """A second stage whose `feature_sources` name conv1 makes the sharded
    first stage gather conv1 (`spatial_conv1`); without one it is left out
    of the backbone's dict."""
    cfg = load_config(cs.RCNN_DEMO)
    model = cfg["model"]
    model["first_stage_cfg"] = dict(model["first_stage_cfg"],
                                    spatial_axis="sp")
    stage = dict(model["second_stage_modules"][0],
                 feature_sources=["conv1", "conv3"])
    model["second_stage_modules"] = [stage]
    built = build_model_from_cfg(cfg, device="cpu")
    assert built.single_det.spatial_conv1
    pts, msk = cs.sp_clouds(cfg, 1, 2048, 3)[0]
    with torch.inference_mode():
        _, feats = built.single_det.extract_feat(torch.from_numpy(pts),
                                                 torch.from_numpy(msk))
        assert "conv1" in feats
        built.single_det.spatial_conv1 = False
        _, feats = built.single_det.extract_feat(torch.from_numpy(pts),
                                                 torch.from_numpy(msk))
        assert "conv1" not in feats and "conv2" in feats


# ---- what raises ------------------------------------------------------------


def _spatial_cfg(path=cs.DEMO):
    cfg = load_config(path)
    cfg["model"]["spatial_axis"] = "sp"
    return cfg


def test_spatial_axis_is_a_live_key():
    from pillarnet_lts_torch.models import builder

    assert "spatial_axis" not in builder._DROPPED_KEYS
    assert build_model_from_cfg(_spatial_cfg(), "cpu").spatial_axis == "sp"


def test_compact_reader_with_spatial_axis_raises():
    cfg = _spatial_cfg()
    cfg["model"]["reader"] = dict(cfg["model"]["reader"], compact_kmax=1024)
    with pytest.raises(ValueError, match="dense reader"):
        build_model_from_cfg(cfg, "cpu")


def test_data_parallel_run_with_spatial_axis_raises(monkeypatch, tmp_path):
    from pillarnet_lts_torch import apis

    cfg = _spatial_cfg()
    model = build_model_from_cfg(cfg, "cpu")
    monkeypatch.setattr(apis, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="data-parallel"):
        apis.train_detector(model, SynthDataset(cfg, 2, 1024), cfg,
                            work_dir=str(tmp_path))


@pytest.mark.parametrize("tool", ["train", "dist_test", "export_serving"])
def test_clis_refuse_spatial_axis(tmp_path, tool):
    import importlib

    from pillarnet_lts_torch.runtime.export import export_serving

    config = cs.config_file(str(tmp_path), "spatial", cs.RCNN_DEMO,
                            "model['first_stage_cfg']['spatial_axis'] = "
                            "'sp'\n")
    main = importlib.import_module(f"pillarnet_lts_torch.tools.{tool}").main
    args = {"train": [config, "--device", "cpu", "--work_dir",
                      str(tmp_path)],
            "dist_test": [config, "--device", "cpu", "--work_dir",
                          str(tmp_path)],
            "export_serving": [config, "--device", "cpu", "--checkpoint",
                               str(tmp_path / "none.pth"), "--out",
                               str(tmp_path / "x.pt2")]}[tool]
    with pytest.raises(ValueError, match="spatially sharded"):
        main(args)
    if tool == "export_serving":
        with pytest.raises(ValueError, match="spatial_axis"):
            export_serving(build_model_from_cfg(_spatial_cfg(), "cpu"), 1,
                           1024)
