"""The port's serving export and checkpoint interchange on the CPU.

- Every kernel op of `ops/library.py` (`torch.ops.pillarnet.*`) passes
  `torch.library.opcheck` (schema, fake implementation, autograd
  registration, AOT dispatch with dynamic shapes) on small CPU inputs; K1's
  gradient through the op is `scatter_max_backward`'s, bit for bit.
- `runtime/export.py`: the f32 demo from JAX variables exports with the K1
  and K2 ops in its graph, its saved-and-loaded program is bit-equal to
  eager serving and within `tests/test_torch_port_e2e.py`'s tolerances of
  the JAX package's own `jax.export` round trip (mask and labels equal,
  scores 1e-4, boxes 1e-3); the int8 demos (K4's f32 variant; bf16 with
  the fused stage, K5) and the two-stage demo export bit-equal; a program
  loads and serves in a process that has imported neither `models/`,
  `apis` nor JAX; a fresh process that exports first serves eager
  bit-equal afterwards (`core.utils.device_constant` under tracing).
- `runtime/torch_convert.py::export_state_dict` equals the JAX package's
  on the same variables, key for key and bit for bit, in both spconv
  layouts; `tools/export_torch.py` -> `tools/convert_torch.py`
  round-trips a port checkpoint; `tools/export_serving.py` runs with
  `--device cpu`.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import export as jexport

from pillarnet_lts_tpu.apis import build_model_from_cfg as build_jax_model
from pillarnet_lts_tpu.eval_utils import make_infer_fn as jax_infer_fn
from pillarnet_lts_tpu.runtime.torch_convert import (
    export_state_dict as jax_export_state_dict)
from pillarnet_lts_tpu.utils.config import Config
from pillarnet_lts_torch.apis import (build_int8_model, build_model_from_cfg,
                                      load_config, spread_head_outputs)
from pillarnet_lts_torch.datasets import synth_points_realistic
from pillarnet_lts_torch.eval_utils import make_infer_fn
from pillarnet_lts_torch.ops import _kernels
from pillarnet_lts_torch.ops.iou3d import box_corners_bev
from pillarnet_lts_torch.ops.quant import pack_kernel
from pillarnet_lts_torch.ops.scatter import scatter_max_backward
from pillarnet_lts_torch.runtime.convert import variables_of
from pillarnet_lts_torch.runtime.export import (export_serving, load_serving,
                                                save_serving)
from pillarnet_lts_torch.runtime.quantize import (enable_backbone_quant,
                                                  freeze_int8, thaw_int8)
from pillarnet_lts_torch.runtime.torch_convert import export_state_dict
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_torch_port_e2e import spread_both_heads
from test_torch_port_modules import random_variables

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DEMO = os.path.join(ROOT, "configs", "demo", "pillarnet18_demo.py")
RCNN_DEMO = os.path.join(ROOT, "configs", "demo", "pillarrcnn18_demo.py")
N_POINTS = 4096
OPS = torch.ops.pillarnet


def demo_cloud(cfg, seed=1, n=N_POINTS):
    pts, msk = synth_points_realistic(1, n, cfg["point_cloud_range"],
                                      seed=seed)
    return torch.from_numpy(pts), torch.from_numpy(msk)


def kernel_ops(program):
    """The `pillarnet::*` ops a program's graph calls."""
    return {str(n.target).split(".")[1] for n in program.graph.nodes
            if n.op == "call_function"
            and str(n.target).startswith("pillarnet.")}


def assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def round_trip(program, tmp_path, device=None):
    """The program saved and loaded again (onto `device`), as its
    module."""
    path = str(tmp_path / "model.pt2")
    save_serving(program, path)
    return load_serving(path, device).module()


# --- the ops ----------------------------------------------------------------

def scatter_args(rng, dtype, B=2, N=96, C=8, H=4, W=5):
    ids = rng.randint(-2, H * W + 2, (B, N)).astype(np.int32)
    ids[:, 1::7] = ids[:, ::7][:, :ids[:, 1::7].shape[1]]
    valid = rng.rand(B, N) < 0.8
    if dtype == torch.int8:
        feats = torch.from_numpy(rng.randint(0, 128, (B, N, C))
                                 .astype(np.int8))
    else:
        feats = torch.from_numpy(rng.randn(B, N, C).astype(np.float32))
        feats[:, 1::7] = feats[:, ::7][:, :feats[:, 1::7].shape[1]]  # ties
        feats = feats.to(dtype)
    return (feats, torch.from_numpy(ids), torch.from_numpy(valid), H, W)


def box_rows(rng, R, K):
    boxes = np.zeros((R, K, 7), np.float32)
    boxes[..., :2] = rng.uniform(-6, 6, (R, K, 2))
    boxes[..., 3:5] = rng.uniform(1, 4, (R, K, 2))
    boxes[..., 5] = 1.5
    boxes[..., 6] = rng.uniform(-3.2, 3.2, (R, K))
    return torch.from_numpy(boxes)


def int8_args(rng, cin, cout, stride, n=None, B=1, H=9, W=11):
    lead = () if n is None else (n,)
    x = torch.from_numpy(rng.randn(B, H, W, cin).astype(np.float32))
    w_q = torch.from_numpy(rng.randint(-127, 128, lead + (3, 3, cin, cout))
                           .astype(np.int8))
    inv_s = torch.from_numpy(rng.uniform(20, 40, lead).astype(np.float32))
    dq = torch.from_numpy(rng.uniform(1e-4, 1e-3, lead + (cout,))
                          .astype(np.float32))
    shift = torch.from_numpy(rng.randn(*lead, cout).astype(np.float32))
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    mask = torch.from_numpy((rng.rand(B, ho, wo) < 0.6).astype(np.float32))
    return x, pack_kernel(w_q), inv_s, dq, shift, mask


def op_cases():
    rng = np.random.RandomState(0)
    f32 = scatter_args(rng, torch.float32)
    f32[0].requires_grad_(True)
    quads = box_corners_bev(box_rows(rng, 2, 9)[..., [0, 1, 3, 4, 6]])
    boxes = box_rows(rng, 3, 12)
    x, w_pack, inv_s, dq, shift, mask = int8_args(rng, 32, 32, 2)
    res = torch.from_numpy(rng.randn(1, 5, 6, 32).astype(np.float32))
    xs, ws, ss, dqs, shs, _ = int8_args(rng, 32, 32, 1, n=3)
    stage_mask = torch.from_numpy(
        (rng.rand(1, 9, 11) < 0.5).astype(np.float32)).to(torch.bfloat16)
    return {
        "pillar_scatter_max-f32-grad": (OPS.pillar_scatter_max,
                                        f32 + (False,)),
        "pillar_scatter_max-int8": (
            OPS.pillar_scatter_max,
            scatter_args(rng, torch.int8) + (True,)),
        "pillar_scatter_max_tiled-bf16": (
            OPS.pillar_scatter_max_tiled,
            scatter_args(rng, torch.bfloat16) + (False,)),
        "rotated_overlap": (OPS.rotated_overlap, (quads, quads[:, :5])),
        "suppression_mask-rows": (OPS.suppression_mask,
                                  (boxes, torch.tensor([0.1, 0.3, 0.5]),
                                   0.0)),
        "suppression_mask-float": (OPS.suppression_mask,
                                   (boxes, None, 0.2)),
        "suppression_mask_corners": (OPS.suppression_mask_corners,
                                     (boxes,)),
        "int8_conv": (OPS.int8_conv, (
            x.to(torch.bfloat16), w_pack, inv_s, dq, shift, 2,
            mask.to(torch.bfloat16), res.to(torch.bfloat16), True)),
        "int8_conv_f32": (OPS.int8_conv_f32, (
            x, w_pack, inv_s, dq, shift, 2, None, None, False)),
        "int8_stage": (OPS.int8_stage, (
            (xs * stage_mask[..., None].float()).to(torch.bfloat16), ws, ss,
            dqs, shs, stage_mask)),
        "int8_stage_f32": (OPS.int8_stage_f32, (
            xs * stage_mask[..., None].float(), ws, ss, dqs, shs,
            stage_mask.float())),
    }


OP_CASES = op_cases()


def test_every_kernel_entry_has_an_op():
    from pillarnet_lts_torch.ops import library

    assert set(library.OPS) == set(_kernels.KERNELS)
    assert {case.split("-")[0] for case in OP_CASES} == {
        op._name for op in library.OPS.values()}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_passes_opcheck(case):
    op, args = OP_CASES[case]
    before = dict(_kernels.LAUNCHES)
    torch.library.opcheck(op, args)
    assert _kernels.LAUNCHES == before  # CPU tensors: the plain versions


@pytest.mark.parametrize("op", ["pillar_scatter_max",
                                "pillar_scatter_max_tiled"])
def test_scatter_gradient_through_the_op(op):
    rng = np.random.RandomState(3)
    feats, ids, valid, H, W = scatter_args(rng, torch.float32)
    x = feats.clone().requires_grad_(True)
    grid, _ = getattr(OPS, op)(x, ids, valid, H, W, False)
    dgrid = torch.from_numpy(rng.randn(*grid.shape).astype(np.float32))
    (got,) = torch.autograd.grad(grid, x, dgrid)
    want = scatter_max_backward(feats, ids, valid, grid.detach(), dgrid)
    assert torch.equal(got, want)
    assert bool((got != 0).any())


# --- serving export ---------------------------------------------------------

@pytest.fixture(scope="module")
def demo():
    """pillarnet18_demo from seeded JAX variables with spread heads (the
    same weights in both packages), and one cloud."""
    cfg = load_config(DEMO)
    jcfg = Config.fromfile(DEMO)
    jmodel = build_jax_model(jcfg)
    pts, msk = demo_cloud(cfg)
    variables = jax.tree_util.tree_map(np.array, random_variables(
        jmodel, 7, jnp.asarray(pts.numpy()), jnp.asarray(msk.numpy()),
        train=False))
    model = build_model_from_cfg(cfg, device="cpu")
    spread_both_heads(model, variables, pts, msk)
    return dict(cfg=cfg, jmodel=jmodel, variables=variables, model=model,
                pts=pts, msk=msk, program=export_serving(model, 1, N_POINTS))


def test_f32_export_holds_the_kernel_ops_and_round_trips(demo, tmp_path):
    program = demo["program"]
    assert kernel_ops(program) == {"pillar_scatter_max", "rotated_overlap"}
    assert "data_ptr" not in program.graph_module.code
    want = make_infer_fn(demo["model"])(demo["pts"], demo["msk"])
    assert int(want["mask"].sum()) > 0
    assert_same(round_trip(program, tmp_path)(demo["pts"], demo["msk"]),
                want)
    assert_same(program.module()(demo["pts"], demo["msk"]), want)


def test_f32_export_matches_the_jax_export(demo):
    """The port's program against the JAX package's serialized `jax.export`
    program of the same weights, on the same cloud."""
    jmodel, variables = demo["jmodel"], demo["variables"]
    infer = jax_infer_fn(jmodel)
    pts, msk = demo["pts"].numpy(), demo["msk"].numpy()

    def serving_fn(points, points_mask):
        return infer(variables["params"], variables["batch_stats"], points,
                     points_mask)

    exported = jexport.export(jax.jit(serving_fn))(
        jax.ShapeDtypeStruct(pts.shape, jnp.float32),
        jax.ShapeDtypeStruct(msk.shape, jnp.bool_))
    jdet = jexport.deserialize(exported.serialize()).call(pts, msk)
    with torch.inference_mode():
        det = demo["program"].module()(demo["pts"], demo["msk"])
    m = det["mask"].numpy()
    assert m.sum() > 0
    np.testing.assert_array_equal(m, np.asarray(jdet["mask"]))
    np.testing.assert_array_equal(det["label_preds"].numpy()[m],
                                  np.asarray(jdet["label_preds"])[m])
    np.testing.assert_allclose(det["scores"].numpy()[m],
                               np.asarray(jdet["scores"])[m], atol=1e-4)
    np.testing.assert_allclose(det["box3d_lidar"].numpy()[m],
                               np.asarray(jdet["box3d_lidar"])[m], atol=1e-3)


def int8_demo(variant):
    """The int8 demo: `enable_backbone_quant` on pillarnet18_demo (f32
    activations, K4's f32 variant), or at the int8 kernels' widths in bf16
    with the fused stage on (K4 and K5), or the same widths in f32 with
    the fused stage on (the f32 variants of K4 and K5); seeded weights,
    spread heads, calibrated on the cloud it serves."""
    cfg = load_config(DEMO)
    enable_backbone_quant(cfg["model"])
    if variant.endswith("-fused"):
        if variant == "bf16-fused":
            cfg["model"]["dtype"] = "bfloat16"
        cfg["model"]["reader"]["num_filters"] = (32,)
        cfg["model"]["backbone"].update(in_channels=32, s2d_pallas=True)
    pts, msk = demo_cloud(cfg, seed=2)
    model = build_model_from_cfg(cfg, device="cpu", seed=4)
    spread_head_outputs(model, pts, msk)
    return build_int8_model(cfg, [(pts, msk)], device="cpu",
                            variables=variables_of(model)), pts, msk


@pytest.mark.parametrize("variant,ops", [
    ("f32", {"pillar_scatter_max", "rotated_overlap", "int8_conv_f32"}),
    ("bf16-fused", {"pillar_scatter_max", "rotated_overlap", "int8_conv",
                    "int8_stage"}),
    ("f32-fused", {"pillar_scatter_max", "rotated_overlap", "int8_conv_f32",
                   "int8_stage_f32"})])
def test_int8_export_round_trips(variant, ops, tmp_path):
    model, pts, msk = int8_demo(variant)
    before = make_infer_fn(model)(pts, msk)
    program = export_serving(model, 1, N_POINTS)
    assert kernel_ops(program) == ops
    # the export thaws what it froze: the model is left as it was
    assert not any(name.startswith(("int8_", "fused_"))
                   for name, _ in model.named_buffers())
    eager = make_infer_fn(model)(pts, msk)
    assert_same(eager, before)
    assert int(eager["mask"].sum()) > 0
    assert_same(round_trip(program, tmp_path)(pts, msk), eager)


def test_freeze_int8_counts_every_calibrated_conv():
    model, _, _ = int8_demo("f32")
    convs = [m for m in model.modules() if hasattr(m, "int8_frozen")]
    n = freeze_int8(model)
    assert n == sum(m.quant_ready() for m in convs) > 0
    assert all(m.int8_frozen() for m in convs if m.quant_ready())
    # the frozen buffers stay out of the state_dict; a thaw drops them
    assert not any(k.startswith(("int8_", "fused_"))
                   for k in model.state_dict())
    thaw_int8(model)
    assert not any(m.int8_frozen() for m in convs)


def test_two_stage_export_round_trips(tmp_path):
    cfg = load_config(RCNN_DEMO)
    pts, msk = demo_cloud(cfg, seed=3)
    model = build_model_from_cfg(cfg, device="cpu", seed=5)
    spread_head_outputs(model, pts, msk)
    program = export_serving(model, 1, N_POINTS)
    assert kernel_ops(program) == {"pillar_scatter_max", "rotated_overlap"}
    want = make_infer_fn(model)(pts, msk)
    assert int(want["mask"].sum()) > 0
    assert_same(round_trip(program, tmp_path, "cpu")(pts, msk), want)


@pytest.mark.parametrize("variant", ["RoIFFNHead", "MLPMixer", "ATT_MODEL"])
def test_two_stage_variant_export_round_trips(variant, tmp_path):
    """The two-stage demo with `RoIFFNHead` (its IoU branch: three
    outputs), the `MLPMixer` token mixer or `ATT_MODEL`, exported: the
    served output is still the two-output decode's detections, and the
    program returns eager's bit for bit."""
    from pillarnet_lts_torch.apis import rcnn_variant

    cfg = load_config(RCNN_DEMO)
    cfg["model"] = rcnn_variant(cfg["model"], variant)
    pts, msk = demo_cloud(cfg, seed=3)
    model = build_model_from_cfg(cfg, device="cpu", seed=5)
    spread_head_outputs(model, pts, msk)
    program = export_serving(model, 1, N_POINTS)
    assert kernel_ops(program) == {"pillar_scatter_max", "rotated_overlap"}
    want = make_infer_fn(model)(pts, msk)
    assert set(want) == {"box3d_lidar", "scores", "label_preds", "mask"}
    assert int(want["mask"].sum()) > 0
    assert_same(round_trip(program, tmp_path, "cpu")(pts, msk), want)


def test_compact_export_round_trips(tmp_path):
    """pillarnet18_demo with the compact reader (`reader.compact_kmax`):
    its tables have static shapes (a fixed budget), so it exports; the
    program calls the overlap op only (no scatter-max: the compact reader
    takes its place), counts no dropped site in the trace, and the saved
    and loaded program returns eager's detections bit for bit."""
    cfg = load_config(DEMO)
    cfg["model"]["reader"] = dict(cfg["model"]["reader"],
                                  compact_kmax=N_POINTS)
    pts, msk = demo_cloud(cfg, seed=4)
    model = build_model_from_cfg(cfg, device="cpu", seed=6)
    spread_head_outputs(model, pts, msk)
    program = export_serving(model, 1, N_POINTS)
    assert kernel_ops(program) == {"rotated_overlap"}
    want = make_infer_fn(model)(pts, msk)
    assert int(want["mask"].sum()) > 0
    assert int(model.reader_net.dropped_sites) == 0
    assert int(model.backbone_net.dropped_coarse_sites) == 0
    assert_same(round_trip(program, tmp_path, "cpu")(pts, msk), want)
    assert_same(program.module()(pts, msk), want)


SERVE_ALONE = """
import sys, numpy as np, torch
from pillarnet_lts_torch.runtime.export import load_serving
d = np.load(sys.argv[2])
with torch.inference_mode():
    det = load_serving(sys.argv[1]).module()(
        torch.from_numpy(d["points"]), torch.from_numpy(d["points_mask"]))
for mod in ("jax", "pillarnet_lts_tpu", "pillarnet_lts_torch.models",
            "pillarnet_lts_torch.apis"):
    assert mod not in sys.modules, mod
np.savez(sys.argv[3], **{k: v.numpy() for k, v in det.items()})
"""

EXPORT_THEN_EAGER = """
import sys, numpy as np, torch
from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                      spread_head_outputs)
from pillarnet_lts_torch.eval_utils import make_infer_fn
from pillarnet_lts_torch.runtime.export import export_serving, save_serving
d = np.load(sys.argv[2])
pts = torch.from_numpy(d["points"])
msk = torch.from_numpy(d["points_mask"])
model = build_model_from_cfg(load_config(sys.argv[1]), device="cpu", seed=6)
spread_head_outputs(model, pts, msk)
save_serving(export_serving(model, 1, pts.shape[1]), sys.argv[3])
det = make_infer_fn(model)(pts, msk)
np.savez(sys.argv[4], **{k: v.numpy() for k, v in det.items()})
"""


def run_python(code, *args):
    """Run `code` in a fresh interpreter with this process's intra-op
    thread count (a CPU conv's sums follow the thread split)."""
    env = dict(os.environ, PYTHONPATH=ROOT,
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    out = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]


def test_fresh_process_exports_then_serves_and_the_program_loads_alone(
        tmp_path):
    """A fresh process exports first and then serves eager; the program
    then serves in a process with no `models/`, `apis` or JAX. Both are
    bit-equal to eager serving here."""
    cfg = load_config(DEMO)
    pts, msk = demo_cloud(cfg, seed=8)
    cloud = tmp_path / "cloud.npz"
    np.savez(cloud, points=pts.numpy(), points_mask=msk.numpy())
    program, eager, alone = (tmp_path / n for n in ("m.pt2", "eager.npz",
                                                    "alone.npz"))
    run_python(EXPORT_THEN_EAGER, DEMO, cloud, program, eager)
    run_python(SERVE_ALONE, program, cloud, alone)
    model = build_model_from_cfg(cfg, device="cpu", seed=6)
    spread_head_outputs(model, pts, msk)
    want = make_infer_fn(model)(pts, msk)
    assert int(want["mask"].sum()) > 0
    for path in (eager, alone):
        got = np.load(path)
        assert_same({k: torch.from_numpy(got[k]) for k in got.files}, want)


# --- checkpoint interchange -------------------------------------------------

@pytest.mark.parametrize("layout", ["KRSC", "RSCK"])
@pytest.mark.parametrize("path", [DEMO, RCNN_DEMO],
                         ids=os.path.basename)
def test_export_state_dict_matches_jax(path, layout):
    model = build_model_from_cfg(load_config(path), device="cpu", seed=9)
    variables = variables_of(model)
    got = export_state_dict(variables, spconv_layout=layout)
    want = jax_export_state_dict(variables, spconv_layout=layout)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def test_export_torch_then_convert_torch_round_trips(tmp_path):
    from pillarnet_lts_torch.tools import convert_torch, export_torch

    model = build_model_from_cfg(load_config(RCNN_DEMO), device="cpu",
                                 seed=10)
    with open(RCNN_DEMO) as f:
        meta = {"epoch": 1, "config": f.read()}
    ckpt, ref, back = (str(tmp_path / n) for n in ("p.pth", "ref.pth",
                                                   "back.pth"))
    torch.save({"model": model.state_dict(), "meta": meta}, ckpt)
    sd = export_torch.main(["--checkpoint", ckpt, "--out", ref,
                            "--spconv-layout", "RSCK"])
    assert set(torch.load(ref)["state_dict"]) == set(sd)
    report = convert_torch.main([RCNN_DEMO, "--ckpt", ref, "--out", back,
                                 "--spconv-layout", "RSCK"])
    assert not (report["missing"] or report["unmapped"] or report["unused"])
    got = torch.load(back, weights_only=True)
    assert got["meta"]["format"] == "converted"
    want = model.state_dict()
    assert list(got["model"]) == list(want)
    for k in want:
        assert torch.equal(got["model"][k], want[k]), k


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_export_serving_cli_on_the_cpu(int8, tmp_path):
    from pillarnet_lts_torch.tools import export_serving as cli

    ckpt, out = str(tmp_path / "p.pth"), str(tmp_path / "m.pt2")
    model = build_model_from_cfg(load_config(DEMO), device="cpu", seed=11)
    torch.save({"model": model.state_dict(), "meta": {}}, ckpt)
    rec = cli.main([DEMO, "--checkpoint", ckpt, "--out", out, "--batch", "2",
                    "--max-points", "2048", "--device", "cpu"]
                   + (["--int8", "--calib-batches", "2"] if int8 else []))
    assert rec["bytes"] == os.path.getsize(out) > 0
    assert (rec["batch"], rec["points"]) == (2, 2048)
    program = load_serving(out)
    assert ("int8_conv_f32" in kernel_ops(program)) == int8
    pts = torch.stack([demo_cloud(load_config(DEMO), s, 2048)[0][0]
                       for s in (1, 2)])
    det = program.module()(pts, torch.ones(2, 2048, dtype=torch.bool))
    assert det["box3d_lidar"].shape[:2] == det["mask"].shape
    assert det["mask"].shape[0] == 2
