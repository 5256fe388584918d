"""PyTorch port end to end: the whole inference slice against the JAX
package on a shrunk flagship-shaped config, the committed golden fixture
replayed through the port, and the port's import boundary.

Tolerances (those of `tests/test_golden_e2e.py`): detection mask and labels
equal, scores atol 1e-4, boxes atol 1e-3. Random weights put many scores
near the heatmap prior sigmoid(-2.19) ~ 0.1007, next to the 0.1 threshold,
so the slice test first spreads them (random batch statistics, head
projections rescaled to a robust unit spread) and asserts a 1e-4 margin
around both thresholds before it compares keep sets.
"""

import copy
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillarnet_lts_tpu.models import build_detector as build_jax_detector
from pillarnet_lts_tpu.utils.config import Config
from pillarnet_lts_torch.apis import load_config, spread_head_outputs
from pillarnet_lts_torch.eval_utils import detections_to_host, make_infer_fn
from pillarnet_lts_torch.models import build_detector
from pillarnet_lts_torch.ops.iou3d import rotated_iou_bev, to_pcdet_bev
from pillarnet_lts_torch.runtime.convert import (
    load_jax_variables,
    variables_from_keystr,
)
from pillarnet_lts_torch.runtime.serving import ServingPipeline
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_torch_port_modules import jit_apply, random_variables

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_e2e_r3.npz")
sys.path.insert(0, os.path.join(ROOT, "tools"))

PC_RANGE = [-54.0, -54.0, -5.0, 54.0, 54.0, 3.0]
PILLAR = 108.0 / 128  # 128 x 128 grid, head maps 16 x 16
TASKS = [
    dict(stride=8, class_names=["car"]),
    dict(stride=8, class_names=["truck", "construction_vehicle"]),
    dict(stride=8, class_names=["bus", "trailer"]),
    dict(stride=8, class_names=["barrier"]),
    dict(stride=8, class_names=["motorcycle", "bicycle"]),
    dict(stride=8, class_names=["pedestrian", "traffic_cone"]),
]


def shrunk_flagship_cfg():
    """pillarnet34_nusc's structure (PillarResNet34 + RPNV1 + 6-task
    CenterHead with vel and GIoU) at narrow widths on a 128^2 grid."""
    model = dict(
        type="PillarNet",
        reader=dict(type="DynamicPFE", in_channels=5, num_filters=(8,),
                    pillar_size=PILLAR, pc_range=PC_RANGE),
        backbone=dict(type="PillarResNet34", in_channels=8, s2d_stage1=False,
                      hpack=False, chunk_nc=0),
        neck=dict(type="RPNV1", layer_nums=[5, 5], num_filters=32,
                  in_channels=[32, 32]),
        bbox_head=dict(
            type="CenterHead", tasks=TASKS, in_channels=[32],
            code_weights=[1.0] * 6 + [0.2, 0.2, 1.0, 1.0],
            common_heads={"reg": (2, 2), "height": (1, 2), "dim": (3, 2),
                          "rot": (2, 2), "vel": (2, 2)},
            reg_iou="GIoU", pillar_size=PILLAR, point_cloud_range=PC_RANGE),
    )
    test_cfg = dict(
        nms=dict(use_rotate_nms=True, nms_pre_max_size=256,
                 nms_post_max_size=32, nms_iou_threshold=0.2),
        rectifier=0, score_threshold=0.1, double_flip=False,
        post_center_limit_range=[-61.2, -61.2, -10.0, 61.2, 61.2, 10.0])
    return model, test_cfg


def spread_both_heads(port, variables, pts, msk):
    """`apis.spread_head_outputs` on the port, and the same rescale applied
    to the numpy tree, so both frameworks get the same weights."""
    load_jax_variables(port, variables)
    head = variables["params"]["head_net"]
    for (k, h), (scale, bias) in spread_head_outputs(port, pts, msk).items():
        p = head[f"task{k}"][f"{h}_out"]
        p["kernel"] *= scale
        p["bias"][:] = bias


def test_shrunk_flagship_slice_matches_jax():
    from __graft_entry__ import _synth_points_realistic

    mcfg, tcfg = shrunk_flagship_cfg()
    pts, msk = _synth_points_realistic(1, 8192, PC_RANGE, seed=5)
    jmodel = build_jax_detector(copy.deepcopy(mcfg), test_cfg=tcfg)
    variables = random_variables(jmodel, 12, jnp.asarray(pts),
                                 jnp.asarray(msk), train=False)
    variables = jax.tree_util.tree_map(np.array, variables)

    port = build_detector(mcfg, test_cfg=tcfg)
    tpts, tmsk = torch.from_numpy(pts), torch.from_numpy(msk)
    spread_both_heads(port, variables, tpts, tmsk)

    with torch.inference_mode():
        preds = port(tpts, tmsk)
        det = port.predict({}, preds)
    jpreds = jit_apply(jmodel, variables, jnp.asarray(pts), jnp.asarray(msk))
    jdet = jax.jit(lambda p: jmodel.predict({}, p, jmodel.processed_test_cfg()))(
        jpreds)

    # guards: no candidate score and no decisive IoU on a threshold
    scores = torch.cat([torch.sigmoid(p["hm"]).amax(-1).flatten()
                        for p in preds])
    assert (scores - tcfg["score_threshold"]).abs().min() > 1e-4
    m = det["mask"][0]
    kept = det["box3d_lidar"][0][m]
    assert int(m.sum()) > 0
    iou = rotated_iou_bev(to_pcdet_bev(kept), to_pcdet_bev(kept))
    off_diag = ~torch.eye(len(kept), dtype=torch.bool)
    assert (iou[off_diag] - 0.2).abs().min() > 1e-4

    np.testing.assert_array_equal(det["mask"].numpy(),
                                  np.asarray(jdet["mask"]))
    mm = det["mask"].numpy()
    np.testing.assert_array_equal(det["label_preds"].numpy()[mm],
                                  np.asarray(jdet["label_preds"])[mm])
    np.testing.assert_allclose(det["scores"].numpy()[mm],
                               np.asarray(jdet["scores"])[mm], atol=1e-4)
    np.testing.assert_allclose(det["box3d_lidar"].numpy()[mm],
                               np.asarray(jdet["box3d_lidar"])[mm], atol=1e-3)


def _golden_model():
    from chip_smoke import golden_model_cfg

    data = np.load(FIXTURE)
    mcfg, tcfg = golden_model_cfg()
    model = build_detector(mcfg, test_cfg=tcfg)
    load_jax_variables(model, variables_from_keystr(data))
    return model, data


def test_golden_fixture_replay():
    model, data = _golden_model()
    det = make_infer_fn(model)(torch.from_numpy(data["points"]),
                               torch.from_numpy(data["points_mask"]))
    np.testing.assert_array_equal(det["mask"].numpy(), data["det_mask"],
                                  err_msg="NMS keep-set changed")
    m = data["det_mask"].astype(bool)
    np.testing.assert_array_equal(det["label_preds"].numpy()[m],
                                  data["label_preds"][m])
    np.testing.assert_allclose(det["scores"].numpy()[m], data["scores"][m],
                               atol=1e-4)
    np.testing.assert_allclose(det["box3d_lidar"].numpy()[m],
                               data["box3d_lidar"][m], atol=1e-3)


def test_chip_smoke_golden_config_is_the_fixture_config():
    from chip_smoke import golden_model_cfg
    from make_golden_fixture_e2e import model_cfg

    assert json.dumps(golden_model_cfg(), sort_keys=True) == json.dumps(
        model_cfg(), sort_keys=True)


def test_chip_smoke_profile_completeness_counts():
    """A profiler session is complete when its device events are at least
    its launch calls; the session's primer kernel counts there but stays
    out of the kernel rows."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from chip_smoke import device_events, kernel_table, launch_calls

    def ev(key, device, count, us=0.0):
        return SimpleNamespace(key=key, count=count, device_type=device,
                               self_device_time_total=us)

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [ev("cudaLaunchKernel", cpu, 3), ev("cuLaunchKernel", cpu, 2),
              ev("cudaMemsetAsync", cpu, 1), ev("aten::copy_", cpu, 4),
              ev("cudaDeviceSynchronize", cpu, 2),
              ev("void at::cuda::spin_kernel(long)", cuda, 1, 5.0),
              ev("rotated_overlap_kernel", cuda, 2, 40.0),
              ev("elementwise_kernel", cuda, 2, 20.0),
              ev("Memset (Device)", cuda, 1, 1.0)]
    assert launch_calls(events) == 6 and device_events(events) == 6
    assert device_events(events[:-1]) < launch_calls(events)
    assert kernel_table(events) == [("rotated_overlap_kernel", 0.04, 2),
                                    ("elementwise_kernel", 0.02, 2),
                                    ("Memset (Device)", 0.001, 1)]


def test_serving_pipeline_keeps_order_and_depth():
    model, data = _golden_model()
    infer = make_infer_fn(model)
    pts = torch.from_numpy(data["points"])
    msk = torch.from_numpy(data["points_mask"])
    pipe = ServingPipeline(infer, depth=2)
    assert pipe.submit(pts, msk) is None and pipe.submit(pts, msk) is None
    first = pipe.submit(pts, msk)
    assert len(pipe) == 2
    rest = list(pipe.drain())
    assert len(rest) == 2 and len(pipe) == 0
    for out in [first] + rest:
        np.testing.assert_array_equal(out["mask"], data["det_mask"])
    per_sample = detections_to_host(first, [{"token": "a"}])
    assert len(per_sample) == 1
    assert per_sample[0]["box3d_lidar"].shape == (
        int(data["det_mask"].sum()), 7)
    assert per_sample[0]["metadata"] == {"token": "a"}


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(ROOT, "configs", "*", "*.py"))),
    ids=os.path.basename)
def test_load_config_matches_jax_config(path):
    assert load_config(path) == Config.fromfile(path).to_dict()


def test_port_runs_without_importing_jax():
    code = (
        "import os, sys, numpy as np, torch\n"
        "import pillarnet_lts_torch\n"
        "from chip_smoke import FLAGSHIP, golden_model_cfg\n"
        "from pillarnet_lts_torch.apis import build_model_from_cfg, load_config\n"
        "from pillarnet_lts_torch.models import build_detector\n"
        "from pillarnet_lts_torch.eval_utils import make_infer_fn\n"
        "from pillarnet_lts_torch.apis import build_int8_model\n"
        "from pillarnet_lts_torch.runtime.quantize import "
        "enable_backbone_quant\n"
        "for name in ('', '_bf16', '_int8'):\n"
        "    build_model_from_cfg(load_config(\n"
        "        FLAGSHIP.replace('.py', name + '.py')), device='cpu')\n"
        "mcfg, tcfg = golden_model_cfg()\n"
        "model = build_detector(mcfg, test_cfg=tcfg)\n"
        "d = np.load(sys.argv[1])\n"
        "pts = torch.from_numpy(d['points'])\n"
        "msk = torch.from_numpy(d['points_mask'])\n"
        "det = make_infer_fn(model)(pts, msk)\n"
        "assert det['mask'].shape == (1, 128)\n"
        "from pillarnet_lts_torch.ops import library\n"
        "from pillarnet_lts_torch.runtime.export import export_serving\n"
        "from pillarnet_lts_torch.tools import (convert_torch, "
        "export_serving as export_cli, export_torch)\n"
        "program = export_serving(model, 1, pts.shape[1])\n"
        "assert any(str(n.target).startswith('pillarnet.')\n"
        "           for n in program.graph.nodes)\n"
        "from pillarnet_lts_torch.ops import compact\n"
        "from pillarnet_lts_torch.models.backbones import compact_exec\n"
        "cmodel = build_detector(dict(mcfg, reader=dict(\n"
        "    mcfg['reader'], compact_kmax=4096)), test_cfg=tcfg)\n"
        "cmodel.load_state_dict(model.state_dict())\n"
        "cdet = make_infer_fn(cmodel)(pts, msk)\n"
        "assert cdet['mask'].shape == (1, 128)\n"
        "mcfg = enable_backbone_quant(dict(mcfg, dtype='bfloat16'))\n"
        "mcfg['backbone'] = dict(mcfg['backbone'], in_channels=32,\n"
        "                        s2d_pallas=True)\n"
        "mcfg['reader'] = dict(mcfg['reader'], num_filters=(32,))\n"
        "model = build_int8_model(dict(model=mcfg, test_cfg=tcfg),\n"
        "                         [(pts, msk)], device='cpu')\n"
        "assert model.backbone_net.fused_stage1_params() is not None\n"
        "det = make_infer_fn(model)(pts, msk)\n"
        "assert bool(torch.isfinite(det['box3d_lidar']).all())\n"
        "from chip_smoke import WAYMO\n"
        "from pillarnet_lts_torch.ops.scatter import set_backend\n"
        "wm = build_model_from_cfg(load_config(WAYMO), device='cpu')\n"
        "wcfg = wm.processed_test_cfg()\n"
        "assert wcfg['nms']['nms_iou_threshold'] == [[0.8, 0.55, 0.55]]\n"
        "set_backend('tiled')\n"
        "mcfg, tcfg = golden_model_cfg()\n"
        "model = build_detector(mcfg, test_cfg=tcfg)\n"
        "tiled = make_infer_fn(model)(pts, msk)\n"
        "set_backend('auto')\n"
        "assert tiled['mask'].shape == (1, 128)\n"
        "import tempfile\n"
        "from pillarnet_lts_torch import native\n"
        "from pillarnet_lts_torch.datasets.synth import write_waymo_raw\n"
        "from pillarnet_lts_torch.datasets.waymo import (waymo_common,\n"
        "    waymo_converter, waymo_infos)\n"
        "from pillarnet_lts_torch.tools import create_data\n"
        "assert native.available() or native.build_error()\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    write_waymo_raw(root, 'train', 1, 2, 512,\n"
        "                    [-75.2, -75.2, -2, 75.2, 75.2, 4])\n"
        "    create_data.main(['waymo_data_prep', '--root_path', root])\n"
        "    assert os.path.exists(os.path.join(\n"
        "        root, 'dbinfos_train_1sweeps.pkl'))\n"
        "from chip_smoke import RCNN_DEMO\n"
        "from pillarnet_lts_torch.apis import RCNN_VARIANTS, rcnn_variant\n"
        "from pillarnet_lts_torch.models.roi_heads import mlp_layers\n"
        "from pillarnet_lts_torch.datasets import SynthDataset, "
        "collate_batch\n"
        "from pillarnet_lts_torch.runtime.train_step import (\n"
        "    batch_to_device, step_losses)\n"
        "for v in RCNN_VARIANTS + ('bf16',):\n"
        "    rcfg = load_config(RCNN_DEMO)\n"
        "    if v == 'bf16':\n"
        "        rcfg['model']['dtype'] = 'bfloat16'\n"
        "    else:\n"
        "        rcfg['model'] = rcnn_variant(rcfg['model'], v)\n"
        "    rm = build_model_from_cfg(rcfg, device='cpu', seed=0)\n"
        "    ds = SynthDataset(rcfg, 1, 2048, seed=1)\n"
        "    b = batch_to_device(collate_batch([ds[0]], 8192), 'cpu')\n"
        "    total, _ = step_losses(rm, b, rcfg['train_cfg'],\n"
        "                           torch.Generator().manual_seed(0))\n"
        "    total.backward()\n"
        "    assert bool(torch.isfinite(total)), v\n"
        "from pillarnet_lts_torch.models.necks.rpn import RPN\n"
        "from pillarnet_lts_torch.models.utils import (MaskedGroupNorm,\n"
        "    build_norm, get_norm_kwargs)\n"
        "from pillarnet_lts_torch.ops.nms import "
        "greedy_suppress_with_convergence\n"
        "mcfg, tcfg = golden_model_cfg()\n"
        "mcfg = enable_backbone_quant(dict(mcfg, dtype='bfloat16'), "
        "head=True)\n"
        "mcfg['bbox_head'] = dict(mcfg['bbox_head'], common_heads=dict(\n"
        "    mcfg['bbox_head']['common_heads'], reg=(2, 1), height=(1, 3)))\n"
        "tcfg = dict(tcfg, nms=dict(tcfg['nms'], approx_topk=True))\n"
        "model = build_int8_model(dict(model=mcfg, test_cfg=tcfg),\n"
        "                         [(pts, msk)], device='cpu')\n"
        "assert model.head_net.task0.quant_ready()\n"
        "det = make_infer_fn(model)(pts, msk)\n"
        "assert bool(torch.isfinite(det['box3d_lidar']).all())\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'pillarnet_lts_tpu' not in sys.modules, 'JAX package imported'\n"
        "print('no-jax ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code, FIXTURE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "no-jax ok" in out.stdout
