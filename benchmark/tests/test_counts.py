"""counts.py: with every pillar active, the architecture's operation
count equals what `FlopCounterMode` counts on the system's dense forward;
the K4 bound's arithmetic."""

import copy

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts
from benchmark.harness.inputs import make_weights
from benchmark.reference.model import param_spec

from .conftest import demo_config


def _full_grid(mc):
    H, W = counts.grid_shape(mc)
    pc, s = mc["reader"]["pc_range"], mc["reader"]["pillar_size"]
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    pts = torch.zeros(1, H * W, 5)
    pts[0, :, 0] = pc[0] + (xs.flatten() + 0.5) * s
    pts[0, :, 1] = pc[1] + (ys.flatten() + 0.5) * s
    return pts, torch.ones(1, H * W, dtype=torch.bool)


def test_all_sites_active_matches_flop_counter():
    from pillarnet_lts_torch.models import build_detector

    cfg = demo_config()
    mc = cfg["model"]
    model = build_detector(copy.deepcopy(mc), test_cfg=cfg["test_cfg"],
                           device="cpu")
    model.load_state_dict(make_weights(param_spec(mc), 1, "cpu"))
    pts, msk = _full_grid(mc)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model.eval()(pts, msk)
    ops = counts.frame_ops(mc, pts, msk)
    assert set(ops) == {"f32"}
    assert float(ops["f32"][0]) == fc.get_total_flops()


def test_sparse_counts_below_dense_and_arithmetic_split():
    mc = demo_config(quant=True)["model"]
    pts, msk = _full_grid(mc)
    dense = counts.frame_ops(mc, pts, msk)
    sparse = counts.frame_ops(mc, pts[:, ::7], msk[:, ::7])
    assert set(dense) == {"int8", "bf16"}
    assert float(sparse["int8"][0]) < float(dense["int8"][0])
    assert float(sparse["bf16"][0]) == float(dense["bf16"][0])
    assert counts.min_seconds(dense)[0] > counts.min_seconds(sparse)[0]


def test_k4_calls_cover_every_int8_conv():
    mc = demo_config(quant=True)["model"]
    pts, msk = _full_grid(mc)
    calls = counts.k4_calls(mc, pts, msk)
    # PillarResNet18: 5 + 5 + 5 + 5 sparse, 3 dense; RPNV1 [2, 2]: 6
    assert len(calls) == 29
    name, t, by = calls[0]
    assert name == "conv1_block0.conv0" and t > 0
    ops = 2 * 9 * 16 * 16 * pts.shape[1]
    assert t >= ops / counts.PEAK_OPS["int8"]
