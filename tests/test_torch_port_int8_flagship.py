"""PyTorch port, int8 deploy at flagship size (slow; not in tier-1): the
random-weight `pillarnet34_nusc_int8` structure at full widths on the
flagship's 1440 x 1440 grid, in both packages on the CPU, with one set of
JAX variables (carried to the port by `load_jax_variables`), the same
head spread and the same 4 calibration clouds of the flagship's 262,144
points (raw: points at pillar edges included).

It answers whether the int8 heatmaps' distance from the bf16 forward
(0.31 of max |bf16| on task 1 on the card) is the port's or the
quantization scheme's, by recording per task:

- the JAX package's int8-vs-bf16 heatmap error;
- the port's int8-vs-bf16 heatmap error;
- the port's int8 heatmaps against the JAX package's.

Each error is max |got - ref| / max |ref| over the task's heatmap, on the
first calibration cloud (as `chip_smoke.py` reports it). Tolerances: the
int8 neck output bit-equal (as `test_torch_port_int8_e2e.py` holds it on
the shrunk grid), heads within 2e-2 of each map's max (bf16 convs rounded
by XLA and ATen), and so the two packages' int8-vs-bf16 errors within 2e-2
of each other. Run with

    python -m pytest -m slow -s tests/test_torch_port_int8_flagship.py

(one process; ~10 GiB of memory; `-s` shows the recorded numbers).
"""

import copy
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillarnet_lts_tpu.models import build_detector as build_jax_detector
from pillarnet_lts_torch.models import build_detector
from pillarnet_lts_torch.runtime.quantize import calibrate
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_torch_port_e2e import PC_RANGE, spread_both_heads
from test_torch_port_int8 import int8_variables
from test_torch_port_int8_e2e import (
    _jax_forward, _nhwc, _port_forward, quant_collection, shrunk_int8_cfg)

pytestmark = pytest.mark.slow

GRID = 1440       # pillarnet34_nusc_int8: 108 m / 0.075 m
N_POINTS = 262144  # its data.max_points
HEAD_TOL = 2e-2


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6))


def test_int8_flagship_heatmap_error_is_the_schemes():
    from __graft_entry__ import _synth_points_realistic

    mcfg, tcfg = shrunk_int8_cfg(grid=GRID)
    # the raw clouds: the port's pillar ids equal XLA's reciprocal
    # multiply, points at pillar edges included
    spread, *calib = [_synth_points_realistic(1, N_POINTS, PC_RANGE, seed=s)
                      for s in (99, 90, 91, 92, 93)]
    jmodel = build_jax_detector(copy.deepcopy(mcfg), test_cfg=tcfg)
    variables = int8_variables(jmodel, 12, jnp.asarray(spread[0]),
                               jnp.asarray(spread[1]), train=False)
    variables.pop("quant", None)

    port = build_detector(mcfg, test_cfg=tcfg)
    spread_both_heads(port, variables, *map(torch.from_numpy, spread))
    pts, msk = calib[0]
    with torch.inference_mode():  # uncalibrated: the bf16 forward
        ref = port(torch.from_numpy(pts), torch.from_numpy(msk))
    calibrate(port, [tuple(map(torch.from_numpy, c)) for c in calib])
    feats, bev, got, _ = _port_forward(port, pts, msk)
    vq = dict(variables, quant=quant_collection(port))

    _, _, jref = _jax_forward(jmodel, variables, pts, msk)
    jfeats, jbev, jgot = _jax_forward(jmodel, vq, pts, msk)

    def hm(preds, t):
        return preds[t]["hm"].float().numpy() if torch.is_tensor(
            preds[t]["hm"]) else np.asarray(preds[t]["hm"], np.float32)

    tasks = range(len(jgot))
    rec = {
        "jax_int8_vs_bf16": [_rel(hm(jgot, t), hm(jref, t)) for t in tasks],
        "port_int8_vs_bf16": [_rel(hm(got, t), hm(ref, t)) for t in tasks],
        "port_int8_vs_jax_int8": [_rel(hm(got, t), hm(jgot, t))
                                  for t in tasks],
        "port_bf16_vs_jax_bf16": [_rel(hm(ref, t), hm(jref, t))
                                  for t in tasks],
    }
    stages = {}
    for k in [f"conv{i}" for i in range(1, 6)]:
        x, m = feats[k]
        a, b = _nhwc(x), np.asarray(jfeats[k][0], np.float32)
        stages[k] = {"differ": float((a != b).mean()), "rel": _rel(a, b)}
        if m is not None:
            stages[k]["mask_differ"] = float(
                (m.numpy() != np.asarray(jfeats[k][1])).mean())
    a, b = _nhwc(bev[0]), np.asarray(jbev[0], np.float32)
    stages["neck"] = {"differ": float((a != b).mean()), "rel": _rel(a, b)}
    rec["port_vs_jax_int8_stages"] = stages
    print("int8 flagship heatmap errors: " + json.dumps(rec))

    np.testing.assert_array_equal(_nhwc(bev[0]),
                                  np.asarray(jbev[0], np.float32))
    assert max(rec["port_int8_vs_jax_int8"]) <= HEAD_TOL
    for a, b in zip(rec["jax_int8_vs_bf16"], rec["port_int8_vs_bf16"]):
        assert abs(a - b) <= HEAD_TOL
