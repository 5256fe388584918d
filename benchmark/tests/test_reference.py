"""The plain reference against the system on the demo-sized network, on
the CPU: the f32 forward with decode and NMS, and the int8 deploy with
its calibration."""

import copy

import torch

from benchmark.harness import check, session
from benchmark.harness.inputs import cloud_pool, make_weights
from benchmark.reference.model import (Quant, Reference, param_spec,
                                       spread_head)

from .conftest import demo_config


def _setup(quant, seed=2**31 + 17):
    from pillarnet_lts_torch.models import build_detector

    cfg = demo_config(quant)
    mc = cfg["model"]
    w = make_weights(param_spec(mc), seed, "cpu")
    pts, msk = cloud_pool(4, 4096, mc["reader"]["pc_range"], seed)
    f32 = Reference(session.f32_model_cfg(mc), cfg["test_cfg"], w)
    spread_head(w, f32.forward(pts[:1], msk[:1]))
    model = build_detector(copy.deepcopy(mc),
                           test_cfg=copy.deepcopy(cfg["test_cfg"]),
                           device="cpu")
    model.load_state_dict(w, strict=False)
    return cfg, w, pts, msk, model.eval()


def _served(model, pts, msk):
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.runtime.serving import to_host

    return check.split_frames(to_host(make_infer_fn(model)(pts, msk)))


def test_f32_forward_decode_nms():
    cfg, w, pts, msk, model = _setup(False)
    ref = Reference(cfg["model"], cfg["test_cfg"], w)
    with torch.no_grad():
        got = model(pts, msk)
    want = ref.forward(pts, msk)
    for g, r in zip(got, want):
        for k in r:
            scale = r[k].abs().max().item()
            assert (g[k] - r[k]).abs().max().item() <= 1e-5 * max(scale, 1)
    served = _served(model, pts, msk)
    assert sum(int(f["mask"].sum()) for f in served) > 50
    out = check.readings(served, ref.detect(pts, msk),
                         session.class_offsets(cfg["model"]))
    assert out["det_gap"] < 1e-4
    assert out["kept_mismatch"] == 0.0


def test_int8_with_calibration():
    from pillarnet_lts_torch.runtime.quantize import calibrate

    cfg, w, pts, msk, model = _setup(True)
    calib = [(pts[i:i + 1], msk[i:i + 1]) for i in range(2)]
    calibrate(model, calib)
    ref = Reference(cfg["model"], cfg["test_cfg"], w, Quant())
    ref.calibrate(calib)
    assert len(ref.quant.absmax) == sum(
        1 for m in model.modules() if getattr(m, "quant", False))
    with torch.no_grad():
        got = model(pts, msk)
    want = ref.forward(pts, msk)
    for g, r in zip(got, want):
        for k in r:
            assert torch.equal(g[k].float(), r[k]), k
    out = check.readings(_served(model, pts, msk), ref.detect(pts, msk),
                         session.class_offsets(cfg["model"]))
    assert out == {"det_gap": 0.0, "kept_mismatch": 0.0}


def test_int4_control_fails_the_int8_comparison():
    """The int8 cell's control, the reference with int4 codes in the
    system's place, reads far above what the system reads."""
    from benchmark.tools.readings import as_served

    cfg, w, pts, msk, _ = _setup(True)
    calib = [(pts[i:i + 1], msk[i:i + 1]) for i in range(2)]
    refs = []
    for qmax in (127, 7):
        r = Reference(cfg["model"], cfg["test_cfg"], w, Quant(qmax))
        r.calibrate(calib)
        refs.append(r.detect(pts, msk))
    offsets = session.class_offsets(cfg["model"])
    out = check.readings([as_served(f, offsets) for f in refs[1]], refs[0],
                         offsets)
    assert out["det_gap"] > 0.05 and out["kept_mismatch"] > 0.2


def test_training_targets_losses_and_update():
    """The reference's targets equal the system's pipeline's; three steps
    of the reference and of the system agree in loss, first gradient and
    change of every leaf the reference's gradient moves."""
    import numpy as np

    from benchmark.harness import program, training

    from .conftest import demo_train_cell

    cell = demo_train_cell()
    s = training.TrainSetup(cell, 2**31 + 3, torch.device("cpu"))
    cfg, mc = cell["config"], cell["config"]["model"]
    index = {n: i for i, n in enumerate(cfg["class_names"])}
    from benchmark.reference.train import targets

    for b in range(len(s.batches)):
        got = s.batches[b]
        for j, (_, boxes, names) in enumerate(
                s.scenes[b * s.batch:(b + 1) * s.batch]):
            want = targets(boxes, np.array([index[n] for n in names]), mc,
                           cfg["train_cfg"]["assigner"])
            for t, tw in enumerate(want):
                for k, v in tw.items():
                    assert np.array_equal(got[k][t][j].numpy(), v), (k, t)
    losses = []
    for k in range(3):
        losses.append(float(s.step(s.feed(k))["loss"]))
        if k == 0:
            g1 = training.first_moment_grads(s.opt, s.model)
    after = {n: p.detach() for n, p in s.model.named_parameters()}
    out = training.readings(s, losses, g1, after, training.reference_run(s))
    assert out["loss_gap"] < 1e-5 and out["grad_gap"] < 1e-4
    assert out["change_gap"] < 5e-3
    program.set_tf32(False)
