"""Post-training int8 calibration for the deploy path.

Port of `pillarnet_lts_tpu/runtime/quantize.py`. A model built with the
int8 flags (`enable_backbone_quant`, or the `*_int8.py` configs) holds one
activation absmax per quantized module (`models/utils/quant.py`). Until
they are set it serves its float path. `calibrate` runs eval forwards in
the model's compute dtype (f32 or bf16) over a few representative clouds
inside `calibration_mode`, where each module records the max |activation|
it sees (per input channel for the reader MLP), merges the per-batch
values, and sets them; the model then serves int8. A two-stage model
(`PillarRCNN`, `TwoStageDetector`) calibrates through its whole forward:
the first stage's modules observe while the second stage runs on its
detections, as the JAX package's `calibrate` applies the whole model.
Outside `calibration_mode` nothing is recorded, so serving never pays for
the reductions. `freeze_int8` turns the calibrated model's int8 params into
buffers, the step before `torch.export` (`runtime/export.py`).
"""

import contextlib

import torch

from ..models.backbones.base import MaskedConv
from ..models.utils.quant import Calibrated


def enable_backbone_quant(model_cfg, head=False):
    """Flip the int8 deploy flags in a model config dict: reader MLP,
    backbone and neck (the JAX package's default scope). `head=True`
    flips the CenterHead's too (its shared convs per tensor, each SepHead's
    wide conv per input channel; the JAX package's scope study measured it
    as an mAP collapse, `pillarnet_lts_tpu/runtime/quantize.py:22-45`).
    Handles single-stage ({'backbone': ...}) and two-stage
    ({'first_stage_cfg': ...}) layouts."""
    stage1 = (model_cfg if "backbone" in model_cfg
              else model_cfg["first_stage_cfg"])
    for comp in ("backbone", "reader", "neck"):
        if comp in stage1 and isinstance(stage1[comp], dict):
            stage1[comp]["quant"] = True
    if head and isinstance(stage1.get("bbox_head"), dict):
        stage1["bbox_head"]["quant"] = True
    return model_cfg


def observers(model):
    """The modules of `model` that calibrate an activation absmax."""
    return [m for m in model.modules()
            if isinstance(m, Calibrated) and m.quant]


@contextlib.contextmanager
def calibration_mode(model):
    """Within: every quant module runs its float path and records its
    absmax in `observed`. Yields the observing modules."""
    obs = observers(model)
    if not obs:
        raise ValueError("no module observes an activation scale: was the "
                         "model built with quant=True? "
                         "(enable_backbone_quant)")
    for m in obs:
        m.observing, m.observed = True, None
    try:
        yield obs
    finally:
        for m in obs:
            m.observing, m.observed = False, None


@torch.no_grad()
def calibrate(model, batches, reduce="max"):
    """Set the int8 activation scales of `model` from calibration batches.

    batches: iterable of (points (B, N, C) f32, points_mask (B, N) bool)
    on the model's device. reduce: how per-batch absmax values merge —
    'max' (never clips a calibration activation) or 'mean' (the average of
    the per-batch maxima, summed left to right as the JAX package does).
    Existing scales are re-collected. Returns `model`, in eval mode."""
    if reduce not in ("max", "mean"):
        raise ValueError(f"unknown reduce {reduce!r}")
    thaw_int8(model)
    model.eval()
    per_batch = []
    with calibration_mode(model) as obs:
        for points, points_mask in batches:
            for m in obs:
                m.observed = None
            model(points, points_mask)
            per_batch.append([m.observed for m in obs])
    if not per_batch:
        raise ValueError("calibrate() needs at least one batch")
    for k, m in enumerate(obs):
        vals = [seen[k] for seen in per_batch]
        if any(v is None for v in vals):
            raise ValueError(f"{type(m).__name__} observed nothing")
        if reduce == "max":
            merged = torch.stack(vals).amax(0)
        else:
            merged = sum(vals) / len(vals)
        m.set_absmax(merged)
    return model


def _int8_convs(model):
    """The calibrated int8 convs of `model`, each with the BN folded into
    it: the (conv, bn) pairs of the modules that pair them (`convs()`)."""
    return [(conv, bn) for m in model.modules() if hasattr(m, "convs")
            for conv, bn in m.convs() if conv.quant_ready()]


def _stacked(model):
    """The modules that freeze int8 params of their own, built from
    several convs: the backbone's fused stage (`PillarResNet`) and each
    SepHead's wide conv (whose `freeze_int8` says whether it froze)."""
    return [m for m in model.modules()
            if hasattr(m, "freeze_int8") and not isinstance(m, MaskedConv)]


def freeze_int8(model):
    """Freeze the int8 params of every calibrated conv of `model` into
    buffers (`MaskedConv.freeze_int8`), the fused stage's stacked ones
    (`PillarResNet.freeze_int8`) and each calibrated SepHead's wide conv
    (`SepHead.freeze_int8`): the int8 forward then reads no tensor's data
    pointer or version, so it traces (`torch.export`), and serves eagerly
    bit-equal to before. Weights or scales changed afterwards need another
    freeze (`calibrate` thaws). Returns the number of frozen convs (a
    SepHead's wide conv counts one); raises if a calibrated conv is in no
    module's pairs."""
    pairs = _int8_convs(model)
    for conv, bn in pairs:
        conv.freeze_int8(bn)
    # after the convs: the fused stage stacks their frozen params
    wide = sum(bool(m.freeze_int8()) for m in _stacked(model))
    frozen = {id(conv) for conv, _ in pairs}
    missed = [name for name, m in model.named_modules()
              if isinstance(m, MaskedConv) and m.quant_ready()
              and id(m) not in frozen]
    if missed:
        raise ValueError(f"calibrated convs outside any (conv, bn) pair: "
                         f"{missed}")
    return len(pairs) + wide


def thaw_int8(model):
    """Undo `freeze_int8`: the int8 params follow the weights again."""
    for m in model.modules():
        if isinstance(m, MaskedConv) or hasattr(m, "freeze_int8"):
            m.thaw_int8()
