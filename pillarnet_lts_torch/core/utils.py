"""Misc core helpers (the port's own copy of
`pillarnet_lts_tpu/core/utils.py`, and the device constants of predict)."""

import numpy as np
import torch

_CONSTANTS = {}


def f32_reciprocal(v):
    """1 / v rounded to f32: the constant XLA multiplies by where the JAX
    package divides an f32 array by the constant v (its simplifier turns
    A / c into A * (1 / c)). The port multiplies by it wherever the JAX
    package divides by an inexact constant, so both give the same bits."""
    return float(np.float32(1) / np.float32(v))


def device_constant(values, device, dtype=torch.float32):
    """A 1-D tensor of the python `values` on `device`, made once per
    (values, dtype, device) and cached; callers must not write to it.

    On a CUDA device it goes through pinned host memory with a
    non-blocking copy: a tensor built from a list straight on the card
    (`torch.tensor(..., device=)`) is a pageable copy that PyTorch ends
    with a stream synchronize, which would stall the host inside every
    request.

    Under tracing (`torch.export`, `torch.compile`) it neither pins nor
    caches: the tensor it makes there is the tracer's, a constant of the
    traced graph, and must never reach an eager call."""
    if torch.compiler.is_compiling():
        return torch.tensor(list(values), dtype=dtype, device=device)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (tuple(values), dtype, device)
    t = _CONSTANTS.get(key)
    if t is None:
        host = torch.tensor(list(values), dtype=dtype)
        if device.type == "cuda":
            host = host.pin_memory()
        t = _CONSTANTS[key] = host.to(device, non_blocking=True)
    return t


def set_by_task_cfg(test_cfg, task_num_classes):
    """Re-organize flat per-class test params into per-task lists.

    Port of `det3d/core/utils/center_utils.py:229-274`. Scalars pass through;
    flat per-class lists of length sum(task_num_classes) are regrouped as
    [per-task [per-class]] lists. Used by the multi-class NMS configs (the
    Waymo ones), whose NMS sizes and thresholds are given per class.
    """

    def _param_org(param):
        if isinstance(param, (float, int)):
            return param
        if not isinstance(param, (list, tuple)):
            raise TypeError(f"per-class param must be a list, got {param!r}")
        if len(param) != sum(task_num_classes):
            raise ValueError(f"{len(param)} per-class values for "
                             f"{sum(task_num_classes)} classes")
        ret_list = []
        flag = 0
        for num in task_num_classes:
            ret_list.append(list(param[flag:flag + num]))
            flag += num
        return ret_list

    test_cfg = dict(test_cfg)
    if test_cfg.get("rectifier", False):
        test_cfg["rectifier"] = _param_org(test_cfg["rectifier"])
    if test_cfg.get("use_rectify", False):
        test_cfg["use_rectify"] = _param_org(test_cfg["use_rectify"])

    nms = dict(test_cfg["nms"])
    nms["nms_pre_max_size"] = _param_org(nms["nms_pre_max_size"])
    nms["nms_post_max_size"] = _param_org(nms["nms_post_max_size"])
    nms["nms_iou_threshold"] = _param_org(nms["nms_iou_threshold"])
    test_cfg["nms"] = nms
    return test_cfg
