"""Serving export: a detector as one `torch.export` program, and its file.

The counterpart of the JAX package's `tools/export_serving.py`
(`jax.export` of the jitted inference function, weights baked in). The
program is `eval_utils.ServingModule` traced at a fixed batch and point
count: (points (B, N, 5) f32, points_mask (B, N) bool) -> the padded
detection dict (`box3d_lidar`, `scores`, `label_preds`, `mask`), with the
weights, the BN statistics and the int8 params (frozen for the trace,
`runtime.quantize.freeze_int8`) inside. The hand kernels are opaque ops of
the graph (`ops/library.py`, `torch.ops.pillarnet.*`), so a program traced
on the card launches the same kernels when it runs, and one traced on the
CPU runs their plain versions.

A process that serves a saved program needs torch and `load_serving`'s one
import, `pillarnet_lts_torch.ops.library` (which registers the ops): no
config, no checkpoint, no `models/`:

    from pillarnet_lts_torch.runtime.export import load_serving
    serve = load_serving("model.pt2").module()
    with torch.inference_mode():
        det = serve(points, points_mask)

(The weights are the program's parameters: without `inference_mode` or
`no_grad` the call records autograd history.)
"""

import torch

from ..ops import library  # noqa: F401  (registers the pillarnet ops)


def export_serving(model, batch, max_points, device=None):
    """The `ExportedProgram` of one serving request of `model` (with its
    own test_cfg) at `batch` clouds of `max_points` points of 5 features,
    traced on `device` (default: the model's) under `torch.no_grad`. The
    int8 params of a calibrated int8 model are frozen for the trace
    (`freeze_int8`) and thawed after it: the program keeps the frozen
    tensors, and the model's int8 params follow its weights again."""
    from ..eval_utils import ServingModule
    from ..parallel.spatial import sharded_detectors
    from .quantize import freeze_int8, thaw_int8

    if sharded_detectors(model):
        raise ValueError("export_serving traces one request of one "
                         "process: a model with spatial_axis set shards "
                         "its grid over a group; build it without the key")
    if device is None:
        device = next(model.parameters()).device
    serving = ServingModule(model).eval()
    points = torch.zeros((batch, max_points, 5), device=device)
    points_mask = torch.zeros((batch, max_points), dtype=torch.bool,
                              device=device)
    freeze_int8(model)
    try:
        with torch.no_grad():
            return torch.export.export(serving, (points, points_mask))
    finally:
        thaw_int8(model)


def save_serving(program, path):
    """Write an `ExportedProgram` to `path` (`torch.export.save`, a .pt2
    archive)."""
    torch.export.save(program, path)


def load_serving(path, device=None):
    """Read a program that `save_serving` wrote; with `device`, move its
    weights and constants there (`torch.export.passes.
    move_to_device_pass`). Call `.module()` on the result to serve."""
    from torch.export.passes import move_to_device_pass

    program = torch.export.load(path)
    if device is not None:
        program = move_to_device_pass(program, torch.device(device))
    return program
