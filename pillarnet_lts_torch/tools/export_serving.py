"""Export a detector's serving request as one `torch.export` program (the
JAX package's `tools/export_serving.py`).

    python -m pillarnet_lts_torch.tools.export_serving CONFIG
        --checkpoint P --out model.pt2 [--batch 1] [--max-points N]
        [--int8] [--calib-batches 8] [--device cuda|cpu]

The program is `eval_utils.ServingModule` of the config's model, traced
at `--batch` clouds of `--max-points` points (default the config's
`data.max_points`): (points (B, N, 5) f32, points_mask (B, N) bool) ->
the padded detection dict, with the weights inside
(`runtime/export.py::export_serving`). `--checkpoint` is a checkpoint of
the port's trainer, a port checkpoint of `tools/convert_torch.py`, or a
reference det3d `.pth`. `--int8` builds the config's int8 deploy model
(`runtime.quantize.enable_backbone_quant`), calibrates it on the first
`--calib-batches` frames of `data.val` (one frame a batch) and bakes the
frozen int8 params in; the JAX package's recommended per-chip deploy is
`--batch 8 --int8`. It traces on the CUDA card unless `--device cpu` is
given (without a card it raises); the program runs on the device it was
traced on, the hand kernels as `torch.ops.pillarnet.*` ops
(`ops/library.py`). Serve it without the rest of the package:

    from pillarnet_lts_torch.runtime.export import load_serving
    serve = load_serving("model.pt2").module()
    with torch.inference_mode():
        det = serve(points, points_mask)
"""

import argparse
import itertools
import logging
import os
import time

import torch

from ..apis import build_model_from_cfg, load_config
from ..parallel.spatial import refuse
from ..runtime.export import export_serving, save_serving
from .dist_test import load_weights, on_device, resolve_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Export a serving program")
    parser.add_argument("config")
    parser.add_argument("--checkpoint", required=True,
                        help="port checkpoint or reference .pth")
    parser.add_argument("--out", required=True, help="output .pt2 path")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--max-points", type=int, default=None,
                        help="points-per-frame padding (default: the "
                             "config's data.max_points)")
    parser.add_argument("--int8", action="store_true",
                        help="bake the calibrated int8 backbone in "
                             "(calibrates on --calib-batches val frames)")
    parser.add_argument("--calib-batches", type=int, default=8)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def calibration_frames(cfg, n, device):
    """The first `n` frames of the config's val set, one a batch, on
    `device`."""
    from ..datasets import DataLoader, build_dataset

    loader = DataLoader(build_dataset(cfg["data"]["val"]), batch_size=1,
                        num_workers=0, max_points=cfg["data"].get("max_points"),
                        drop_last=False)
    return [on_device(b, device) for b in itertools.islice(loader, n)]


def main(argv=None):
    """Run the CLI; returns {'out', 'bytes', 'batch', 'points', 'device',
    'seconds'}."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    logger = logging.getLogger("export")
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    refuse(cfg["model"], "tools.export_serving")
    if args.int8:
        from ..runtime.quantize import enable_backbone_quant

        enable_backbone_quant(cfg["model"])
    model = build_model_from_cfg(cfg, device=device)
    load_weights(model, args.checkpoint, logger)
    if args.int8:
        from ..runtime.quantize import calibrate

        frames = calibration_frames(cfg, args.calib_batches, device)
        print(f"int8: calibrating on {len(frames)} batches")
        calibrate(model, frames)
    n_pts = args.max_points or cfg["data"].get("max_points") or 300_000
    t0 = time.perf_counter()
    program = export_serving(model, args.batch, n_pts, device)
    seconds = time.perf_counter() - t0
    save_serving(program, args.out)
    size = os.path.getsize(args.out)
    print(f"exported {size / 1e6:.1f} MB to {args.out} (batch={args.batch}, "
          f"points={n_pts}, device={device}) in {seconds:.1f} s")
    return {"out": args.out, "bytes": size, "batch": args.batch,
            "points": n_pts, "device": str(device), "seconds": seconds}


if __name__ == "__main__":
    main()
