"""Evaluation and latency CLI of the port (the JAX package's
`tools/dist_test.py`).

    python -m pillarnet_lts_torch.tools.dist_test CONFIG
        [--checkpoint P] [--seed N] [--speed_test] [--testset] [--int8]
        [--work_dir D] [--device cuda|cpu]
    torchrun --nproc_per_node N -m pillarnet_lts_torch.tools.dist_test ...

The flow: the config's `data.val` (`data.test` with `--testset`) through
`build_dataset` and the threaded `DataLoader` (`samples_per_gpu` frames a
batch, `workers_per_gpu` threads, padded to `max_points`, every sample's
draws seeded from `--seed`), `make_infer_fn` on the model, the detections
to the host (`detections_to_host`), `prediction.pkl` in the work dir, then
`dataset.evaluation`. It runs on the CUDA card unless `--device cpu` is
given; without a card it raises.

Weights (`--checkpoint`): a checkpoint of the port's trainer
(`runtime/checkpoint.py`), a reference det3d `.pth`
(`runtime/torch_convert.py`), or none: random weights from `--seed`.

`--speed_test`: batch 1, the host synced after every frame, the mean over
the middle third of the frames, on CUDA events and on the host clock.
Default: the pipelined pass (`eval_utils.pipelined_infer`, up to 4
batches in flight), timed with the loader: frames/s over the whole pass
and over the batches of its middle third. `--int8`: the int8 deploy build
of the config (`runtime.quantize.enable_backbone_quant`; any config, f32
or bf16, single- or two-stage: the int8 convs take the config's dtype)
calibrated on the first 8 batches. Double-flip TTA is the config's
(`test_cfg.double_flip` with `DoubleFlip` in its val pipeline, as
`apis.with_double_flip` sets them): 4 clouds a frame, one detection set a
frame.

Under `torchrun` each rank (`parallel/dist.py`: NCCL on the card
`cuda:LOCAL_RANK`, gloo with `--device cpu`) serves its shard of the set (the loader's `num_shards` / `shard_index`, wrap-padded to equal
shards) at `samples_per_gpu` frames a batch, with the speed test or the
pipelined pass timed per rank; `--int8` calibrates every rank on the
same first batches of the whole set. The detections are gathered and
merged by token, and rank 0 writes `prediction.pkl` and scores them.
"""

import argparse
import itertools
import logging
import os
import pickle
import time

import numpy as np
import torch

from ..apis import build_model_from_cfg, load_config
from ..parallel.spatial import refuse
from ..datasets import DataLoader, build_dataset
from ..eval_utils import detections_to_host, make_infer_fn, pipelined_infer
from ..parallel.dist import (gather_detections, init_from_env,
                             process_count, rank, shutdown)
from ..runtime.serving import to_host

CALIB_BATCHES = 8
_QUANT_BUFFERS = ("in_absmax", "scatter_absmax")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate a detector")
    parser.add_argument("config")
    parser.add_argument("--checkpoint", default=None,
                        help="port checkpoint or reference .pth; none: "
                             "random weights from --seed")
    parser.add_argument("--seed", type=int, default=0,
                        help="random weights and the loader's draws")
    parser.add_argument("--work_dir", default=None)
    parser.add_argument("--speed_test", action="store_true")
    parser.add_argument("--testset", action="store_true")
    parser.add_argument("--int8", action="store_true",
                        help="int8 backbone, calibrated on the first "
                             f"{CALIB_BATCHES} batches")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def resolve_device(name):
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dist_test: no CUDA device; pass --device cpu "
                           "to evaluate on the CPU")
    return torch.device(name)


def load_weights(model, path, logger):
    """A port checkpoint (`{'model', 'optimizer', 'meta'}`) or a reference
    state_dict into `model`; an int8 model may miss only its calibration
    buffers, which `calibrate` sets."""
    from ..runtime.checkpoint import is_port_checkpoint
    from ..runtime.torch_convert import (load_reference_checkpoint,
                                         normalize_state_dict)

    blob = torch.load(path, map_location="cpu", weights_only=True)
    if is_port_checkpoint(blob):
        missing, unexpected = model.load_state_dict(blob["model"],
                                                    strict=False)
        bad = unexpected + [k for k in missing
                            if not k.endswith(_QUANT_BUFFERS)]
        if bad:
            raise KeyError(f"checkpoint {path} does not match the model: "
                           f"{bad[:8]}")
        logger.info("loaded checkpoint %s (epoch %s)", path,
                    blob["meta"].get("epoch"))
    else:
        report = load_reference_checkpoint(model, normalize_state_dict(blob))
        logger.info("converted reference checkpoint %s (%d leaves)", path,
                    len(report["converted"]))


def on_device(batch, device):
    return (torch.from_numpy(batch["points"]).to(device),
            torch.from_numpy(batch["points_mask"]).to(device))


def speed_test(infer, loader, device, metas_of, logger):
    """Serial frames at batch 1: returns (detections, speed record)."""
    cuda = device.type == "cuda"
    detections, host, dev = {}, [], []
    for i, batch in enumerate(loader):
        pts, msk = on_device(batch, device)
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if cuda:
            start.record()
        det = infer(pts, msk)
        if cuda:
            end.record()
            torch.cuda.synchronize(device)
        host.append(time.perf_counter() - t0)
        if cuda:
            dev.append(start.elapsed_time(end) / 1e3)
        for sample in detections_to_host(to_host(det), metas_of(batch)):
            detections[sample["metadata"]["token"]] = sample
        if i % 50 == 0:
            logger.info("batch %d/%d", i, len(loader))

    def middle_third(t):
        return t[len(t) // 3:2 * len(t) // 3] or t

    rec = {"frames": len(host),
           "host_ms": float(np.mean(middle_third(host))) * 1e3,
           "host_ms_all": [t * 1e3 for t in host]}
    line = (f"Total time per frame: {rec['host_ms']:.2f} ms "
            f"({1e3 / rec['host_ms']:.2f} FPS) on the host clock")
    if cuda:
        rec["device_ms"] = float(np.mean(middle_third(dev))) * 1e3
        rec["device_ms_all"] = [t * 1e3 for t in dev]
        line += f", {rec['device_ms']:.2f} ms on CUDA events"
    print(f"\n{line}")
    return detections, rec


def pipelined(infer, loader, device, metas_of, logger):
    """Every batch through `pipelined_infer`: returns (detections, the
    pass's frames and wall seconds, loader included, and the rate over
    the batches of its middle third, which leaves out the warm-up; None
    under 3 batches)."""
    def progress(i):
        if i % 50 == 0:
            logger.info("batch %d/%d", i, len(loader))

    detections, done, frames = {}, [], []
    t0 = time.perf_counter()
    for det, metas in pipelined_infer(infer, loader,
                                      lambda b: on_device(b, device),
                                      metas_of, on_progress=progress):
        for sample in detections_to_host(det, metas):
            detections[sample["metadata"]["token"]] = sample
        done.append(time.perf_counter())
        frames.append(len(metas))
    seconds = time.perf_counter() - t0
    rec = {"frames": len(detections), "batches": len(done),
           "seconds": seconds, "frames_per_s": len(detections) / seconds,
           "steady_frames_per_s": None}
    lo, hi = len(done) // 3, 2 * len(done) // 3
    line = (f"{rec['frames']} frames in {seconds:.3f} s "
            f"({rec['frames_per_s']:.2f} frames/s, loader included")
    if len(done) >= 3:
        rec["steady_frames_per_s"] = (sum(frames[lo + 1:hi + 1])
                                      / (done[hi] - done[lo]))
        line += (f"; {rec['steady_frames_per_s']:.2f} frames/s over batches "
                 f"{lo + 1}-{hi} of {len(done)}")
    print(f"\n{line})")
    return detections, rec


def main(argv=None):
    """Run the CLI; returns {'detections', 'result', 'speed', 'work_dir'}
    (the speed record of whichever pass ran; under torchrun the rank's
    speed record, every rank the merged detections, rank 0 the result and
    the others None)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    resolve_device(args.device)
    device = init_from_env(args.device)
    try:
        return _evaluate(args, device)
    finally:
        shutdown()


def _evaluate(args, device):
    logger = logging.getLogger("test")
    cfg = load_config(args.config)
    refuse(cfg["model"], "tools.dist_test")
    work_dir = args.work_dir or cfg["work_dir"]
    os.makedirs(work_dir, exist_ok=True)
    if args.int8:
        from ..runtime.quantize import enable_backbone_quant

        enable_backbone_quant(cfg["model"])

    data = cfg["data"]
    dataset = build_dataset(data["test" if args.testset else "val"])
    loader_args = dict(
        dataset=dataset,
        batch_size=1 if args.speed_test else data["samples_per_gpu"],
        num_workers=data.get("workers_per_gpu", 2),
        max_points=data.get("max_points"), seed=args.seed, drop_last=False)
    loader = DataLoader(**loader_args, num_shards=process_count(),
                        shard_index=rank())

    model = build_model_from_cfg(cfg, device=device, seed=args.seed)
    if args.checkpoint:
        load_weights(model, args.checkpoint, logger)
    if args.int8:
        from ..runtime.quantize import calibrate

        first = [on_device(b, device) for b in itertools.islice(
            DataLoader(**loader_args), CALIB_BATCHES)]
        logger.info("int8: calibrating on %d batches", len(first))
        calibrate(model, first)
    infer = make_infer_fn(model)

    # double-flip TTA: 4 clouds a frame in the batch, one detection set a
    # frame out of predict
    double_flip = bool(cfg["test_cfg"].get("double_flip", False))

    def metas_of(batch):
        return batch["metadata"][::4] if double_flip else batch["metadata"]

    run = speed_test if args.speed_test else pipelined
    detections, speed = run(infer, loader, device, metas_of, logger)
    if process_count() > 1:
        logger.info("rank %d of %d on %s: %s", rank(), process_count(),
                    device, speed)
    detections = gather_detections(detections)
    if rank() != 0:
        return {"detections": detections, "result": None, "speed": speed,
                "work_dir": work_dir}

    with open(os.path.join(work_dir, "prediction.pkl"), "wb") as f:
        pickle.dump(detections, f)
    result, _ = dataset.evaluation(detections, output_dir=work_dir,
                                   testset=args.testset, device=device.type)
    if result is not None:
        for k, v in result["results"].items():
            print(f"Evaluation {k}: {v}")
    return {"detections": detections, "result": result, "speed": speed,
            "work_dir": work_dir}


if __name__ == "__main__":
    main()
