"""High-level entry points of the port."""

import copy
import logging
import os
import pickle
import runpy
import types

import numpy as np
import torch

from .models import build_detector
from .models.utils import init_weights
from .parallel.dist import barrier, process_count, rank
from .parallel.mesh import rank_batch_size, replicate, train_shards
from .parallel.spatial import sharded_detectors
from .runtime.checkpoint import is_port_checkpoint, load_pretrained
from .runtime.hooks import (CheckpointHook, Hook, IterTimerHook,
                            TextLoggerHook)
from .runtime.torch_convert import (load_reference_checkpoint,
                                    normalize_state_dict)
from .runtime.trainer import Trainer
from .datasets.loader import DataLoader
from .solver import build_optimizer


def load_config(filename):
    """Read a python-file config (`configs/*.py`) into a dict: the file runs
    as a module, and every module-level name that is not a dunder, a module
    or a callable becomes an entry."""
    ns = runpy.run_path(os.path.abspath(filename))
    return {k: v for k, v in ns.items()
            if not k.startswith("__") and not callable(v)
            and not isinstance(v, types.ModuleType)}


# the second-stage variants of the JAX package that no config in
# `configs/` sets, selected as config overrides (`rcnn_variant`)
RCNN_VARIANTS = ("MLPMixer", "ResMLP", "RoIFFNHead", "ATT_MODEL")


def rcnn_variant(model_cfg, variant):
    """A copy of a two-stage model config with one second-stage variant:
    `RoIMIXHead`'s token mixer ("MLPMixer", "ResMLP"), `RoIFFNHead` with
    its IoU branch at the JAX package's defaults (content_dim 256,
    feedforward_channels 2048, num_ffn_fcs 2, num_iou_fcs 1), or the point
    head's `ATT_MODEL`. The same keys may be set in a config file."""
    m = copy.deepcopy(model_cfg)
    head = m["roi_head"]
    if variant in ("MLPMixer", "ResMLP"):
        head["mixer_type"] = variant
    elif variant == "RoIFFNHead":
        m["roi_head"] = dict(
            type="RoIFFNHead", model_cfg=head["model_cfg"], num_iou_fcs=1,
            content_dim=256, feedforward_channels=2048, num_ffn_fcs=2,
            code_size=head.get("code_size", 7))
    elif variant == "ATT_MODEL":
        m["point_head"]["model_cfg"]["ATT_MODEL"] = True
    else:
        raise ValueError(f"unknown two-stage variant {variant!r}")
    return m


def build_model_from_cfg(cfg, device="cuda", seed=0):
    """Build the detector of a config (`load_config`) on `device`, in eval
    mode, with weights drawn from `seed` (load trained weights afterwards
    with `runtime.convert.load_jax_variables`)."""
    model = build_detector(dict(cfg["model"]), train_cfg=cfg.get("train_cfg"),
                           test_cfg=cfg["test_cfg"], device=device)
    return init_weights(model, seed)


def build_int8_model(cfg, calib_batches, device="cuda", seed=0,
                     reduce="max", variables=None):
    """Build an int8 deploy config (`configs/*_int8.py`, or any config
    after `runtime.quantize.enable_backbone_quant(cfg["model"])`: f32 or
    bf16, single- or two-stage), calibrate it and return the servable
    model.

    Weights come from `seed`, or from a JAX variables tree (`variables`,
    numpy leaves, without a 'quant' collection). calib_batches: a few
    (points, points_mask) pairs on `device`, the clouds the activation
    scales are taken from (float forwards in the config's compute dtype;
    `reduce` 'max' or 'mean'). The int8 convs then take activations in
    that dtype (`ops/quant.py`: K4's bf16 or f32 variant on the card).
    Serve the result with `eval_utils.make_infer_fn`."""
    from .runtime.convert import load_jax_variables
    from .runtime.quantize import calibrate

    model = build_model_from_cfg(cfg, device=device, seed=seed)
    if variables is not None:
        load_jax_variables(model, variables)
    return calibrate(model, calib_batches, reduce=reduce)


@torch.no_grad()
def spread_head_outputs(model, points, points_mask):
    """Rescale every head projection of a random-weight model so that, on
    this input, its outputs have median 0 (heatmaps: the prior -2.19) and a
    robust spread (1.4826 x median absolute deviation) of 1 (heatmaps: 2).

    Random weights otherwise give head outputs of ~1e3: every decoded box
    centre leaves `post_center_limit_range` and NMS sees no valid candidate.
    Returns {(task, head): (scale, bias)}, numpy per output channel, so a
    JAX weight tree can take the same change (`kernel *= scale`,
    `bias = bias`). A two-stage model's first stage (`single_det`) takes
    the change.
    """
    det = getattr(model, "single_det", model)
    preds = det(points, points_mask)
    factors = {}
    for k, pd in enumerate(preds):
        for h, out in pd.items():
            conv = getattr(getattr(det.head_net, f"task{k}"), f"{h}_out")
            z = (out - conv.bias).flatten(0, -2).cpu().numpy()
            med = np.median(z, axis=0)
            mad = 1.4826 * np.median(np.abs(z - med), axis=0)
            scale = (2.0 if h == "hm" else 1.0) / np.maximum(mad, 1e-6)
            bias = (-2.19 if h == "hm" else 0.0) - med * scale
            conv.weight.mul_(torch.from_numpy(scale).to(conv.weight)
                             [:, None, None, None])
            conv.bias.copy_(torch.from_numpy(bias))
            factors[(k, h)] = (scale, bias)
    return factors


def optimizer_from_cfg(model, cfg, total_steps):
    """The config's optimizer over `total_steps` steps, with its gradient
    clip (`optimizer_config.grad_clip.max_norm`)."""
    clip = (cfg.get("optimizer_config") or {}).get("grad_clip")
    return build_optimizer(model.parameters(), cfg["optimizer"],
                           cfg["lr_config"], total_steps,
                           clip["max_norm"] if clip else None)


def apply_pretrained(model, model_cfg, logger=None):
    """Load a config's `pretrained` weights into `model`, in place:
    `model.pretrained` into the whole model, `model.first_stage_cfg.
    pretrained` into a PillarRCNN's first stage (`single_det`). A source
    is a checkpoint of the port's trainer (`runtime.checkpoint.
    load_pretrained`, by name and shape) or a reference det3d `.pth`
    (`runtime.torch_convert`, whole model only, non-strict). As in the
    JAX package, a file that is missing or cannot be read logs a warning
    and training goes on from the weights the model has."""
    logger = logger or logging.getLogger("train")
    specs = []
    if model_cfg.get("pretrained"):
        specs.append((model_cfg["pretrained"], None))
    if (model_cfg.get("first_stage_cfg") or {}).get("pretrained"):
        specs.append((model_cfg["first_stage_cfg"]["pretrained"],
                      "single_det"))
    for path, subtree in specs:
        try:
            blob = torch.load(path, map_location="cpu", weights_only=True)
            if is_port_checkpoint(blob):
                load_pretrained(model, blob, subtree=subtree, logger=logger)
            elif subtree is not None:
                raise ValueError("a reference checkpoint loads into the "
                                 "whole model only")
            else:
                rep = load_reference_checkpoint(
                    model, normalize_state_dict(blob), strict=False)
                logger.info("converted reference checkpoint %s (%d leaves, "
                            "%d missing)", path, len(rep["converted"]),
                            len(rep["missing"]))
            logger.info("init weight from %s", path)
        except (OSError, RuntimeError, ValueError, KeyError,
                pickle.UnpicklingError) as e:
            logger.warning("no pretrained model at %s (%s)", path, e)


class _EpochBarrier(Hook):
    """Every rank waits at the end of an epoch until rank 0 has run its
    hooks before this one (the checkpoint); nothing without a group."""

    def after_train_epoch(self, trainer):
        barrier()


def train_detector(model, dataset, cfg, logger=None, resume_from=None,
                   cfg_text=None, work_dir=None, hooks=(), seed=0,
                   val_dataset=None):
    """Train `model` (on its device) on `dataset` as the config says:
    batches of `data.samples_per_gpu` padded to `data.max_points`,
    shuffled per epoch (`np.random.RandomState(seed + epoch)`, which also
    seeds each sample's draws), made by `data.workers_per_gpu` loader
    threads; the config's `pretrained` weights (`apply_pretrained`); its
    optimizer and lr schedule over all `total_epochs`; a log every
    `log_config.interval` steps and a checkpoint every
    `checkpoint_config.interval` epochs under `work_dir` (default: the
    config's), then `hooks`. `resume_from` a checkpoint path, or True for
    the latest. `seed`: the run's, which seeds the loader and, with the
    step count, each step's generator (RoI sampling, dropout).
    With `val_dataset`, each epoch is followed by its evaluation
    (`Trainer.run`'s workflow [('train', 1), ('val', 1)]), read in batches
    of `data.samples_per_gpu`. Returns the `Trainer`.

    In a data-parallel group (`parallel.dist.init_from_env`) a step takes
    `samples_per_gpu` frames per node, as the JAX package's mesh does:
    each rank loads its `samples_per_gpu / LOCAL_WORLD_SIZE` rows of the
    global batch, in the JAX package's order (`parallel.mesh.
    train_shards`: the node's stripe of the epoch, the rank's contiguous
    block of the node's batch), and validates its shard of the val set
    (`num_shards` = the ranks, `shard_index` = its rank); the
    model starts from rank 0's state (`parallel.mesh.replicate`, after the
    pretrained weights and the resume). The hooks that write files
    (`Hook.writes`: the logs, the checkpoints, `hooks` of that kind) run
    on rank 0 only, and every rank waits at the end of an epoch until
    rank 0 has written its checkpoint."""
    logger = logger or logging.getLogger("train")
    if process_count() > 1 and sharded_detectors(model):
        raise ValueError(
            "a data-parallel run with spatial_axis set: the group either "
            "splits the batch or the BEV grid; train a spatially sharded "
            "model with runtime.train_step.train_step on every rank")
    data = cfg["data"]
    workers = data.get("workers_per_gpu", 2)
    batch = rank_batch_size(data["samples_per_gpu"])
    loader = DataLoader(dataset, batch, shuffle=True, num_workers=workers,
                        max_points=data["max_points"], seed=seed,
                        **train_shards())
    val_loader, workflow = None, None
    if val_dataset is not None:
        val_loader = DataLoader(val_dataset, batch, num_workers=workers,
                                max_points=data["max_points"],
                                drop_last=False, num_shards=process_count(),
                                shard_index=rank())
        workflow = [("train", 1), ("val", 1)]
    total_epochs = cfg["total_epochs"]
    optimizer = optimizer_from_cfg(model, cfg, total_epochs * len(loader))
    trainer = Trainer(model, optimizer, dict(cfg["train_cfg"]),
                      work_dir or cfg["work_dir"], logger=logger,
                      cfg_text=cfg_text,
                      class_names=list(cfg.get("class_names") or []),
                      seed=seed)
    for hook in [IterTimerHook(),
                 TextLoggerHook(
                     (cfg.get("log_config") or {}).get("interval", 10),
                     logger),
                 CheckpointHook(
                     (cfg.get("checkpoint_config") or {}).get("interval", 1)),
                 _EpochBarrier(), *hooks]:
        if rank() == 0 or not hook.writes:
            trainer.register_hook(hook)
    apply_pretrained(model, cfg["model"], logger)
    if resume_from:
        trainer.resume(None if resume_from is True else resume_from)
    replicate(model)
    trainer.run(loader, total_epochs, workflow=workflow,
                val_loader=val_loader, val_dataset=val_dataset)
    return trainer


def with_double_flip(cfg, split="val"):
    """A copy of config `cfg` that serves with double-flip TTA: the
    `split` pipeline gets `DoubleFlip` before its `Reformat`, which
    returns the 4 clouds of each frame, and `test_cfg.double_flip` is set,
    so that predict averages them back to one detection set per frame."""
    import copy

    cfg = copy.deepcopy(cfg)
    cfg["test_cfg"]["double_flip"] = True
    pipeline = cfg["data"][split]["pipeline"]
    at = next(i for i, st in enumerate(pipeline) if st["type"] == "Reformat")
    pipeline[at] = dict(pipeline[at], double_flip=True)
    pipeline.insert(at, dict(type="DoubleFlip"))
    return cfg
