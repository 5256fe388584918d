"""Epoch-based trainer.

Port of `pillarnet_lts_tpu/runtime/trainer.py`, on one device or on each
rank of a data-parallel group (`parallel/`): the epoch
loop with hook calls (`runtime/hooks.py`), one `train_step` per batch
(`runtime/train_step.py`) with the step's generator from (seed, step),
metrics read back into the `LogBuffer` every step (the JAX trainer's
`device_get`; one `host_syncs` count a metric), each iteration a
`train.iter` span of the tracer (`runtime/tracing.py`) from the batch's
arrival to the end of its `train.metrics_read`, checkpoints with the
config text and class names in their meta, `resume`, and the validation
workflow: `run(..., workflow=[('train', k), ('val', 1)])` infers over the val
loader (`eval_utils.pipelined_infer`), scores the detections with the
dataset's `evaluation` and logs the result. In a group each rank trains
on its shard of every global batch and validates its shard of the val
set; rank 0 scores the gathered detections.
"""

import logging
import os

import torch

from ..parallel.dist import gather_detections, rank
from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .hooks import Hook
from .log_buffer import LogBuffer
from . import tracing
from .train_step import batch_to_device, step_generator, train_step


class Trainer:
    def __init__(self, model, optimizer, train_cfg, work_dir, logger=None,
                 cfg_text=None, class_names=None, seed=0):
        self.model = model
        self.seed = seed
        self.optimizer = optimizer
        self.train_cfg = train_cfg
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self.logger = logger or logging.getLogger("trainer")
        self.cfg_text = cfg_text
        self.class_names = class_names
        self.device = next(model.parameters()).device

        self.epoch = 0
        self.iter = 0
        self.inner_iter = 0
        self.max_epochs = 0
        self.max_iters = 0
        self.epoch_len = 0
        self.log_buffer = LogBuffer()
        self._hooks = []
        self._infer_fn = None

    def register_hook(self, hook):
        if not isinstance(hook, Hook):
            raise TypeError(f"{hook!r} is not a Hook")
        self._hooks.append(hook)

    def call_hook(self, fn_name):
        for hook in self._hooks:
            getattr(hook, fn_name)(self)

    def save_checkpoint(self):
        meta = {"epoch": self.epoch + 1, "iter": self.iter,
                "config": self.cfg_text, "CLASSES": self.class_names}
        path = save_checkpoint(self.work_dir, self.model, self.optimizer,
                               self.epoch + 1, meta)
        self.logger.info("saved checkpoint to %s", path)
        return path

    def resume(self, checkpoint_path=None):
        path = checkpoint_path or latest_checkpoint(self.work_dir)
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {self.work_dir}")
        meta = load_checkpoint(path, self.model, self.optimizer)
        self.epoch = meta["epoch"]
        self.iter = meta["iter"]
        self.logger.info("resumed from %s (epoch %d)", path, self.epoch)
        return meta

    def train_epoch(self, data_loader):
        self.epoch_len = len(data_loader)
        data_loader.set_epoch(self.epoch)
        self.call_hook("before_train_epoch")
        for i, batch in enumerate(data_loader):
            self.inner_iter = i
            with tracing.span("train.iter"):
                self.call_hook("before_train_iter")
                metrics = train_step(
                    self.model, self.optimizer,
                    batch_to_device(batch, self.device), self.train_cfg,
                    step_generator(self.seed, self.iter, self.device))
                with tracing.span("train.metrics_read"):
                    tracing.count("host_syncs", len(metrics))
                    self.log_buffer.update({k: float(v)
                                            for k, v in metrics.items()})
            self.call_hook("after_train_iter")
            self.iter += 1
        self.call_hook("after_train_epoch")
        self.epoch += 1

    def val(self, data_loader, dataset, output_dir=None):
        """Infer over `data_loader` in eval mode, score the detections
        with `dataset.evaluation` (on the trainer's device; results in
        `output_dir`, default `{work_dir}/eval`), log each result line and
        return (detections {token: dict}, the evaluation's result).

        In a data-parallel group `data_loader` is this rank's shard: the
        ranks' detections are gathered and merged by token (which drops
        the shards' wrap-around duplicates), and rank 0 scores them; the
        other ranks return the merged detections and None."""
        from ..eval_utils import (detections_to_host, make_infer_fn,
                                  pipelined_infer)

        test_cfg = self.model.processed_test_cfg()
        if self._infer_fn is None:
            self._infer_fn = make_infer_fn(self.model, test_cfg)
        self.model.eval()  # the cached callable finds it training
        double_flip = bool(test_cfg.get("double_flip", False))

        def make_args(batch):
            return (torch.from_numpy(batch["points"]).to(self.device),
                    torch.from_numpy(batch["points_mask"]).to(self.device))

        def metas_of(batch):
            # predict averages each group of 4 flips into one frame
            return batch["metadata"][::4] if double_flip \
                else batch["metadata"]

        def progress(i):
            if i % 50 == 0:
                self.logger.info("val batch %d/%d", i, len(data_loader))

        detections = {}
        for det, metas in pipelined_infer(self._infer_fn, data_loader,
                                          make_args, metas_of,
                                          on_progress=progress):
            for sample in detections_to_host(det, metas):
                detections[sample["metadata"]["token"]] = sample

        detections = gather_detections(detections)
        if rank() != 0:
            return detections, None
        out_dir = output_dir or os.path.join(self.work_dir, "eval")
        os.makedirs(out_dir, exist_ok=True)
        result, _ = dataset.evaluation(detections, output_dir=out_dir,
                                       device=self.device.type)
        if result is not None:
            for k, v in result.get("results", {}).items():
                self.logger.info("Evaluation %s: %s", k, v)
        return detections, result

    def run(self, data_loader, max_epochs, workflow=None, val_loader=None,
            val_dataset=None):
        """Run a (train[, val]) workflow until `max_epochs` training
        epochs have run (a resumed trainer continues from its epoch).

        workflow: (mode, epochs) pairs cycled in order, e.g.
        [('train', 5), ('val', 1)]; default [('train', 1)]. A 'val' entry
        needs `val_loader`, and scores with `val_dataset` (default: the
        loader's dataset)."""
        workflow = list(workflow or [("train", 1)])
        for mode, _ in workflow:
            if mode not in ("train", "val"):
                raise ValueError(f"unknown workflow mode {mode!r}")
        if any(m == "val" for m, _ in workflow) and val_loader is None:
            raise ValueError("val in workflow requires val_loader")

        self.max_epochs = max_epochs
        self.max_iters = max_epochs * len(data_loader)
        self.logger.info("Start running, work_dir: %s, workflow: %s, "
                         "max epochs: %d", self.work_dir, workflow,
                         max_epochs)
        self.call_hook("before_run")
        while self.epoch < max_epochs:
            for mode, epochs in workflow:
                for _ in range(epochs):
                    if mode == "train":
                        if self.epoch >= max_epochs:
                            break
                        self.train_epoch(data_loader)
                    else:
                        self.val(val_loader, val_dataset
                                 or getattr(val_loader, "dataset", None))
        self.call_hook("after_run")
