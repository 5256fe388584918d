"""Epoch-based trainer.

Port of `pillarnet_lts_tpu/runtime/trainer.py` for one device: the epoch
loop with hook calls (`runtime/hooks.py`), one `train_step` per batch
(`runtime/train_step.py`) with the step's generator from (seed, step),
metrics read back into the `LogBuffer` every
step (the JAX trainer's `device_get`), checkpoints with the config text
and class names in their meta, and `resume`. The validation workflow
waits.
"""

import logging
import os

from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .hooks import Hook
from .log_buffer import LogBuffer
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
            self.call_hook("before_train_iter")
            metrics = train_step(
                self.model, self.optimizer,
                batch_to_device(batch, self.device), self.train_cfg,
                step_generator(self.seed, self.iter, self.device))
            self.log_buffer.update({k: float(v) for k, v in metrics.items()})
            self.call_hook("after_train_iter")
            self.iter += 1
        self.call_hook("after_train_epoch")
        self.epoch += 1

    def run(self, data_loader, max_epochs):
        """Train until `max_epochs` epochs have run (a resumed trainer
        continues from its epoch)."""
        self.max_epochs = max_epochs
        self.max_iters = max_epochs * len(data_loader)
        self.logger.info("Start running, work_dir: %s, max epochs: %d",
                         self.work_dir, max_epochs)
        self.call_hook("before_run")
        while self.epoch < max_epochs:
            self.train_epoch(data_loader)
        self.call_hook("after_run")
