"""Trainer hooks: iteration timer, text/json logger, TensorBoard logger,
per-epoch checkpoint.

Port of the JAX package's `runtime/hooks.py` (`Hook`, `IterTimerHook`,
`TextLoggerHook`, `TensorboardLoggerHook`, `CheckpointHook`). A hook that
writes files says so (`writes`): in a data-parallel group
`apis.train_detector` registers it on rank 0 only.
"""

import datetime
import json
import logging
import os

from . import tracing


class Hook:
    writes = False  # whether it writes log or checkpoint files

    def before_run(self, trainer):
        pass

    def after_run(self, trainer):
        pass

    def before_train_epoch(self, trainer):
        pass

    def after_train_epoch(self, trainer):
        pass

    def before_train_iter(self, trainer):
        pass

    def after_train_iter(self, trainer):
        pass


class IterTimerHook(Hook):
    """Per-iteration host seconds from the tracer's spans
    (`runtime/tracing.py`): `data_time`, the batch's copy to the device
    (`train.feed`), and `time`, the iteration from the batch's arrival to
    its metrics on the host (`train.iter`; the metric read waits for the
    step, so this is the step's time, not its issue). Nothing at the
    `off` level."""

    def after_train_iter(self, trainer):
        for key, name in (("data_time", "train.feed"), ("time", "train.iter")):
            rec = tracing.last(name)
            if rec is not None:
                trainer.log_buffer.update(
                    {key: (rec["end_ns"] - rec["start_ns"]) * 1e-9})


class TextLoggerHook(Hook):
    """Metrics averaged over `interval` iterations, logged and appended to
    `{work_dir}/log.json` as one json record per event."""

    writes = True

    def __init__(self, interval=10, logger=None):
        self.interval = interval
        self.logger = logger or logging.getLogger("trainer")
        self._json_path = None

    def before_run(self, trainer):
        self._json_path = os.path.join(trainer.work_dir, "log.json")

    def after_train_iter(self, trainer):
        if (trainer.inner_iter + 1) % self.interval != 0:
            return
        trainer.log_buffer.average(self.interval)
        out = trainer.log_buffer.output
        eta = ""
        if "time" in out:
            remaining = (trainer.max_iters - trainer.iter) * out["time"]
            eta = f", eta {datetime.timedelta(seconds=int(remaining))}"
        parts = ", ".join(f"{k}: {v:.4f}" for k, v in out.items()
                          if k not in ("time", "data_time"))
        self.logger.info("Epoch [%d/%d][%d/%d] time: %.3f, data: %.3f%s | %s",
                         trainer.epoch + 1, trainer.max_epochs,
                         trainer.inner_iter + 1, trainer.epoch_len,
                         out.get("time", 0.0), out.get("data_time", 0.0),
                         eta, parts)
        record = dict(out, epoch=trainer.epoch + 1, iter=trainer.iter,
                      mode="train")
        with open(self._json_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        trainer.log_buffer.clear_output()


class TensorboardLoggerHook(Hook):
    """The metrics averaged over `interval` iterations as TensorBoard
    scalars `train/<key>` at the global iteration, written through
    `torch.utils.tensorboard` under `log_dir` (default
    `{work_dir}/tf_logs`). Without the `tensorboard` package it does
    nothing and logs one warning."""

    writes = True

    def __init__(self, log_dir=None, interval=10):
        self.log_dir = log_dir
        self.interval = interval
        self.writer = None

    def before_run(self, trainer):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            trainer.logger.warning("TensorBoard logging is off (%s)", e)
            return
        self.writer = SummaryWriter(
            self.log_dir or os.path.join(trainer.work_dir, "tf_logs"))

    def after_train_iter(self, trainer):
        if self.writer is None or (trainer.inner_iter + 1) % self.interval:
            return
        trainer.log_buffer.average(self.interval)
        for k, v in trainer.log_buffer.output.items():
            self.writer.add_scalar(f"train/{k}", v, trainer.iter)

    def after_run(self, trainer):
        if self.writer is not None:
            self.writer.close()
            self.writer = None


class CheckpointHook(Hook):
    """A checkpoint every `interval` epochs."""

    writes = True

    def __init__(self, interval=1):
        self.interval = interval

    def after_train_epoch(self, trainer):
        if (trainer.epoch + 1) % self.interval == 0:
            trainer.save_checkpoint()
