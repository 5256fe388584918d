"""One training step: forward, losses, backward, clip and AdamW update.

Port of `pillarnet_lts_tpu/parallel/train_step.py::make_train_step` (and
the update of `parallel/train_state.py`), on one device or on each rank
of a data-parallel group (`train_step`): the model runs in
training mode (batch statistics, running statistics updated once), the
task losses are summed in task order, the optimizer clips and steps
(`solver/optim.py`), and the metrics carry the JAX keys: `loss`, every
per-task `*_loss` and `num_positive` as `<key>_task<t>`, and `grad_norm`,
the global norm of the unclipped gradients. Metrics stay on the device
(0-d tensors); reading them syncs the host.

The model gets the batch's `gt_boxes_and_cls` and a generator, which the
two-stage detector draws its RoI samples and dropout from. The trainer
makes one per step from (run seed, step) (`step_generator`), as the JAX
package folds the step into its base key, so a step resumed from a
checkpoint draws what the uninterrupted run drew.

A bf16 model (`dtype="bfloat16"`) trains as the JAX package trains one:
its parameters and the optimizer's state stay in f32, the layers compute
in bf16 with the parameters cast, the masked BN takes its batch
statistics in f32, and the losses take the heads' outputs as the JAX
package's do (the CenterNet losses cast them to f32).
"""

import numpy as np
import torch

from ..parallel.dist import (broadcast_gradients, splits_batch,
                             sum_gradients_over_ranks, sum_over_ranks)
from ..parallel.spatial import partial_parameters

_TARGET_KEYS = ("hm", "anno_box", "ind", "mask", "cat", "gt_box")
_ARRAY_KEYS = ("points", "points_mask", "gt_boxes_and_cls")


def batch_to_device(batch, device):
    """The tensors of a collated numpy batch (`datasets/collate.py`) on
    `device`: points, points_mask, gt_boxes_and_cls and the per-task
    target lists."""
    out = {k: torch.from_numpy(batch[k]).to(device)
           for k in _ARRAY_KEYS if k in batch}
    for k in _TARGET_KEYS:
        if k in batch:
            out[k] = [torch.from_numpy(a).to(device) for a in batch[k]]
    return out


def step_generator(seed, step, device):
    """The generator of training step `step` of a run seeded `seed`, on
    `device`: its seed is a hash of the pair (numpy's SeedSequence)."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def step_losses(model, batch, train_cfg=None, generator=None):
    """The training forward of a device batch: (the summed loss, the
    per-task loss dict). generator: the step's (`step_generator`), which a
    two-stage model needs."""
    model.train()
    preds = model(batch["points"], batch["points_mask"],
                  gt_boxes_and_cls=batch.get("gt_boxes_and_cls"),
                  generator=generator)
    losses = model.loss(batch, preds, train_cfg)
    total = losses["loss"][0]
    for task_loss in losses["loss"][1:]:
        total = total + task_loss
    return total, losses


def train_step(model, optimizer, batch, train_cfg=None, generator=None):
    """One step on a device batch (`batch_to_device`); returns the metrics
    dict of 0-d tensors.

    In a data-parallel group (`parallel/dist.py`) the batch is this rank's
    rows of the global one and `generator` is the same on every rank. The
    rank's loss is its share of the global loss (the losses divide by
    global counts), so the gradients are summed over the ranks (one
    collective, a sum and not DDP's mean) before the clip and the update,
    which are then the global ones, as is `grad_norm`; the other metrics
    are summed over the ranks (one more collective), which makes them the
    global batch's.

    Under spatial sharding (`parallel/spatial.py`) every rank holds the
    whole batch and computes the whole loss; only the parameters that
    see one band of the grid (the reader's, conv1's and conv2's:
    `spatial.partial_parameters`) have a share of their gradient, and
    only theirs are summed; every other gradient is whole on every rank,
    equal up to a nondeterministic kernel's last bits, and rank 0's is
    taken (`broadcast_gradients`), so the ranks' replicas stay identical;
    the metrics are every rank's already."""
    total, losses = step_losses(model, batch, train_cfg, generator)
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    partial = partial_parameters(model)
    if partial is not None:
        ids = {id(p) for p in partial}
        broadcast_gradients([p for p in params if id(p) not in ids])
        params = [p for p in params if id(p) in ids]
    sum_gradients_over_ranks(params)
    metrics = {"loss": total.detach()}
    for k, vals in losses.items():
        if k != "loss" and (k.endswith("_loss") or k == "num_positive"):
            for t, v in enumerate(vals):
                metrics[f"{k}_task{t}"] = v.detach()
    if splits_batch():
        summed = sum_over_ranks(torch.stack(list(metrics.values())))
        metrics = dict(zip(metrics, summed.unbind()))
    metrics["grad_norm"] = optimizer.step()
    return metrics


def bn_shifted_biases(model):
    """Names of the conv biases that a training-mode BN follows directly
    (the SubM convs of the backbone, the head's shared conv and its
    branches' first convs). Batch statistics remove any per-channel shift,
    so their gradient is zero in exact arithmetic and rounding noise in
    practice; Adam scales that noise to steps of about the learning rate
    in either direction, so two implementations agree on these biases only
    to within twice the summed learning rates, and on nothing else."""
    from ..models.backbones.base import MaskedConv

    return sorted(f"{name}.bias" for name, m in model.named_modules()
                  if isinstance(m, MaskedConv) and m.bias is not None
                  and not name.endswith("_out"))
