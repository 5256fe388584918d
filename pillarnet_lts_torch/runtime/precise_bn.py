"""Precise BN: running statistics recomputed from data with the weights
held.

The port of `pillarnet_lts_tpu/runtime/precise_bn.py`. Running averages
with momentum 0.01 lag the activations' statistics for ~100 steps, so a
short run evaluates with stale ones; precise BN puts in their place the
exact batch statistics (mean, unbiased variance) of a few batches,
averaged per norm. The JAX package recovers each batch's statistics by
extrapolating two train-mode passes of the running-average update (exact
in exact arithmetic; in f32 its error grows as the batch statistic nears
the running one); the port reads them off one pass with momentum 1
(`models/utils/norm.py::exact_statistics`). A norm that the forward does
not reach keeps its statistics, as under the JAX package's
extrapolation.

In a data-parallel group each rank passes its rows of the same global
batches. The cross-replica norm (`models/utils/norm.py`) sums the
statistics over the ranks, so each pass gives the statistics of the
global batch, as the JAX package's pass over its sharded batch does, and
every rank sets the same running statistics.
"""

import torch

from ..models.utils.norm import MaskedBatchNorm, exact_statistics


def recompute_batch_stats(model, batches, seed=0):
    """Set every `MaskedBatchNorm`'s running statistics of `model` to the
    mean over `batches` of each batch's exact statistics, in place, and
    return the model. batches: device batches (`train_step.
    batch_to_device`) with `points`, `points_mask` and, for a two-stage
    model, `gt_boxes_and_cls`; `seed` seeds the generator the two-stage
    forward samples RoIs and drops out with. The model's mode is kept."""
    norms = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    was_training = model.training
    sums, n = None, 0
    model.train()
    try:
        with torch.no_grad(), exact_statistics():
            for batch in batches:
                device = batch["points"].device
                model(batch["points"], batch["points_mask"],
                      gt_boxes_and_cls=batch.get("gt_boxes_and_cls"),
                      generator=torch.Generator(device=device)
                      .manual_seed(seed))
                stats = [(m.running_mean.clone(), m.running_var.clone())
                         for m in norms]
                sums = stats if sums is None else [
                    (a + mean, b + var)
                    for (a, b), (mean, var) in zip(sums, stats)]
                n += 1
    finally:
        model.train(was_training)
    if n:
        with torch.no_grad():
            for m, (mean, var) in zip(norms, sums):
                m.running_mean.copy_(mean / n)
                m.running_var.copy_(var / n)
    return model
