"""Evaluation helpers: the inference callable and padded detections ->
per-sample host dicts."""

import numpy as np
import torch
from torch import nn

from .runtime import tracing


class ServingModule(nn.Module):
    """One request of a detector as a module: forward + decode + NMS, the
    role of the JAX package's `eval_utils.make_infer_fn` (weights live in
    the module, so the call takes only the inputs). Eager serving
    (`make_infer_fn`) and the serving export (`runtime/export.py`) both run
    it.

    A single-stage model runs its forward, then `predict` with `test_cfg`;
    a two-stage model (no `predict`: `PillarRCNN`, `TwoStageDetector`; f32,
    bf16 or int8) its forward, with `test_cfg` for its first stage's NMS,
    then `post_process`.

    forward(points (B, N, C) f32, points_mask (B, N) bool) -> the padded
    detection dict, on the model's device, without a host sync. Each call
    is one `serving.request` of the tracer (`runtime/tracing.py`), which
    counts `serving.requests` and the batch's `serving.frames`."""

    def __init__(self, model, test_cfg=None):
        super().__init__()
        self.model = model
        self.test_cfg = (model.processed_test_cfg() if test_cfg is None
                         else test_cfg)

    def forward(self, points, points_mask):
        model = self.model
        with tracing.request("serving.request"):
            tracing.count("serving.requests")
            tracing.count("serving.frames", points.shape[0])
            if hasattr(model, "predict"):
                return model.predict({}, model(points, points_mask),
                                     self.test_cfg)
            return model.post_process(model(points, points_mask,
                                            test_cfg=self.test_cfg))


def make_infer_fn(model, test_cfg=None):
    """`ServingModule(model, test_cfg)` in eval mode as a callable under
    `torch.inference_mode`: infer(points, points_mask) -> the padded
    detection dict."""
    serving = ServingModule(model, test_cfg).eval()

    @torch.inference_mode()
    def infer(points, points_mask):
        return serving(points, points_mask)

    return infer


def pipelined_infer(infer, batches, make_args, metas_of, depth=4,
                    on_progress=None):
    """Run `infer` over `batches` with up to `depth` calls in flight
    (`runtime.serving.ServingPipeline`), yielding (host detections,
    metadata) pairs in batch order: the JAX package's
    `eval_utils.pipelined_infer`, shared by `Trainer.val` and
    `tools/dist_test.py`.

    make_args(batch) -> infer's argument tuple; metas_of(batch) -> the
    per-sample metadata (one per frame: the caller takes every 4th under
    double-flip); on_progress(i) is called per yielded batch. The metadata
    queue fills as the argument generator is consumed, so it stays in
    lockstep with the results."""
    from .runtime.serving import ServingPipeline

    pipe = ServingPipeline(infer, depth=depth)
    metas_q = []

    def _args():
        for batch in batches:
            metas_q.append(metas_of(batch))
            yield make_args(batch)

    for i, det in enumerate(pipe.map(_args())):
        if on_progress is not None:
            on_progress(i)
        yield det, metas_q[i]


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def detections_to_host(det, metadata):
    """Split a batched padded detection dict into per-sample dicts.

    det: {'box3d_lidar': (B, K, D), 'scores': (B, K), 'label_preds': (B, K),
          'mask': (B, K)} (tensors or numpy arrays)
    metadata: list of length B.
    Returns one dict per sample with the padding rows removed.
    """
    boxes = _numpy(det["box3d_lidar"])
    scores = _numpy(det["scores"])
    labels = _numpy(det["label_preds"])
    mask = _numpy(det["mask"]).astype(bool)
    out = []
    for i in range(boxes.shape[0]):
        m = mask[i]
        out.append({
            "box3d_lidar": boxes[i][m],
            "scores": scores[i][m],
            "label_preds": labels[i][m],
            "metadata": metadata[i] if metadata else None,
        })
    return out
