"""Evaluation helpers: the inference callable and padded detections ->
per-sample host dicts."""

import numpy as np
import torch


def make_infer_fn(model, test_cfg=None):
    """Forward + decode + NMS for inference, the role of the JAX package's
    `eval_utils.make_infer_fn` (weights live in the module, so the callable
    takes only the inputs).

    A two-stage model (no `predict`: `PillarRCNN`) runs its forward, with
    `test_cfg` for its first stage's NMS, then `post_process`.

    Returns infer(points (B, N, C) f32, points_mask (B, N) bool) -> the
    padded detection dict, on the model's device, without a host sync."""
    if test_cfg is None:
        test_cfg = model.processed_test_cfg()
    model.eval()

    if not hasattr(model, "predict"):
        @torch.inference_mode()
        def infer(points, points_mask):
            return model.post_process(model(points, points_mask,
                                            test_cfg=test_cfg))
        return infer

    @torch.inference_mode()
    def infer(points, points_mask):
        preds = model(points, points_mask)
        return model.predict({}, preds, test_cfg)

    return infer


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
