"""Multi-task center-heatmap detection head.

Port of `pillarnet_lts_tpu/models/bbox_heads/center_head.py`:

- forward: per-scale shared 3x3 conv + BN + ReLU, then per task a SepHead
  whose hidden 3x3 convs (reg/height/dim/rot[/vel][/iou]/hm) share one input
  and run as ONE wide conv, followed by the per-branch projections;
- predict: dense decode, then rotated NMS (score threshold + center-range
  mask, top-`nms_pre_max_size` by rectified score, greedy fixpoint NMS);
  outputs are padded to the NMS post sizes. With `use_rotate_nms`, tasks
  with equal NMS settings share one batched pass; with
  `use_multi_class_nms` (the Waymo configs, per-class sizes and thresholds
  regrouped per task by `core.utils.set_by_task_cfg`) each task runs
  per-class NMS, by default with its classes stacked into the rows of one
  batched pass (`group_classes`), else class by class.

`test_cfg.nms.use_mask_kernel` (a key of the port; default off) builds the
suppression masks with the mask kernel (`ops/nms.py::suppression_matrix`),
the counterpart of the JAX package's `rotated_nms(use_pallas=True)`.

Predict does not sync the host: its constants from `test_cfg` (centre
range, per-row thresholds and pre sizes) are made once per values and
device (`core.utils.device_constant`), and a float IoU threshold reaches
the mask kernel as a launch argument.

Inputs are NCHW maps; the prediction dicts hold NHWC views, the JAX
package's layout, so decode and the tests index channels last. The convs
compute in the input's dtype (bf16 in the bf16 and int8 configs); decode
runs in f32 regardless.

Training (`module.train()`): the shared conv and the fused wide conv run
unfolded with their biases, each head's slice of the wide conv gets a BN
of its own with batch statistics (JAX :123-135); `loss` returns the JAX
package's per-task dict (`models/losses/centernet_loss.py`).

Double-flip TTA (`test_cfg.double_flip`): `predict` averages each group
of 4 flipped clouds into one map set (`_average_double_flip`).

Circular NMS (`test_cfg.circular_nms`, the CenterPoint-style route set by
no config): candidates ranked by score, suppressed where their squared
centre distance is <= the task's `min_radius` (`ops/nms.py::circle_nms`),
with the per-task `nms_pre_max_size` / `nms_post_max_size` / `min_radius`
and tasks of equal settings batched, as the JAX package routes it.

Not ported yet: the head's int8 mode (it raises). `approx_topk` (the
TPU's approximate top-k, `lax.approx_max_k`, set by no config) raises
too.
"""

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.utils import device_constant
from ...ops.nms import (_NMS_SWEEPS, circle_nms, rotated_nms,
                        rotated_nms_dynamic)
from ..backbones.base import MaskedConv
from ..losses.centernet_loss import (fast_focal_loss, iou_loss, iou_reg_loss,
                                     reg_loss)
from ..registry import HEADS
from ..utils.norm import MaskedBatchNorm


class SepHead(nn.Module):
    """Per-target conv branches (`{head}_conv0`, `{head}_bn0`, `{head}_out`),
    each a hidden 3x3 conv + BN + ReLU and a 3x3 projection (every config
    in `configs/` has two convs per branch; other depths raise).

    The branches share their first conv's input, so their kernels (BN
    folded) concatenate into one wide conv."""

    def __init__(self, heads: Dict[str, Tuple[int, int]], in_channels=64,
                 head_conv=64, init_bias=-2.19, device=None):
        super().__init__()
        self.heads = dict(heads)
        self.head_conv = head_conv
        for head, (classes, num_conv) in self.heads.items():
            if num_conv != 2:
                raise NotImplementedError(
                    f"SepHead branch {head!r} with {num_conv} convs")
            setattr(self, f"{head}_conv0",
                    MaskedConv(in_channels, head_conv, device=device))
            setattr(self, f"{head}_bn0",
                    MaskedBatchNorm(head_conv, device=device))
            setattr(self, f"{head}_out", MaskedConv(
                head_conv, classes,
                bias_init=init_bias if "hm" in head else 0.0, device=device))

    def forward(self, x):
        """x (B, C, H, W) -> {head: (B, H, W, classes) NHWC view}."""
        hc = self.head_conv
        convs = [getattr(self, f"{h}_conv0") for h in self.heads]
        bns = [getattr(self, f"{h}_bn0") for h in self.heads]
        if self.training:
            y = F.conv2d(x, torch.cat([c.weight for c in convs]).to(x.dtype),
                         torch.cat([c.bias for c in convs]).to(x.dtype),
                         padding=1)
            y = torch.cat([F.relu(bn(y[:, j * hc:(j + 1) * hc]))
                           for j, bn in enumerate(bns)], dim=1)
        else:
            ws, bs = zip(*(c.folded_params(*bn.fold_factors())
                           for c, bn in zip(convs, bns)))
            y = F.relu(F.conv2d(x, torch.cat(ws).to(x.dtype),
                                torch.cat(bs).to(x.dtype), padding=1))
        return {
            h: getattr(self, f"{h}_out")(y[:, j * hc:(j + 1) * hc])
            .permute(0, 2, 3, 1)
            for j, h in enumerate(self.heads)
        }


class CenterHeadMath:
    """Parameter-free decode/loss/predict math for CenterHead outputs."""

    def __init__(self, tasks, pillar_size, point_cloud_range,
                 code_weights=(), common_heads=None, reg_iou=None):
        self.tasks = [dict(t) for t in tasks]
        self.pillar_size = float(pillar_size)
        self.point_cloud_range = list(point_cloud_range)
        self.code_weights = list(code_weights)
        self.common_heads = dict(common_heads or {})
        self.reg_iou = reg_iou

    @property
    def num_classes(self):
        return [len(t["class_names"]) for t in self.tasks]

    @property
    def task_strides(self):
        return [int(t["stride"]) for t in self.tasks]

    def _decode_dense_boxes(self, preds_dict, task_id, with_vel,
                            pre_activated=False):
        """reg/height/dim/rot maps (B, H, W, *) -> metric (B, H, W, D) boxes,
        in f32. pre_activated: `dim` is already exp-clamped (the
        double-flip average)."""
        if pre_activated:
            dim = preds_dict["dim"]
        else:
            dim = torch.exp(preds_dict["dim"].clamp(-1.2, 3.2))
        rot = torch.atan2(preds_dict["rot"][..., 0:1],
                          preds_dict["rot"][..., 1:2])
        reg = preds_dict["reg"]
        B, H, W, _ = dim.shape
        dev = dim.device
        ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None, None]
        xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :, None]
        xs = xs + reg[..., 0:1]
        ys = ys + reg[..., 1:2]
        stride = self.task_strides[task_id]
        xs = xs * stride * self.pillar_size + self.point_cloud_range[0]
        ys = ys * stride * self.pillar_size + self.point_cloud_range[1]
        parts = [xs, ys, preds_dict["height"], dim]
        if with_vel:
            parts.append(preds_dict["vel"])
        return torch.cat(parts + [rot], dim=-1)

    def loss(self, example, preds_dicts, train_cfg):
        """Training losses (JAX `center_head.py:312-411`): per task the
        focal heatmap loss, the weighted L1 box loss and, per config, the
        IoU-aware and IoU-regression losses. Returns {key: [per-task
        value]} with the JAX keys (`loss`, `hm_loss`, `loc_loss`,
        `loc_loss_elem`, `num_positive`, `iou_loss`, `reg_iou_loss`).

        example: the collated targets on the maps' device, per task `hm`
        (B, C, H, W), `anno_box` (B, M, 10), `ind`, `mask`, `cat` (B, M)
        and `gt_box` (B, M, 7)."""
        rets = []
        for task_id, preds_dict in enumerate(preds_dicts):
            preds_dict = {k: v.float() for k, v in preds_dict.items()}
            pd = {k: v.permute(0, 3, 1, 2) for k, v in preds_dict.items()}
            ind = example["ind"][task_id]
            mask = example["mask"][task_id]
            hm = torch.sigmoid(pd["hm"]).clamp(1e-4, 1 - 1e-4)
            hm_loss = fast_focal_loss(hm, example["hm"][task_id], ind, mask,
                                      example["cat"][task_id])

            target_box = example["anno_box"][task_id]
            names = ["reg", "height", "dim", "vel", "rot"]
            if "vel" not in pd:
                names.remove("vel")
                target_box = target_box[..., [0, 1, 2, 3, 4, 5, -2, -1]]
            box_loss = reg_loss(torch.cat([pd[k] for k in names], dim=1),
                                mask, ind, target_box)
            cw = list(self.code_weights)
            if len(cw) == box_loss.shape[0] + 2 and "vel" not in pd:
                # nuScenes' 10 weights on a task without velocity: drop
                # the vx/vy slots, as the target columns above
                cw = cw[:6] + cw[-2:]
            if len(cw) != box_loss.shape[0]:
                raise ValueError(
                    f"code_weights has {len(self.code_weights)} entries but "
                    f"the box regression target has {box_loss.shape[0]} dims")
            loc_loss = (box_loss * device_constant(cw, box_loss.device)).sum()
            loss = (hm_loss * train_cfg["hm_weight"]
                    + loc_loss * train_cfg["bbox_weight"])
            ret = {"hm_loss": hm_loss, "loc_loss": loc_loss,
                   "loc_loss_elem": box_loss,
                   "num_positive": mask.float().sum()}

            if "iou" in self.common_heads or self.reg_iou is not None:
                boxes = self._decode_dense_boxes(
                    preds_dict, task_id, False).permute(0, 3, 1, 2)
            gt_box = example["gt_box"][task_id]
            if "iou" in self.common_heads:
                il = iou_loss(pd["iou"], mask, ind, boxes.detach(), gt_box)
                loss = loss + il * train_cfg["iou_weight"]
                ret["iou_loss"] = il
            if self.reg_iou is not None:
                rl = iou_reg_loss(boxes, mask, ind, gt_box, kind=self.reg_iou)
                loss = loss + rl * train_cfg["reg_iou_weight"]
                ret["reg_iou_loss"] = rl
            ret["loss"] = loss
            rets.append(ret)
        return {k: [r[k] for r in rets] for k in rets[0]}

    def predict(self, example, preds_dicts, test_cfg):
        """Decode + post-processing. Returns a dict of padded tensors:
        box3d_lidar (B, K, D), scores (B, K), label_preds (B, K) int32,
        mask (B, K) bool; K = sum of the per-task post sizes."""
        del example
        pre_activated = bool(test_cfg.get("double_flip", False))
        if pre_activated:
            # the batch holds groups of 4 flipped clouds (`DoubleFlip`):
            # one averaged, pre-activated map set per frame
            preds_dicts = [_average_double_flip(pd) for pd in preds_dicts]
        task_inputs = []
        class_offsets, offset = [], 0
        for task_id, preds_dict in enumerate(preds_dicts):
            preds_dict = {k: v.float() for k, v in preds_dict.items()}
            hm = (preds_dict["hm"] if pre_activated
                  else torch.sigmoid(preds_dict["hm"]))
            boxes = self._decode_dense_boxes(preds_dict, task_id,
                                             "vel" in preds_dict,
                                             pre_activated)
            if "iou" in preds_dict and pre_activated:
                iou = preds_dict["iou"][..., 0]
            elif "iou" in preds_dict:
                iou = ((preds_dict["iou"][..., 0] + 1.0) * 0.5).clamp(0.0, 1.0)
            else:
                iou = torch.ones(hm.shape[:3], dtype=hm.dtype, device=hm.device)
            task_inputs.append((task_id, boxes, hm, iou))
            class_offsets.append(offset)
            offset += self.num_classes[task_id]

        results = self._post_process_grouped(task_inputs, test_cfg)
        return {
            "box3d_lidar": torch.cat([r[0] for r in results], dim=1),
            "scores": torch.cat([r[1] for r in results], dim=1),
            "label_preds": torch.cat(
                [r[2] + class_offsets[t] for t, r in enumerate(results)], dim=1),
            "mask": torch.cat([r[3] for r in results], dim=1),
        }

    def _post_process_grouped(self, task_inputs, test_cfg):
        """With `circular_nms` or `use_rotate_nms`, tasks with identical
        static NMS settings run through one batched NMS (tasks stacked
        along the batch): circular NMS on the scores, or rotated NMS on
        the rectified scores; otherwise each task runs alone
        (`_post_process_task`)."""
        nms_cfg = test_cfg["nms"]
        if nms_cfg.get("approx_topk", False):
            raise NotImplementedError(
                "approx_topk (the TPU's lax.approx_max_k) is not ported")
        circle = bool(test_cfg.get("circular_nms", False))
        rotate = nms_cfg.get("use_rotate_nms", False)

        def p(x, task_id):
            return x[task_id] if isinstance(x, (list, tuple)) else x

        groups = {}
        for task_id, boxes, hm, iou in task_inputs:
            if circle:
                key = ("circle", tuple(hm.shape[1:3]), boxes.shape[-1],
                       int(p(nms_cfg["nms_pre_max_size"], task_id)),
                       int(p(nms_cfg["nms_post_max_size"], task_id)),
                       float(p(test_cfg["min_radius"], task_id)))
            elif rotate:
                key = ("rotate", tuple(hm.shape[1:3]), boxes.shape[-1],
                       int(p(nms_cfg["nms_pre_max_size"], task_id)),
                       int(p(nms_cfg["nms_post_max_size"], task_id)),
                       float(p(nms_cfg["nms_iou_threshold"], task_id)),
                       float(p(test_cfg.get("rectifier", 0.0), task_id)))
            else:
                key = ("solo", task_id)
            groups.setdefault(key, []).append((task_id, boxes, hm, iou))

        sweeps = int(nms_cfg.get("nms_sweeps", _NMS_SWEEPS))
        mask_kernel = bool(nms_cfg.get("use_mask_kernel", False))
        results = [None] * len(task_inputs)
        for key, members in groups.items():
            if key[0] == "solo":
                task_id, boxes, hm, iou = members[0]
                results[task_id] = self._post_process_task(
                    task_id, boxes, hm, iou, test_cfg)
                continue
            pre_max, post_max = key[3], key[4]
            B = members[0][2].shape[0]
            sc, lb, bx, io = [], [], [], []
            for _, boxes, hm, iou in members:
                hm_flat = hm.reshape(B, -1, hm.shape[-1])
                s, label = hm_flat.max(dim=-1)
                sc.append(s)
                lb.append(label.to(torch.int32))
                bx.append(boxes.reshape(B, -1, boxes.shape[-1]))
                io.append(iou.reshape(B, -1))
            boxes, scores = torch.cat(bx), torch.cat(sc)
            labels, ious = torch.cat(lb), torch.cat(io)
            valid = _candidate_mask(boxes, scores, test_cfg)
            if key[0] == "circle":
                out = _run_nms_batch(boxes, scores, labels, valid, scores,
                                     pre_max, post_max, None, sweeps,
                                     min_radius=key[5])
            else:
                thresh, rect = key[5], key[6]
                rect_scores = (torch.pow(scores, 1.0 - rect)
                               * torch.pow(ious, rect))
                out = _run_nms_batch(boxes, scores, labels, valid,
                                     rect_scores, pre_max, post_max, thresh,
                                     sweeps, use_mask_kernel=mask_kernel)
            for i, (task_id, *_) in enumerate(members):
                results[task_id] = tuple(o[i * B:(i + 1) * B] for o in out)
        return results

    def _post_process_task(self, task_id, boxes, hm, iou, test_cfg):
        """Per-class NMS of one task (`use_multi_class_nms`,
        `box_torch_ops.py:325-359`): (B, H, W, *) maps -> padded
        detections, the classes' post sizes side by side."""
        nms_cfg = test_cfg["nms"]
        if not nms_cfg.get("use_multi_class_nms", False):
            raise NotImplementedError("no NMS mode selected in test_cfg")
        B, H, W, num_cls = hm.shape
        boxes_flat = boxes.reshape(B, H * W, -1)
        scores, labels = hm.reshape(B, H * W, num_cls).max(dim=-1)
        labels = labels.to(torch.int32)
        iou_flat = iou.reshape(B, H * W)
        valid = _candidate_mask(boxes_flat, scores, test_cfg)
        sweeps = int(nms_cfg.get("nms_sweeps", _NMS_SWEEPS))
        mask_kernel = bool(nms_cfg.get("use_mask_kernel", False))

        def p(x):
            return x[task_id] if isinstance(x, (list, tuple)) else x

        # per-class params, regrouped per task by set_by_task_cfg
        rects = p(test_cfg.get("rectifier", [0.0] * num_cls))
        if not isinstance(rects, (list, tuple)):
            rects = [rects] * num_cls
        threshs = [float(t) for t in p(nms_cfg["nms_iou_threshold"])]
        pre_sizes = [int(x) for x in p(nms_cfg["nms_pre_max_size"])]
        post_sizes = [int(x) for x in p(nms_cfg["nms_post_max_size"])]

        def order_scores(k):
            return (torch.pow(scores, 1.0 - rects[k])
                    * torch.pow(iou_flat, rects[k]))

        if nms_cfg.get("group_classes", True):
            # classes stacked into rows of one batched NMS: pre/post padded
            # to the class max, per-row pre limits and thresholds, outputs
            # truncated per class; equal to the per-class loop below
            # (greedy suppression is prefix-stable)
            dev = boxes.device
            out = _run_nms_batch(
                boxes_flat.repeat(num_cls, 1, 1), scores.repeat(num_cls, 1),
                torch.arange(num_cls, dtype=torch.int32, device=dev)
                .repeat_interleave(B)[:, None].expand(-1, H * W),
                torch.cat([valid & (labels == k) for k in range(num_cls)]),
                torch.cat([order_scores(k) for k in range(num_cls)]),
                max(pre_sizes), max(post_sizes),
                device_constant([t for t in threshs for _ in range(B)], dev),
                sweeps,
                pre_limits=device_constant(
                    [n for n in pre_sizes for _ in range(B)], dev,
                    torch.int64),
                use_mask_kernel=mask_kernel)
            return tuple(
                torch.cat([o[k * B:(k + 1) * B, :post_sizes[k]]
                           for k in range(num_cls)], dim=1)
                for o in out)

        outs = [
            _run_nms_batch(boxes_flat, scores, torch.full_like(labels, k),
                           valid & (labels == k), order_scores(k),
                           pre_sizes[k], post_sizes[k], threshs[k], sweeps,
                           use_mask_kernel=mask_kernel)
            for k in range(num_cls)]
        return tuple(torch.cat([o[i] for o in outs], dim=1) for i in range(4))


def _candidate_mask(boxes, scores, test_cfg):
    """Score threshold and centre-range mask of flat (B', P, *) maps."""
    pcr = device_constant(test_cfg["post_center_limit_range"], boxes.device,
                          boxes.dtype)
    dist_ok = ((boxes[..., :3] >= pcr[:3]).all(-1)
               & (boxes[..., :3] <= pcr[3:]).all(-1))
    return (scores > test_cfg["score_threshold"]) & dist_ok


def _run_nms_batch(boxes, scores, labels, valid, order_scores, pre_max,
                   post_max, thresh, sweeps, pre_limits=None,
                   use_mask_kernel=False, min_radius=None):
    """Fixed-size pipeline over rows: mask -> top-`pre_max` by order_scores
    -> rotated NMS (or, with `min_radius`, circular NMS on the centres,
    `thresh` unused) -> first `post_max` kept.

    Ties in order_scores go to the lower index, as `lax.top_k` breaks them
    (a stable descending sort; `torch.topk` promises no order on CUDA);
    the grouped multi-class path's prefix argument rests on it.
    `thresh`: a float, or a (R,) tensor of per-row thresholds (the JAX
    package's per-row `extra` operand). `pre_limits`: optional (R,) per-row
    pre sizes; candidates past a row's limit are invalid, so the row acts
    as if top-k'd at its own size (appended invalid candidates never
    suppress earlier ones)."""
    pre_max = min(pre_max, boxes.shape[1])
    key = torch.where(valid, order_scores, float("-inf"))
    top_vals, top_idx = torch.sort(key, dim=1, descending=True, stable=True)
    top_vals, top_idx = top_vals[:, :pre_max], top_idx[:, :pre_max]
    D = boxes.shape[-1]
    cand_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, D))
    cand_scores = torch.gather(scores, 1, top_idx)
    cand_labels = torch.gather(labels, 1, top_idx)
    cand_valid = top_vals > float("-inf")
    if pre_limits is not None:
        ar = torch.arange(pre_max, device=boxes.device)
        cand_valid = cand_valid & (ar[None, :] < pre_limits[:, None])
    if min_radius is not None:
        sel_idx, sel_mask = circle_nms(cand_boxes[..., :2], cand_valid,
                                       min_radius, post_max)
    else:
        nms = (rotated_nms_dynamic if torch.is_tensor(thresh)
               else rotated_nms)
        sel_idx, sel_mask = nms(cand_boxes, cand_scores, cand_valid, thresh,
                                post_max, sweeps=sweeps,
                                use_mask_kernel=use_mask_kernel)
    return (
        torch.gather(cand_boxes, 1, sel_idx[..., None].expand(-1, -1, D)),
        torch.gather(cand_scores, 1, sel_idx) * sel_mask,
        torch.gather(cand_labels, 1, sel_idx),
        sel_mask,
    )


@HEADS.register_module
class CenterHead(nn.Module):
    def __init__(self, tasks: Sequence[dict], in_channels: Sequence[int],
                 code_weights, common_heads, share_channel=64, reg_iou=None,
                 pillar_size=0.1,
                 point_cloud_range=(-75.2, -75.2, -2, 75.2, 75.2, 4),
                 feat_channels=None, quant=False, device=None):
        """`feat_channels`: channels of each input map (the neck's outputs);
        defaults to `in_channels`. `code_weights`, `common_heads` and
        `reg_iou` also configure the loss. The head's int8 mode
        (`quant=True`, rejected in the JAX package for its mAP cost) is not
        ported."""
        super().__init__()
        if quant:
            raise NotImplementedError("CenterHead: quant=True is not ported")
        self.code_weights = list(code_weights)
        self.common_heads = dict(common_heads)
        self.reg_iou = reg_iou
        self.tasks = [dict(t) for t in tasks]
        self.pillar_size = pillar_size
        self.point_cloud_range = list(point_cloud_range)
        feat_channels = list(feat_channels or in_channels)
        self.num_scales = len(in_channels)
        for k in range(self.num_scales):
            setattr(self, f"share_conv{k}",
                    MaskedConv(feat_channels[k], share_channel, device=device))
            setattr(self, f"share_bn{k}",
                    MaskedBatchNorm(share_channel, device=device))
        strides = sorted({int(t["stride"]) for t in self.tasks}, reverse=True)
        self.task_idx = [strides.index(int(t["stride"])) for t in self.tasks]
        for k, t in enumerate(self.tasks):
            heads = dict(common_heads)
            heads["hm"] = (len(t["class_names"]), 2)
            setattr(self, f"task{k}",
                    SepHead(heads, in_channels=share_channel, device=device))

    def math(self) -> CenterHeadMath:
        return CenterHeadMath(self.tasks, self.pillar_size,
                              self.point_cloud_range, self.code_weights,
                              self.common_heads, self.reg_iou)

    def forward(self, x):
        """x: tuple of NCHW maps, one per scale -> list of per-task dicts of
        NHWC views."""
        if len(x) != self.num_scales:
            raise ValueError(f"expected {self.num_scales} maps, got {len(x)}")
        share = []
        for k in range(self.num_scales):
            conv = getattr(self, f"share_conv{k}")
            bn = getattr(self, f"share_bn{k}")
            y = bn(conv(x[k])) if self.training else \
                conv.folded(x[k], *bn.fold_factors())
            share.append(F.relu(y))
        return [getattr(self, f"task{k}")(share[self.task_idx[k]])
                for k in range(len(self.tasks))]

    def loss(self, example, preds_dicts, train_cfg):
        return self.math().loss(example, preds_dicts, train_cfg)

    def predict(self, example, preds_dicts, test_cfg):
        return self.math().predict(example, preds_dicts, test_cfg)


def _average_double_flip(preds_dict):
    """Double-flip TTA (JAX `center_head.py::_average_double_flip`): the
    batch (4B, H, W, C) comes in groups of 4 (the cloud, its y-flip, its
    x-flip, its xy-flip). Each map is flipped back; `hm` is sigmoided,
    `dim` exp-clamped and `iou` mapped to [0, 1] before the 4-way mean,
    as the reference orders them; `reg`, `rot` and `vel` are unflipped
    (offsets mirrored, signs changed) and averaged raw. Returns (B, H, W,
    C) maps; hm, dim and iou pre-activated."""
    out = {}
    for k, v in preds_dict.items():
        Bq, H, W, C = v.shape
        v = v.float().reshape(Bq // 4, 4, H, W, C)
        out[k] = torch.stack([v[:, 0], v[:, 1].flip(1), v[:, 2].flip(2),
                              v[:, 3].flip((1, 2))], dim=1)

    out["hm"] = torch.sigmoid(out["hm"])
    out["dim"] = torch.exp(out["dim"].clamp(-1.2, 3.2))
    if "iou" in out:
        out["iou"] = ((out["iou"] + 1.0) * 0.5).clamp(0.0, 1.0)

    reg = out["reg"]  # a fresh tensor (stack): edited in place
    reg[:, 1, ..., 1] = 1 - reg[:, 1, ..., 1]
    reg[:, 2, ..., 0] = 1 - reg[:, 2, ..., 0]
    reg[:, 3, ..., 0] = 1 - reg[:, 3, ..., 0]
    reg[:, 3, ..., 1] = 1 - reg[:, 3, ..., 1]

    rot = out["rot"]  # channels (sin, cos)
    rot[:, 1, ..., 1] *= -1
    rot[:, 2, ..., 0] *= -1
    rot[:, 3, ..., 0] *= -1
    rot[:, 3, ..., 1] *= -1

    if "vel" in out:
        vel = out["vel"]
        vel[:, 1, ..., 1] *= -1
        vel[:, 2, ..., 0] *= -1
        vel[:, 3] *= -1

    return {k: v.mean(dim=1) for k, v in out.items()}
