"""Plain PyTorch reference of one training step of the single-stage
detector: CenterNet targets from the scene's boxes, the losses, and the
one-cycle AdamW update with clipping by global norm.

Written from CenterPoint's description (arXiv:2006.11275) and its
reference code's conventions: per task a Gaussian heatmap per class
(radius from the box's footprint in cells at a minimum overlap, at least
`min_radius`), the box target at the centre cell (sub-cell offset, z, log
dims, velocity, sin and cos of the yaw, the yaw wrapped to [-pi, pi));
the penalty-reduced focal loss, the L1 box loss weighted per dimension,
the IoU-aware loss (rotated 3D IoU) where the head has an `iou` branch,
and the 1 - GIoU loss of axis-aligned 3D boxes where `reg_iou` says so.
The optimizer is AdamW as optax composes it (clip, then Adam with the
one-cycle schedule's rate and first moment coefficient, b2 0.99,
eps 1e-8 outside the root, decoupled weight decay on every parameter).
"""

import math

import numpy as np
import torch

from .boxes import corners, intersection_area, to_bev
from .model import Reference

PARAM_KINDS = {"conv", "conv_xavier", "linear", "deconv", "bias", "hm_bias",
               "bn_w", "bn_b"}


# ---- targets --------------------------------------------------------------

def gaussian_radius(height, width, min_overlap):
    a1, b1 = 1, height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * a1 * c1)) / 2
    a2, b2 = 4, 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2 ** 2 - 4 * a2 * c2)) / 2
    a3, b3 = 4 * min_overlap, -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


def draw_gaussian(heatmap, center, radius):
    d = 2 * radius + 1
    sigma = d / 6
    m = (d - 1) / 2
    y, x = np.ogrid[-m:m + 1, -m:m + 1]
    g = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    g[g < np.finfo(g.dtype).eps * g.max()] = 0
    cx, cy = int(center[0]), int(center[1])
    h, w = heatmap.shape
    left, right = min(cx, radius), min(w - cx, radius + 1)
    top, bottom = min(cy, radius), min(h - cy, radius + 1)
    hm = heatmap[cy - top:cy + bottom, cx - left:cx + right]
    gg = g[radius - top:radius + bottom, radius - left:radius + right]
    if min(gg.shape) > 0 and min(hm.shape) > 0:
        np.maximum(hm, gg, out=hm)


def targets(boxes, classes, model_cfg, assigner):
    """One scene's targets. boxes (n, 9) [x, y, z, w, l, h, vx, vy, yaw]
    numpy f32, classes (n,) indices into the configuration's class list.
    -> per task dict of numpy arrays: hm (C, H, W), anno_box (M, 10), ind,
    mask, cat (M,), gt_box (M, 7)."""
    r = model_cfg["reader"]
    pc = np.array(r["pc_range"], np.float32)
    size = np.float32(r["pillar_size"])
    grid = np.round((pc[3:5] - pc[:2]) / size).astype(np.int64)
    max_objs = assigner["max_objs"]
    out, offset = [], 0
    for task in model_cfg["bbox_head"]["tasks"]:
        n_cls = len(task["class_names"])
        stride = int(task["stride"])
        tg = grid // stride
        hm = np.zeros((n_cls, tg[1], tg[0]), np.float32)
        anno = np.zeros((max_objs, 10), np.float32)
        gt = np.zeros((max_objs, 7), np.float32)
        ind = np.zeros(max_objs, np.int64)
        mask = np.zeros(max_objs, np.uint8)
        cat = np.zeros(max_objs, np.int64)
        # the task's boxes, grouped by class in the task's class order
        sel = np.concatenate([np.nonzero(classes == offset + c)[0]
                              for c in range(n_cls)]).astype(np.int64)
        for k, j in enumerate(sel[:max_objs]):
            box = boxes[j].copy()
            box[-1] = box[-1] - np.floor(box[-1] / (2 * np.pi) + 0.5) \
                * (2 * np.pi)
            cls = int(classes[j]) - offset
            w = box[3] / (size * stride)
            length = box[4] / (size * stride)
            if w <= 0 or length <= 0:
                continue
            radius = max(assigner["min_radius"],
                         int(gaussian_radius(length, w,
                                             assigner["gaussian_overlap"])))
            ct = np.array([(box[0] - pc[0]) / (size * stride),
                           (box[1] - pc[1]) / (size * stride)], np.float32)
            ci = ct.astype(np.int32)
            if not (0 <= ci[0] < tg[0] and 0 <= ci[1] < tg[1]):
                continue
            draw_gaussian(hm[cls], ct, radius)
            cat[k], ind[k], mask[k] = cls, ci[1] * tg[0] + ci[0], 1
            gt[k] = box[[0, 1, 2, 3, 4, 5, 8]]
            anno[k] = np.concatenate([ct - ci, box[2:3], np.log(box[3:6]),
                                      box[6:8], np.sin(box[8:9]),
                                      np.cos(box[8:9])])
        out.append(dict(hm=hm, anno_box=anno, ind=ind, mask=mask, cat=cat,
                        gt_box=gt))
        offset += n_cls
    return out


def collate(per_scene, device):
    """Per-scene target lists -> per task batched tensors on `device`."""
    return [{k: torch.from_numpy(np.stack([s[t][k] for s in per_scene]))
             .to(device) for k in per_scene[0][t]}
            for t in range(len(per_scene[0]))]


# ---- losses ---------------------------------------------------------------

def _gather(feat, ind):
    """(B, H, W, C) map at flat indices (B, M) -> (B, M, C)."""
    B, H, W, C = feat.shape
    return feat.reshape(B, H * W, C).gather(
        1, ind[..., None].expand(B, ind.shape[1], C))


def _aa_giou(p, g):
    """GIoU of axis-aligned 3D boxes (x, y, z, w, l, h, yaw): the BEV
    extents w along x and l along y, the yaw ignored."""
    def extent(b):
        return b[..., :2] - b[..., 3:5] / 2, b[..., :2] + b[..., 3:5] / 2

    def nz(v):
        return torch.where(v == 0, torch.full_like(v, 1e-6), v)

    plo, phi = extent(p)
    glo, ghi = extent(g)
    top = torch.minimum(p[..., 2] + p[..., 5] / 2, g[..., 2] + g[..., 5] / 2)
    bot = torch.maximum(p[..., 2] - p[..., 5] / 2, g[..., 2] - g[..., 5] / 2)
    inter = (torch.minimum(phi, ghi) - torch.maximum(plo, glo)).clamp_min(0)
    v_inter = inter[..., 0] * inter[..., 1] * (top - bot).clamp_min(0)
    v_union = (p[..., 3] * p[..., 4] * p[..., 5]
               + g[..., 3] * g[..., 4] * g[..., 5] - v_inter)
    outer = (torch.maximum(phi, ghi) - torch.minimum(plo, glo)).clamp_min(0)
    o_h = (torch.maximum(p[..., 2] + p[..., 5] / 2, g[..., 2] + g[..., 5] / 2)
           - torch.minimum(p[..., 2] - p[..., 5] / 2,
                           g[..., 2] - g[..., 5] / 2)).clamp_min(0)
    closure = outer[..., 0] * outer[..., 1] * o_h
    return (v_inter / nz(v_union)
            - (closure - v_union) / nz(closure)).clamp(-1, 1)


def _iou3d_rotated(p, g):
    """Row-aligned rotated 3D IoU of (..., 7) boxes."""
    inter = intersection_area(corners(to_bev(p)), corners(to_bev(g)))
    top = torch.minimum(p[..., 2] + p[..., 5] / 2, g[..., 2] + g[..., 5] / 2)
    bot = torch.maximum(p[..., 2] - p[..., 5] / 2, g[..., 2] - g[..., 5] / 2)
    inter = inter * (top - bot).clamp_min(0)
    vol = p[..., 3] * p[..., 4] * p[..., 5] + g[..., 3] * g[..., 4] * g[..., 5]
    return inter / torch.clamp_min(vol - inter, 1e-6)


def losses(ref, preds, tgts, train_cfg):
    """The summed loss of the batch and the per-task losses."""
    h = ref.cfg["bbox_head"]
    total, per_task = 0.0, []
    for task, p, t in zip(h["tasks"], preds, tgts):
        ind, mask = t["ind"], t["mask"].float()
        n_pos = mask.sum()
        hm = torch.sigmoid(p["hm"]).clamp(1e-4, 1 - 1e-4)   # (B, H, W, C)
        target = t["hm"].permute(0, 2, 3, 1)
        neg = (torch.log(1 - hm) * hm ** 2 * (1 - target) ** 4).sum()
        pos_pred = _gather(hm, ind).gather(2, t["cat"][..., None])[..., 0]
        pos = (torch.log(pos_pred) * (1 - pos_pred) ** 2 * mask).sum()
        hm_loss = (-neg if float(n_pos) == 0
                   else -(pos + neg) / n_pos.clamp_min(1))
        names = ["reg", "height", "dim", "vel", "rot"]
        box = torch.cat([p[k] for k in names], -1)
        l1 = ((_gather(box, ind) - t["anno_box"]) * mask[..., None]).abs()
        l1 = l1.sum((0, 1)) / (n_pos + 1e-4)
        cw = torch.tensor(h["code_weights"], device=l1.device)
        loss = (hm_loss * train_cfg["hm_weight"]
                + (l1 * cw).sum() * train_cfg["bbox_weight"])
        parts = {"hm_loss": hm_loss, "loc_loss": (l1 * cw).sum()}
        if "iou" in p or h.get("reg_iou"):
            decoded = decode_boxes(ref, task, p)
        if "iou" in p:
            pb = _gather(decoded.detach(), ind)
            tgt = 2 * _iou3d_rotated(pb.double(), t["gt_box"].double()) - 1
            il = ((_gather(p["iou"], ind)[..., 0] - tgt.float()).abs()
                  * mask).sum() / (n_pos + 1e-4)
            loss = loss + il * train_cfg["iou_weight"]
            parts["iou_loss"] = il
        if h.get("reg_iou"):
            if h["reg_iou"] != "GIoU":
                raise NotImplementedError(h["reg_iou"])
            g = _aa_giou(_gather(decoded, ind), t["gt_box"])
            rl = ((1 - g) * mask).sum() / (n_pos + 1e-4)
            loss = loss + rl * train_cfg["reg_iou_weight"]
            parts["reg_iou_loss"] = rl
        parts["loss"] = loss
        per_task.append(parts)
        total = total + loss
    return total, per_task


def decode_boxes(ref, task, p):
    """Every location's (x, y, z, w, l, h, yaw) box of one task's maps."""
    B, Hh, Wh, _ = p["reg"].shape
    dev = p["reg"].device
    stride = task["stride"] * ref.pillar
    xs = (torch.arange(Wh, device=dev, dtype=torch.float32)[None, None]
          + p["reg"][..., 0]) * stride + ref.pc_range[0]
    ys = (torch.arange(Hh, device=dev, dtype=torch.float32)[None, :, None]
          + p["reg"][..., 1]) * stride + ref.pc_range[1]
    dim = torch.exp(p["dim"].clamp(-1.2, 3.2))
    rot = torch.atan2(p["rot"][..., 0], p["rot"][..., 1])
    return torch.cat([xs[..., None], ys[..., None], p["height"], dim,
                      rot[..., None]], -1)


# ---- the optimizer ----------------------------------------------------------

def one_cycle(step, total_steps, lr_max, moms, div_factor, pct_start):
    """(lr, b1) of the one-cycle schedule at `step`: the rate rises from
    lr_max / div_factor to lr_max over the first pct_start of the steps and
    falls to lr_max / div_factor / 1e4 (cosine both ways); b1 goes from
    moms[0] to moms[1] and back."""
    def cos(start, end, pct):
        return end + (start - end) / 2 * (math.cos(math.pi * pct) + 1)

    a1 = max(int(total_steps * pct_start), 1)
    low = lr_max / div_factor
    if step < a1:
        pct = min(step / a1, 1.0)
        return cos(low, lr_max, pct), cos(moms[0], moms[1], pct)
    pct = min((step - a1) / max(total_steps - a1, 1), 1.0)
    return cos(lr_max, low / 1e4, pct), cos(moms[1], moms[0], pct)


class ReferenceTrainer:
    """The reference's training run from the benchmark's weights."""

    def __init__(self, config, weights, spec, total_steps):
        self.cfg = config
        self.total_steps = total_steps
        self.w = {k: v.detach().clone() for k, v in weights.items()}
        self.params = {n: self.w[n] for n, _, kind in spec
                       if kind in PARAM_KINDS}
        for p in self.params.values():
            p.requires_grad_(True)
        self.ref = Reference(config["model"], config["test_cfg"], self.w)
        self.ref.train = True
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = 0
        self.first_grads = None

    def step(self, points, points_mask, tgts):
        """One step; returns the loss (a float)."""
        train_cfg = self.cfg["train_cfg"]
        preds = self.ref.forward(points, points_mask)
        total, _ = losses(self.ref, preds, tgts, train_cfg)
        grads = torch.autograd.grad(total, list(self.params.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(self.params.items(), grads)}
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum()
                                  for g in grads.values()))
            max_norm = self.cfg["optimizer_config"]["grad_clip"]["max_norm"]
            if float(norm) >= max_norm:
                grads = {n: g / norm.float() * max_norm
                         for n, g in grads.items()}
            if self.first_grads is None:
                self.first_grads = {n: g.clone() for n, g in grads.items()}
            lc = self.cfg["lr_config"]
            lr, b1 = one_cycle(self.count, self.total_steps, lc["lr_max"],
                               lc["moms"], lc["div_factor"], lc["pct_start"])
            b2, eps = 0.99, 1e-8
            wd = self.cfg["optimizer"]["wd"]
            self.count += 1
            for n, p in self.params.items():
                g = grads[n]
                self.mu[n] = (1 - b1) * g + b1 * self.mu[n]
                self.nu[n] = (1 - b2) * g * g + b2 * self.nu[n]
                u = (self.mu[n] / (1 - b1 ** self.count)) / (
                    torch.sqrt(self.nu[n] / (1 - b2 ** self.count)) + eps)
                p.sub_(lr * (u + wd * p))
        return float(total.detach())
