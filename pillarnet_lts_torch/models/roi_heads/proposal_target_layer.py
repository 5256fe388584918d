"""RoI target assignment and fixed-size fg/bg subsampling.

Port of `pillarnet_lts_tpu/models/roi_heads/proposal_target_layer.py`:

- per-class max-IoU matching of every RoI against the sample's GT boxes
  (GT rows of class 0 are padding), the IoU from `ops/iou3d.py::
  boxes_iou3d` over the whole batch at once (one K2 launch on the card);
- per sample, ROI_PER_IMAGE slots: up to FG_RATIO of them foreground
  RoIs drawn without replacement (with replacement when the sample has no
  background), the rest background split hard / easy by HARD_BG_RATIO
  and drawn with replacement;
- the 'roi_iou' (soft ramp) or 'cls' (-1 = ignore) classification labels.

The random draws are separate from the index algebra. `sampler_draws`
makes them from a `torch.Generator`: per sample three (R,) uniforms
(fg, hard, easy: a random order of each set) and three (M,) ints in
[0, 2^31 - 1) (the fg, hard and easy picks with replacement), the draws
the JAX package makes from `jax.random.split(key, 6)` per sample.
`proposal_target_layer` takes them as plain tensors, so the same draws
give the same targets bit for bit on either package and either device.
Every shape is static and nothing reads a value back to the host.
"""

from typing import NamedTuple

import numpy as np
import torch

from ...core.utils import f32_reciprocal
from ...ops.iou3d import boxes_iou3d
from ...parallel.mesh import rank_rows

_INT_DRAW_HIGH = 2**31 - 1  # jnp.iinfo(jnp.int32).max, exclusive


class RoiTargets(NamedTuple):
    rois: torch.Tensor            # (B, M, 7+)
    gt_of_rois: torch.Tensor      # (B, M, code + 1) raw (pre-canonical)
    gt_iou_of_rois: torch.Tensor  # (B, M)
    roi_scores: torch.Tensor      # (B, M)
    roi_labels: torch.Tensor      # (B, M)
    reg_valid_mask: torch.Tensor  # (B, M) int32
    rcnn_cls_labels: torch.Tensor  # (B, M)


class SamplerDraws(NamedTuple):
    uniforms: torch.Tensor  # (B, 3, R) f32 in [0, 1): fg, hard, easy order
    ints: torch.Tensor      # (B, 3, M) int64 in [0, 2^31 - 1): fg, hard, easy


def sampler_draws(generator, batch, num_rois, roi_per_image, device):
    """The sampler's draws for one call, from `generator` on its own device,
    moved to `device` (the card's generator on the card's tensors draws
    without a host round trip). In a data-parallel group each rank draws
    for the global batch and keeps its `batch` rows
    (`parallel.mesh.rank_rows`): the rows one process draws for them."""
    gdev = generator.device
    u = rank_rows(lambda size: torch.rand(size, generator=generator,
                                          device=gdev), batch, 3, num_rois)
    r = rank_rows(lambda size: torch.randint(
        0, _INT_DRAW_HIGH, size, generator=generator, device=gdev),
        batch, 3, roi_per_image)
    return SamplerDraws(u.to(device), r.to(device))


def _shuffled_member_indices(u, mask):
    """(B, R) uniforms, (B, R) mask -> member indices in a random order
    (members first, by their uniform; a stable sort, as jnp.argsort's),
    and the member count (B,)."""
    key = torch.where(mask, u, torch.full_like(u, float("inf")))
    return torch.sort(key, dim=-1, stable=True).indices, mask.sum(-1)


def _pick_with_replacement(r, ordered_idx, count):
    """(B, M) draws from the first `count` entries of ordered_idx."""
    pos = r % count.clamp_min(1)[:, None]
    return torch.gather(ordered_idx, 1, pos)


def _subsample(draws, max_overlaps, cfg):
    """(B, R) overlaps -> (B, M) sampled RoI indices."""
    roi_per_image = int(cfg["ROI_PER_IMAGE"])
    fg_per_image = int(round(cfg["FG_RATIO"] * roi_per_image))
    fg_thresh = min(cfg["REG_FG_THRESH"], cfg["CLS_FG_THRESH"])
    hard_ratio = float(np.float32(cfg["HARD_BG_RATIO"]))

    fg_mask = max_overlaps >= fg_thresh
    easy_mask = max_overlaps < cfg["CLS_BG_THRESH_LO"]
    # the reference's hard background: [BG_LO, REG_FG), whatever CLS_FG
    hard_mask = ((max_overlaps < cfg["REG_FG_THRESH"])
                 & (max_overlaps >= cfg["CLS_BG_THRESH_LO"]))

    u, r = draws.uniforms, draws.ints
    fg_idx, n_fg_avail = _shuffled_member_indices(u[:, 0], fg_mask)
    hard_idx, n_hard = _shuffled_member_indices(u[:, 1], hard_mask)
    easy_idx, n_easy = _shuffled_member_indices(u[:, 2], easy_mask)

    # the fg quota: min(fg_per_image, n_fg) when background exists, else
    # every slot fg (or none without fg)
    n_bg_avail = n_hard + n_easy
    n_fg = torch.where(
        n_bg_avail > 0, n_fg_avail.clamp_max(fg_per_image),
        torch.where(n_fg_avail > 0, roi_per_image, 0))
    bg_quota = roi_per_image - n_fg
    hard_num = torch.where(
        (n_hard > 0) & (n_easy > 0),
        torch.minimum((bg_quota.to(torch.float32) * hard_ratio)
                      .to(n_hard.dtype), n_hard),
        torch.where(n_hard > 0, bg_quota, 0))

    slots = torch.arange(roi_per_image, device=max_overlaps.device)
    # fg without replacement (a random permutation's prefix) when
    # background exists, else with replacement
    fg_wo = fg_idx[:, slots.clamp_max(fg_idx.shape[1] - 1)]
    fg_w = _pick_with_replacement(r[:, 0], fg_idx, n_fg_avail)
    fg_pick = torch.where((n_bg_avail > 0)[:, None], fg_wo, fg_w)
    hard_pick = _pick_with_replacement(r[:, 1], hard_idx, n_hard)
    easy_pick = _pick_with_replacement(r[:, 2], easy_idx, n_easy)

    j = slots[None, :] - n_fg[:, None]  # background slot index
    bg_pick = torch.where(j < hard_num[:, None], hard_pick, easy_pick)
    return torch.where(slots[None, :] < n_fg[:, None], fg_pick, bg_pick)


def _match(rois, roi_labels, gt_boxes, gt_labels, by_class):
    """(B, R) max overlaps and the (B, R) index of the matched GT row."""
    gt_valid = gt_labels > 0
    iou = boxes_iou3d(rois[..., :7], gt_boxes[..., :7])  # (B, R, G)
    match = gt_valid[:, None, :]
    if by_class:
        match = (roi_labels[:, :, None] == gt_labels[:, None, :]) & match
    match = match.expand_as(iou)
    masked = torch.where(match, iou, torch.full_like(iou, -1.0))
    max_overlaps = masked.amax(-1).clamp_min(0.0)
    # argmax takes the first of equal maxima, as jnp.argmax
    assignment = torch.where(match.any(-1), masked.argmax(-1), 0)
    return max_overlaps, assignment


def _take(x, idx):
    """x (B, N, ...) rows at idx (B, M) -> (B, M, ...)."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.take_along_dim(x, idx, dim=1)


def proposal_target_layer(rois, roi_scores, roi_labels, gt_boxes_and_cls,
                          cfg, draws):
    """Sample ROI_PER_IMAGE targets per sample.

    rois (B, R, code), roi_scores (B, R), roi_labels (B, R) (1-based, 0 =
    padded slot), gt_boxes_and_cls (B, G, code + 1) (class last, 0 =
    padding); cfg: the head's TARGET_CONFIG; draws: `SamplerDraws`.
    Returns `RoiTargets`."""
    code_size = rois.shape[-1]
    gt_box = gt_boxes_and_cls[..., :code_size]
    gt_cls = gt_boxes_and_cls[..., -1].to(torch.int64)
    max_overlaps, assignment = _match(
        rois, roi_labels, gt_box, gt_cls,
        bool(cfg.get("SAMPLE_ROI_BY_EACH_CLASS", False)))
    sampled = _subsample(draws, max_overlaps, cfg)
    gt_rows = torch.gather(assignment, 1, sampled)
    gt_of_rois = torch.cat(
        [_take(gt_box, gt_rows),
         _take(gt_cls, gt_rows)[..., None].to(gt_boxes_and_cls.dtype)],
        dim=-1)
    ious = torch.gather(max_overlaps, 1, sampled)

    reg_valid_mask = (ious > cfg["REG_FG_THRESH"]).to(torch.int32)
    fg_t, bg_t = cfg["CLS_FG_THRESH"], cfg["CLS_BG_THRESH"]
    if cfg["CLS_SCORE_TYPE"] == "roi_iou":
        fg = ious > fg_t
        interval = ~fg & ~(ious < bg_t)
        # the division by (fg - bg) is a multiply by its f32 reciprocal,
        # as XLA compiles the JAX package's
        ramp = (ious - bg_t) * f32_reciprocal(fg_t - bg_t)
        cls_labels = torch.where(interval, ramp, fg.to(ious.dtype))
    elif cfg["CLS_SCORE_TYPE"] == "cls":
        cls_labels = (ious > fg_t).to(torch.float32)
        ignore = (ious > bg_t) & (ious < fg_t)
        cls_labels = torch.where(ignore, -1.0, cls_labels)
    else:
        raise NotImplementedError(cfg["CLS_SCORE_TYPE"])

    return RoiTargets(
        rois=_take(rois, sampled), gt_of_rois=gt_of_rois,
        gt_iou_of_rois=ious, roi_scores=torch.gather(roi_scores, 1, sampled),
        roi_labels=torch.gather(roi_labels, 1, sampled),
        reg_valid_mask=reg_valid_mask, rcnn_cls_labels=cls_labels)
