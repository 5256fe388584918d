"""Rotated and circular greedy NMS with static shapes, batched over tasks
and samples.

Port of `pillarnet_lts_tpu/ops/nms.py` (the rotated paths and
`circle_nms`). Suppression is
the fixed-sweep fixpoint of `_greedy_suppress` (batched matvecs), so the
whole NMS runs on the device with no host sync: fixed K candidates in, fixed
`post_max_size` slots out (padded, validity-masked).

Two routes to the suppression mask M[j, i] = (j < i) & (IoU(j, i) > t):

- default: the pairwise IoU from `iou3d.rotated_iou_bev` (the overlap
  kernel, `csrc/rotated_overlap.cu`, with w * l box areas), thresholded;
- `use_mask_kernel=True`: `suppression_matrix`, the suppression-mask kernel
  (`csrc/suppression_mask.cu`), the counterpart of the JAX package's
  `use_pallas=True` route (`nms_kernel.py::suppression_matrix_pallas`). Its
  IoU is that kernel's own formula (shoelace areas, one running sum over
  both clip directions), so a decision may differ from the default route's
  on a pair whose IoU lies within rounding of its threshold. Off by
  default, as in the JAX package.
"""

import torch

from ..core.utils import device_constant
from . import _kernels
from .iou3d import _ENLARGE, _scale_quad, box_corners_bev, check_pair_tiles, \
    rotated_iou_bev, to_pcdet_bev

# Number of fixpoint sweeps: exact greedy for every suppression chain of
# depth <= this (`test_cfg.nms.nms_sweeps` overrides it).
_NMS_SWEEPS = 16

_EPS = 1e-8
_BIG = 1e9
# area(B+) = area(B) * (1 + _ENLARGE)^2: the mask kernel divides it back out
_ENLARGE_SQ = (1.0 + _ENLARGE) ** 2
# row boxes per chunk of the plain mask: bounds the (R, rows, K) temporaries
_PLAIN_ROWS = 256


def _greedy_suppress_mask(m, valid, sweeps=_NMS_SWEEPS):
    """Greedy fixpoint given a precomputed suppression mask
    m (..., K, K) f32, M[j, i] = (j < i) & (iou > t); valid (..., K)."""
    keep = valid
    for _ in range(sweeps):
        keep_f = keep.to(torch.float32)[..., None, :]
        keep = valid & ~((keep_f @ m)[..., 0, :] > 0.0)
    return keep


def _greedy_suppress(iou, valid, thresh, sweeps=_NMS_SWEEPS):
    """Greedy suppression over score-descending boxes.

    With M[j, i] = (j < i) & (iou[j, i] > thresh), the greedy keep set is the
    fixpoint of keep_i <- valid_i & ~any_j(M[j, i] & keep_j), starting from
    keep = valid; `sweeps` iterations are exact for chains up to that depth.

    Args:
      iou: (..., K, K) pairwise IoU, rows/cols in score order (desc).
      valid: (..., K) candidate validity.
      thresh: IoU threshold, a scalar or a tensor broadcastable to
        (..., 1, 1) (per-row thresholds).
    Returns:
      keep: (..., K) bool.
    """
    k = iou.shape[-1]
    idx = torch.arange(k, device=iou.device)
    lower = idx[:, None] < idx[None, :]  # j < i: row j suppresses col i
    m = (lower & (iou > thresh)).to(torch.float32)
    return _greedy_suppress_mask(m, valid, sweeps)


def greedy_suppress_with_convergence(iou, valid, thresh, sweeps=_NMS_SWEEPS):
    """`_greedy_suppress` and whether its keep set is the exact greedy
    fixpoint (JAX `ops/nms.py:75-86`): one more sweep from it must change
    nothing. An audit of a workload's suppression-chain depth against
    `sweeps` (deeper chains need `test_cfg.nms.nms_sweeps` raised); it costs
    one more matvec.

    Args: as `_greedy_suppress` ((..., K, K) IoU, (..., K) validity).
    Returns:
      (keep (..., K) bool, converged (...) bool: per row, the extra sweep
      left the keep set as it was)."""
    k = iou.shape[-1]
    idx = torch.arange(k, device=iou.device)
    m = ((idx[:, None] < idx[None, :]) & (iou > thresh)).to(torch.float32)
    keep = _greedy_suppress_mask(m, valid, sweeps)
    again = valid & ~((keep.to(torch.float32)[..., None, :] @ m)[..., 0, :]
                      > 0.0)
    return keep, (again == keep).all(-1)


def _select_topk_sorted(keep, post_max_size):
    """First `post_max_size` kept slots (in existing order) -> (idx, mask)."""
    k = keep.shape[-1]
    ar = torch.arange(k, device=keep.device)
    rank_key = torch.where(keep, ar, k + ar)
    order = torch.argsort(rank_key, dim=-1)[..., :post_max_size]
    return order, torch.gather(keep, -1, order)


def mask_kernel_corners(boxes):
    """(R, K, 7+) det3d boxes -> the plain suppression mask's inputs:
    corners of A (R, K, 4, 2) and of B+ = B scaled by 1 + 1e-5 about its
    corner mean (R, K, 4, 2), f32, contiguous. The kernel makes the same
    corners itself, operation by operation."""
    corners = box_corners_bev(to_pcdet_bev(boxes.float()))
    return (corners.contiguous(),
            _scale_quad(corners, 1.0 + _ENLARGE).contiguous())


def _mask_area(quad):
    """The mask kernel's area: shoelace without abs (CCW quads), summed
    left to right from 0 (`nms_kernel.py::_quad_area`)."""
    x, y = quad[..., 0], quad[..., 1]
    s = torch.zeros_like(x[..., 0])
    for k in range(4):
        kn = (k + 1) % 4
        s = s + (x[..., k] * y[..., kn] - y[..., k] * x[..., kn])
    return 0.5 * s


def _clip_edges(p, q, total):
    """Add to `total` the Green integrals of the edges of quads p clipped to
    the inside of convex CCW quads q (broadcast pair tensors (..., 4, 2)),
    edge by edge in the mask kernel's order."""
    for e in range(4):
        en = (e + 1) % 4
        px, py = p[..., e, 0], p[..., e, 1]
        dx = p[..., en, 0] - px
        dy = p[..., en, 1] - py
        t0 = torch.zeros_like(px + q[..., 0, 0])
        t1 = torch.ones_like(t0)
        empty = torch.zeros_like(t0, dtype=torch.bool)
        for c in range(4):
            cn = (c + 1) % 4
            c0x, c0y = q[..., c, 0], q[..., c, 1]
            ex = q[..., cn, 0] - c0x
            ey = q[..., cn, 1] - c0y
            alpha = ex * (py - c0y) - ey * (px - c0x)
            beta = ex * dy - ey * dx
            par = beta.abs() < _EPS
            bound = -alpha / torch.where(par, 1.0, beta)
            is_lower = beta > 0
            lo = torch.where(par | ~is_lower, -_BIG, bound)
            hi = torch.where(par | is_lower, _BIG, bound)
            t0 = torch.maximum(t0, lo)
            t1 = torch.minimum(t1, hi)
            empty = empty | (par & (alpha < -_EPS))
        keep = (t1 > t0) & ~empty
        v0x = px + t0 * dx
        v0y = py + t0 * dy
        v1x = px + t1 * dx
        v1y = py + t1 * dy
        total = total + torch.where(keep, 0.5 * (v0x * v1y - v0y * v1x), 0.0)
    return total


def _suppression_matrix_plain(ca, cb, thresh):
    """Plain version of the suppression-mask kernel, in its order of
    operations: ca, cb (R, K, 4, 2) corners of A and B+, thresh (R,) f32
    -> (R, K, K) f32 mask. Chunked over rows of A."""
    R, K = ca.shape[:2]
    area_a = _mask_area(ca)
    # a tensor divisor: on CUDA, division by a python scalar becomes a
    # multiply by its reciprocal, which the kernel does not do
    area_b = _mask_area(cb) / torch.full((), _ENLARGE_SQ, device=cb.device)
    idx = torch.arange(K, device=ca.device)
    th = thresh.float().reshape(R, 1, 1)
    outs = []
    for r0 in range(0, K, _PLAIN_ROWS):
        a = ca[:, r0:r0 + _PLAIN_ROWS, None]  # (R, n, 1, 4, 2)
        b = cb[:, None]                         # (R, 1, K, 4, 2)
        inter = _clip_edges(a, b, torch.zeros((), device=ca.device))
        inter = _clip_edges(b, a, inter)
        aa = area_a[:, r0:r0 + _PLAIN_ROWS, None]
        ab = area_b[:, None, :]
        inter = torch.minimum(inter.clamp_min(0.0), torch.minimum(aa, ab))
        iou = inter / torch.clamp_min((aa + ab) - inter, _EPS)
        rows = idx[r0:r0 + _PLAIN_ROWS, None]
        outs.append(((rows < idx[None, :]) & (iou > th)).to(torch.float32))
    if not outs:
        return ca.new_zeros((R, K, K))
    return torch.cat(outs, dim=1)


def suppression_matrix(boxes, thresh):
    """(R, K, 7+) det3d boxes (score-descending) and IoU thresholds, a
    python float or an (R,) (or 0-d) f32 tensor -> (R, K, K) f32 mask
    M[r, j, i] = (j < i) * (IoU_bev(j, i) > thresh[r]), with the IoU of the
    TPU kernel `nms_kernel.py::suppression_matrix_pallas`.

    The op `pillarnet::suppression_mask`: a CPU tensor takes the plain
    version; a CUDA tensor launches `csrc/suppression_mask.cu`, which reads
    the boxes and makes their corners itself (a float threshold goes in as
    a launch argument, so nothing is copied from the host), or raises."""
    if boxes.dim() != 3 or boxes.shape[-1] < 7:
        raise ValueError(f"suppression_mask: boxes must be (R, K, >=7), got "
                         f"{tuple(boxes.shape)}")
    if boxes.device.type != "cpu":
        check_pair_tiles("suppression_mask", *boxes.shape[:2],
                         boxes.shape[1])
        _kernels.check_device("suppression_mask", boxes)
    if torch.is_tensor(thresh):
        th = thresh.float().expand(boxes.shape[0]).contiguous()
        return torch.ops.pillarnet.suppression_mask(boxes, th, 0.0)
    return torch.ops.pillarnet.suppression_mask(boxes, None, float(thresh))


def suppression_mask_corners(boxes):
    """The corners the suppression-mask kernel makes from det3d boxes
    (R, K, 7+), as it stages them: A and B+ (R, K, 4, 2) each (the op
    `pillarnet::suppression_mask_corners`; `mask_kernel_corners` on a CPU
    tensor). For checking them against `mask_kernel_corners` on the card
    (the served path never calls it; it counts no launch)."""
    if boxes.dim() != 3 or boxes.shape[-1] < 7:
        raise ValueError(f"suppression_mask_corners: boxes must be (R, K, "
                         f">=7), got {tuple(boxes.shape)}")
    _kernels.check_device("suppression_mask_corners", boxes)
    return torch.ops.pillarnet.suppression_mask_corners(boxes)


def circle_nms(centers, valid, min_radius, post_max_size):
    """Greedy centre-distance NMS over score-descending candidates (the
    reference's `circle_nms_jit`): j suppresses a later i where their
    squared BEV distance is <= `min_radius` (the reference compares the
    squared distance with the config's `min_radius` as it is). The JAX
    package computes it without a Pallas kernel; here too, plain tensor
    ops on both devices.

    Args:
      centers: (..., K, 2) xy, score-descending along K.
      valid: (..., K) bool.
      min_radius: the squared-distance threshold (m^2).
      post_max_size: output size.
    Returns:
      (sel_idx, sel_mask): (..., post_max_size), as `rotated_nms`.
    """
    d2 = ((centers[..., :, None, :] - centers[..., None, :, :]) ** 2).sum(-1)
    overlap = (d2 <= min_radius).to(torch.float32)
    keep = _greedy_suppress(overlap, valid, 0.5)
    return _select_topk_sorted(keep, post_max_size)


def rotated_nms(boxes, scores, valid, nms_thresh, post_max_size,
                sweeps=_NMS_SWEEPS, use_mask_kernel=False):
    """Greedy rotated-BEV NMS over score-sorted, fixed-size candidates.

    Args:
      boxes: (..., K, 7+) det3d boxes, score-descending along K.
      scores: (..., K) matching scores (passthrough, unused).
      valid: (..., K) bool; padding / below-threshold rows are False.
      nms_thresh: BEV IoU threshold.
      post_max_size: output size.
      sweeps: fixpoint sweeps.
      use_mask_kernel: build the suppression mask with the mask kernel
        (`suppression_matrix`), the counterpart of the JAX package's
        `use_pallas=True`; off by default, as there.
    Returns:
      (sel_idx, sel_mask): (..., post_max_size) indices into the K
      candidates and their validity.
    """
    del scores
    if use_mask_kernel:
        lead, k = boxes.shape[:-2], boxes.shape[-2]
        flat = boxes.reshape(-1, k, boxes.shape[-1])
        m = suppression_matrix(flat, float(nms_thresh)).reshape(*lead, k, k)
        keep = _greedy_suppress_mask(m, valid, sweeps)
        return _select_topk_sorted(keep, post_max_size)
    bev = to_pcdet_bev(boxes)
    iou = rotated_iou_bev(bev, bev)
    keep = _greedy_suppress(iou, valid, nms_thresh, sweeps=sweeps)
    return _select_topk_sorted(keep, post_max_size)


def rotated_nms_dynamic(boxes, scores, valid, nms_thresh, post_max_size,
                        sweeps=_NMS_SWEEPS, use_mask_kernel=False):
    """`rotated_nms` with one IoU threshold per row.

    The batched form of the JAX package's `rotated_nms_dynamic` (a traced
    threshold under `vmap`): the grouped multi-class path stacks classes
    with different thresholds into the rows of one batched NMS.

    Args:
      boxes: (R, K, 7+); scores, valid: (R, K); nms_thresh: (R,) f32
        tensor (or a list of R floats).
    """
    del scores
    if torch.is_tensor(nms_thresh):
        thresh = nms_thresh.to(boxes.device, torch.float32)
    else:  # a list: cached on the device, no synchronizing copy
        thresh = device_constant([float(t) for t in nms_thresh],
                                 boxes.device)
    if use_mask_kernel:
        keep = _greedy_suppress_mask(suppression_matrix(boxes, thresh),
                                     valid, sweeps)
        return _select_topk_sorted(keep, post_max_size)
    bev = to_pcdet_bev(boxes)
    iou = rotated_iou_bev(bev, bev)
    keep = _greedy_suppress(iou, valid, thresh[:, None, None], sweeps=sweeps)
    return _select_topk_sorted(keep, post_max_size)
