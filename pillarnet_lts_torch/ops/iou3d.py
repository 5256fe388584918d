"""Rotated-BEV box overlap / IoU.

Port of `pillarnet_lts_tpu/ops/iou3d.py`. The intersection area of two
convex quads uses the two-sided Green decomposition (no polygon clipping
loop, no sort): the edges of A clipped to the inside of B+, plus the edges
of B+ clipped to the inside of A, with B+ = B enlarged by 1 + `_ENLARGE`.
`_convex_intersection_area` is the plain PyTorch version of the Hopper
kernel `csrc/rotated_overlap.cu`; `convex_intersection_area` picks between
the two by device. Sums run in a fixed left-to-right order that the kernel
repeats, so the two agree bit for bit. `pairs_may_meet` is the kernels'
separation test (pairs that cannot meet skip the clip).

Box conventions: det3d boxes (x, y, z, w, l, h, [vx, vy,] yaw) are turned
into pcdet BEV boxes (x, y, dx, dy, heading) by `to_pcdet_bev` before any
overlap math.
"""

import math

import torch

from . import _kernels

_EPS = 1e-8
_BIG = 1e9

# Relative enlargement of quad B before computing area(A ^ B+): with B+
# strictly larger, boundary-collinear configurations (identical boxes,
# shared edges) count each boundary piece exactly once. Biases the overlap
# by O(1e-5 * area).
_ENLARGE = 1e-5

# rows of A per plain-version chunk: bounds the (rows, M, 4, 4) temporaries
_PLAIN_ROWS = 256

# The pair kernels' separation test (`csrc/rotated_pairs.cuh`): bounding
# circles further apart than this (m) cannot meet. It covers the test's and
# the clip bounds' f32 rounding (< 1e-4 m for coordinates within +-150 m)
# ten times over; `pairs_may_meet` states the rest.
_CULL_MARGIN = 1e-3
# The kernels' pair tile: rows x columns of one block
_TILE_ROWS, _TILE_COLS = 32, 128


def to_pcdet_bev(boxes):
    """det3d (..., 7+) [x, y, z, w, l, h, ..., yaw] -> pcdet BEV (..., 5)
    [x, y, dx, dy, heading]."""
    return torch.stack(
        [boxes[..., 0], boxes[..., 1], boxes[..., 4], boxes[..., 3],
         -boxes[..., -1] - math.pi / 2],
        dim=-1,
    )


def box_corners_bev(boxes):
    """pcdet BEV boxes (..., 5) -> corners (..., 4, 2), CCW order."""
    x, y, dx, dy, r = (boxes[..., i] for i in range(5))
    cos_r = torch.cos(r)[..., None]
    sin_r = torch.sin(r)[..., None]
    # local corners, CCW: (+,+), (-,+), (-,-), (+,-)
    lx = torch.stack([dx, -dx, -dx, dx], dim=-1) * 0.5
    ly = torch.stack([dy, dy, -dy, -dy], dim=-1) * 0.5
    cx = lx * cos_r - ly * sin_r + x[..., None]
    cy = lx * sin_r + ly * cos_r + y[..., None]
    return torch.stack([cx, cy], dim=-1)


def _scale_quad(quad, factor):
    """Scale (..., 4, 2) quads about their corner mean."""
    q = quad.unbind(-2)
    center = (((q[0] + q[1]) + q[2]) + q[3]) / 4.0
    return center[..., None, :] + (quad - center[..., None, :]) * factor


def _quad_area(quad):
    """Shoelace area of (..., 4, 2) quads."""
    x, y = quad[..., 0], quad[..., 1]
    s = None
    for k in range(4):
        kn = (k + 1) % 4
        term = x[..., k] * y[..., kn] - y[..., k] * x[..., kn]
        s = term if s is None else s + term
    return 0.5 * s.abs()


def _clipped_edge_integrals(poly, clip_quad):
    """Green's-theorem line integrals of `poly`'s edges clipped to the inside
    of convex `clip_quad`, summed over the 4 edges (leading batch dims).

    Each directed edge x(t) = p + t*d, t in [0, 1], meets the convex clip
    region in one interval [t0, t1] (4 half-plane constraints, each linear
    in t); its integral of (x dy - y dx)/2 is cross(x(t0), x(t1))/2.
    """
    p = poly  # (..., 4, 2)
    d = torch.roll(poly, -1, dims=-2) - p
    c0 = clip_quad
    e = torch.roll(clip_quad, -1, dims=-2) - c0  # CCW: inside = cross(e, x - c0) >= 0

    # alpha + t*beta >= 0 per (poly edge, clip plane): (..., 4poly, 4clip)
    rel = p[..., :, None, :] - c0[..., None, :, :]
    alpha = e[..., None, :, 0] * rel[..., 1] - e[..., None, :, 1] * rel[..., 0]
    beta = (e[..., None, :, 0] * d[..., :, None, 1]
            - e[..., None, :, 1] * d[..., :, None, 0])

    parallel = beta.abs() < _EPS
    bound = -alpha / torch.where(parallel, 1.0, beta)
    # beta > 0: t >= bound (lower); beta < 0: t <= bound (upper);
    # parallel: inside for all t if alpha >= 0 else empty (lower = +big)
    lower = torch.where(
        parallel,
        torch.where(alpha >= -_EPS, -_BIG, _BIG),
        torch.where(beta > 0, bound, -_BIG),
    )
    upper = torch.where(parallel, _BIG, torch.where(beta > 0, _BIG, bound))

    t0 = lower.amax(dim=-1).clamp_min(0.0)  # (..., 4)
    t1 = upper.amin(dim=-1).clamp_max(1.0)
    v0 = p + t0[..., None] * d
    v1 = p + t1[..., None] * d
    integ = 0.5 * (v0[..., 0] * v1[..., 1] - v0[..., 1] * v1[..., 0])
    integ = torch.where(t1 > t0, integ, 0.0)
    return ((integ[..., 0] + integ[..., 1]) + integ[..., 2]) + integ[..., 3]


def _convex_intersection_area(a_quad, b_quad):
    """Exact intersection area of two convex CCW quads (..., 4, 2), batched
    over matching leading dims; the plain version of the Hopper kernel."""
    b_plus = _scale_quad(b_quad, 1.0 + _ENLARGE)
    area = (_clipped_edge_integrals(a_quad, b_plus)
            + _clipped_edge_integrals(b_plus, a_quad))
    cap = torch.minimum(_quad_area(a_quad), _quad_area(b_quad))
    return torch.minimum(area.clamp_min(0.0), cap)


def _bounding_circle(quad):
    """(..., 4, 2) quads -> corner means (..., 2) and radii (...): the
    largest corner distance from the mean, as `rotated_pairs.cuh`
    computes them."""
    q = quad.unbind(-2)
    center = (((q[0] + q[1]) + q[2]) + q[3]) / 4.0
    r2 = None
    for k in range(4):
        d = q[k] - center
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        r2 = d2 if r2 is None else torch.maximum(r2, d2)
    return center, torch.sqrt(r2)


def pairs_may_meet(a_quad, b_quad):
    """The separation test of the pair kernels K2 and K3, in PyTorch:
    (..., Ka, 4, 2) x (..., Kb, 4, 2) -> (..., Ka, Kb) bool, False where
    the bounding circles of A and of B+ (B scaled by 1 + `_ENLARGE` about
    its corner mean) are more than `_CULL_MARGIN` apart.

    The same operations in the same order as `csrc/rotated_pairs.cuh::
    may_meet`. Where it is False, every clipped edge interval of the pair
    is empty, so `_pairwise_area_plain` gives +0.0 and the suppression
    mask's plain version the value of an intersection of +0 (the CPU tests
    pin both); the kernels write those values without the clip. For the
    tests and `chip_smoke.py`'s bound; the served path does not call it."""
    ca, ra = _bounding_circle(a_quad)
    cb, rb = _bounding_circle(_scale_quad(b_quad, 1.0 + _ENLARGE))
    d = ca[..., :, None, :] - cb[..., None, :, :]
    reach = (ra[..., :, None] + rb[..., None, :]) + _CULL_MARGIN
    return ~(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] > reach * reach)


def pair_tiles(t, ka, kb):
    """Blocks of the pair kernels' grid: one per 32 x 128 pair tile."""
    return t * -(-ka // _TILE_ROWS) * -(-kb // _TILE_COLS)


def check_pair_tiles(name, t, ka, kb):
    """Raise unless the pair kernels' grid for t batches of Ka x Kb pairs
    has fewer than 2^31 tiles (checked before any launch)."""
    if pair_tiles(t, ka, kb) >= 2**31:
        raise ValueError(f"{name}: batch={t}, Ka={ka}, Kb={kb} make "
                         f"{pair_tiles(t, ka, kb)} pair tiles (< 2^31)")


def _pairwise_area_plain(a_quad, b_quad):
    """(..., Ka, 4, 2) x (..., Kb, 4, 2) -> (..., Ka, Kb), chunked over Ka."""
    kb = b_quad.shape[-3]
    outs = []
    for a in a_quad.split(_PLAIN_ROWS, dim=-3):
        pa = a[..., :, None, :, :].expand(*a.shape[:-2], kb, 4, 2)
        pb = b_quad[..., None, :, :, :].expand_as(pa)
        outs.append(_convex_intersection_area(pa, pb))
    if not outs:
        return a_quad.new_zeros(a_quad.shape[:-2] + (kb,))
    return torch.cat(outs, dim=-2)


def convex_intersection_area(a_quad, b_quad):
    """Pairwise intersection areas of convex CCW quads.

    a_quad (..., Ka, 4, 2), b_quad (..., Kb, 4, 2) with equal leading dims
    -> (..., Ka, Kb). The op `pillarnet::rotated_overlap`: a CPU tensor
    takes the plain version; a CUDA tensor launches `csrc/rotated_overlap.cu`
    (f32; one block per 32 x 128 pair tile, fewer than 2^31 tiles) or
    raises.
    """
    if a_quad.device.type != "cpu":
        check_pair_tiles("rotated_overlap", math.prod(a_quad.shape[:-3]),
                         a_quad.shape[-3], b_quad.shape[-3])
        _kernels.check_device("rotated_overlap", a_quad)
    return torch.ops.pillarnet.rotated_overlap(a_quad, b_quad)


def rotated_overlap_bev(boxes_a, boxes_b):
    """Pairwise rotated BEV overlap area (..., N, M); pcdet BEV (..., 5)
    inputs with equal leading dims."""
    return convex_intersection_area(box_corners_bev(boxes_a),
                                     box_corners_bev(boxes_b))


def rotated_iou_bev(boxes_a, boxes_b):
    """Pairwise rotated BEV IoU (..., N, M); pcdet BEV inputs."""
    overlap = rotated_overlap_bev(boxes_a, boxes_b)
    sa = (boxes_a[..., 2] * boxes_a[..., 3])[..., :, None]
    sb = (boxes_b[..., 2] * boxes_b[..., 3])[..., None, :]
    return overlap / (sa + sb - overlap).clamp_min(_EPS)


def _height_overlap(za, ha, zb, hb):
    top = torch.minimum(za + ha / 2, zb + hb / 2)
    bot = torch.maximum(za - ha / 2, zb - hb / 2)
    return (top - bot).clamp_min(0.0)


def boxes_iou3d(boxes_a, boxes_b):
    """Pairwise rotated 3D IoU (..., N, M) of det3d boxes (..., N, 7) and
    (..., M, 7) with equal leading dims: the RoI-vs-GT IoU of the RoI
    sampler. The BEV overlap is one `convex_intersection_area` call over
    every leading dim (one K2 launch on a CUDA tensor); the volume sum is
    clamped at 1e-6, so an all-zero (padding) box has IoU 0 with any box."""
    overlap = rotated_overlap_bev(to_pcdet_bev(boxes_a),
                                  to_pcdet_bev(boxes_b))
    overlap = overlap * _height_overlap(
        boxes_a[..., :, None, 2], boxes_a[..., :, None, 5],
        boxes_b[..., None, :, 2], boxes_b[..., None, :, 5])
    vol_a = (boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5])[..., :, None]
    vol_b = (boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5])[..., None, :]
    return overlap / (vol_a + vol_b - overlap).clamp_min(1e-6)


def boxes_aligned_iou3d(boxes_a, boxes_b):
    """Row-aligned rotated 3D IoU (...,) of det3d 7-dim boxes (..., 7):
    the target of the IoU-aware head's loss. Plain PyTorch on every device
    (`_convex_intersection_area`, one pair per row), as the JAX package's
    `boxes_aligned_iou3d` runs plain XLA."""
    overlap = _convex_intersection_area(
        box_corners_bev(to_pcdet_bev(boxes_a)),
        box_corners_bev(to_pcdet_bev(boxes_b)))
    overlap = overlap * _height_overlap(boxes_a[..., 2], boxes_a[..., 5],
                                        boxes_b[..., 2], boxes_b[..., 5])
    vol_a = boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5]
    vol_b = boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5]
    return overlap / (vol_a + vol_b - overlap).clamp_min(1e-6)
