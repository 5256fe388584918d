"""Rotated bird's-eye-view box overlap, plain PyTorch.

The intersection of two convex quads is the convex polygon whose vertices
are the corners of each quad that lie inside the other and the crossing
points of their edges; its area is the shoelace sum of those points taken
in angular order about their mean. Written for the reference's NMS and
run in float64.
"""

import math

import torch

_PAIRS = 2_000_000  # pairs per step: bounds the temporaries


def to_bev(boxes):
    """(x, y, z, w, l, h, [vx, vy,] yaw) boxes -> (x, y, dx, dy, heading)
    with dx the box's length along its heading: dx = l, dy = w, heading =
    -yaw - pi / 2 (the detector's box convention)."""
    return torch.stack([boxes[..., 0], boxes[..., 1], boxes[..., 4],
                        boxes[..., 3], -boxes[..., -1] - math.pi / 2], -1)


def corners(bev):
    """(..., 5) -> (..., 4, 2) corners, counter-clockwise."""
    x, y, dx, dy, r = bev.unbind(-1)
    lx = torch.stack([dx, -dx, -dx, dx], -1) * 0.5
    ly = torch.stack([dy, dy, -dy, -dy], -1) * 0.5
    c, s = torch.cos(r)[..., None], torch.sin(r)[..., None]
    return torch.stack([lx * c - ly * s + x[..., None],
                        lx * s + ly * c + y[..., None]], -1)


def _inside(p, quad):
    """p (..., P, 2) against convex CCW quads (..., 4, 2) -> (..., P)."""
    e = torch.roll(quad, -1, -2) - quad
    rel = p[..., :, None, :] - quad[..., None, :, :]
    cross = e[..., None, :, 0] * rel[..., 1] - e[..., None, :, 1] * rel[..., 0]
    return (cross >= -1e-12).all(-1)


def _crossings(a, b):
    """Edge-edge crossing points of quads a, b (..., 4, 2) -> points
    (..., 16, 2) and validity (..., 16)."""
    pa, da = a[..., :, None, :], (torch.roll(a, -1, -2) - a)[..., :, None, :]
    pb, db = b[..., None, :, :], (torch.roll(b, -1, -2) - b)[..., None, :, :]
    den = da[..., 0] * db[..., 1] - da[..., 1] * db[..., 0]
    w = pb - pa
    safe = torch.where(den.abs() > 1e-12, den, torch.ones_like(den))
    t = (w[..., 0] * db[..., 1] - w[..., 1] * db[..., 0]) / safe
    u = (w[..., 0] * da[..., 1] - w[..., 1] * da[..., 0]) / safe
    ok = (den.abs() > 1e-12) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pts = pa + t[..., None] * da
    return pts.flatten(-3, -2), ok.flatten(-2)


def intersection_area(a, b):
    """Areas of the intersections of convex CCW quads a, b (..., 4, 2)."""
    cross_pts, cross_ok = _crossings(a, b)
    pts = torch.cat([a, b, cross_pts], -2)                  # (..., 24, 2)
    ok = torch.cat([_inside(a, b), _inside(b, a), cross_ok], -1)
    n = ok.sum(-1, keepdim=True)
    okf = ok.to(pts.dtype)[..., None]
    centre = (pts * okf).sum(-2) / n.clamp_min(1).to(pts.dtype)
    rel = pts - centre[..., None, :]
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    ang = torch.where(ok, ang, torch.full_like(ang, 10.0))
    order = torch.argsort(ang, -1)
    rel = torch.gather(rel, -2, order[..., None].expand_as(rel))
    k = torch.arange(pts.shape[-2], device=pts.device)
    nxt = torch.where(k + 1 < n, k + 1, torch.zeros_like(k + 1))
    rel_n = torch.gather(rel, -2, nxt[..., None].expand_as(rel))
    tri = rel[..., 0] * rel_n[..., 1] - rel[..., 1] * rel_n[..., 0]
    area = 0.5 * torch.where(k < n, tri, torch.zeros_like(tri)).sum(-1)
    return torch.where(n[..., 0] >= 3, area, torch.zeros_like(area))


def rotated_iou_bev(a, b):
    """Pairwise IoU of (N, 5) and (M, 5) BEV boxes -> (N, M)."""
    ca, cb = corners(a), corners(b)
    area_a = (a[:, 2] * a[:, 3])[:, None]
    area_b = (b[:, 2] * b[:, 3])[None, :]
    rows, step = [], max(1, _PAIRS // max(len(b), 1))
    for i in range(0, len(a), step):
        qa = ca[i:i + step, None].expand(-1, len(b), 4, 2)
        qb = cb[None].expand(len(qa), -1, 4, 2)
        rows.append(intersection_area(qa, qb))
    if not rows:
        return a.new_zeros((0, len(b)))
    inter = torch.cat(rows)
    return inter / torch.clamp_min(area_a + area_b - inter, 1e-8)
