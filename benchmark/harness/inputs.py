"""Inputs made from the run's seed: weights and lidar clouds.

`cloud` is a frozen copy of the synthetic lidar sweep stack the system's
drivers use (`synth_points_realistic`), so that no change to the system
can move the benchmark's traffic.
"""

import numpy as np
import torch


def sub_seed(seed, *keys):
    """A 32-bit seed for one stream of inputs of run `seed`."""
    return int(np.random.SeedSequence([int(seed), *keys])
               .generate_state(1)[0])


def cloud(n, pc_range, seed, nsweeps=10):
    """One range-concentrated multi-sweep cloud: radius from an
    exponential mixture (most returns within ~25 m), sweeps revisiting the
    same cells (0.4 m of ego motion a sweep), ground and structure heights,
    a time-lag channel. -> points (n, 5) f32 [x, y, z, intensity, lag] and
    a (n,) bool mask (~2% of the points masked out)."""
    rng = np.random.RandomState(seed)
    per = n // nsweeps
    max_r = min(pc_range[3], pc_range[4])
    pts = np.zeros((n, 5), np.float32)
    xs, ys, zs, ts = [], [], [], []
    for s in range(nsweeps):
        m = per if s < nsweeps - 1 else n - per * (nsweeps - 1)
        r = np.minimum(
            np.where(rng.rand(m) < 0.75, rng.exponential(9.0, m) + 1.5,
                     rng.uniform(1.5, max_r, m)),
            max_r - 0.01)
        th = rng.uniform(-np.pi, np.pi, m)
        xs.append(r * np.cos(th) + 0.4 * s)
        ys.append(r * np.sin(th))
        zs.append(np.where(rng.rand(m) < 0.6, rng.normal(-1.6, 0.15, m),
                           rng.uniform(-2.0, 2.0, m)))
        ts.append(np.full(m, 0.05 * s))
    pts[:, 0] = np.concatenate(xs)
    pts[:, 1] = np.concatenate(ys)
    pts[:, 2] = np.clip(np.concatenate(zs), pc_range[2], pc_range[5])
    pts[:, 3] = rng.uniform(0, 255, n)
    pts[:, 4] = np.concatenate(ts)
    mask = rng.rand(n) > 0.02
    return pts, mask


def cloud_pool(count, n, pc_range, seed, nsweeps=10):
    """`count` distinct clouds of run `seed` in pinned host memory:
    points (count, n, 5) f32 and masks (count, n) bool."""
    pts = torch.empty((count, n, 5), dtype=torch.float32)
    msk = torch.empty((count, n), dtype=torch.bool)
    for i in range(count):
        p, m = cloud(n, pc_range, sub_seed(seed, 1, i), nsweeps)
        pts[i], msk[i] = torch.from_numpy(p), torch.from_numpy(m)
    if torch.cuda.is_available():
        pts, msk = pts.pin_memory(), msk.pin_memory()
    return pts, msk


# (kind) -> how a tensor of that kind is drawn from a standard normal n
def _fan_in(shape):
    return int(np.prod(shape[1:])) if len(shape) > 1 else 1


@torch.no_grad()
def make_weights(spec, seed, device):
    """The weight dict of a parameter spec ([(name, shape, kind)]), drawn
    on `device` from run `seed` in one call: He-normal convs and linears
    (fan in), Glorot-normal for 'conv_xavier', N(0, 0.05) biases, BN
    affine and statistics near the identity (weight 1 + 0.1 n, bias 0.1 n,
    mean 0.1 n, var exp(0.2 n)), heatmap biases -2.19."""
    sizes = [int(np.prod(shape)) for _, shape, _ in spec]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for (name, shape, kind), size in zip(spec, sizes):
        n = flat[at:at + size].view(shape)
        at += size
        if kind in ("conv", "linear"):
            t = n * (2.0 / _fan_in(shape)) ** 0.5
        elif kind == "conv_xavier":
            t = n * (2.0 / (_fan_in(shape) + shape[0] * 9)) ** 0.5
        elif kind == "deconv":
            t = n * (2.0 / shape[0]) ** 0.5
        elif kind == "bias":
            t = n * 0.05
        elif kind == "hm_bias":
            t = torch.full_like(n, -2.19)
        elif kind == "bn_w":
            t = 1.0 + 0.1 * n
        elif kind in ("bn_b", "bn_mean"):
            t = 0.1 * n
        elif kind == "bn_var":
            t = torch.exp(0.2 * n)
        else:
            raise ValueError(f"unknown weight kind {kind!r} of {name}")
        out[name] = t.contiguous()
    return out


def scene(seed, num_points, pc_range, class_names, num_boxes=(10, 22)):
    """A training scene with ground truth (a frozen copy of the system's
    `synth_scene`): boxes of car size inside 70% of the range with their
    points, uniform clutter around them, 5 point features (x, y, z,
    intensity, lag 0). -> points (m, 5) f32 (m <= num_points), boxes
    (n, 9) f32 [x, y, z, w, l, h, vx, vy, yaw], names (n,), the classes
    cycled in order."""
    rng = np.random.RandomState(seed)
    lo = np.array(pc_range[:3])
    hi = np.array(pc_range[3:])
    n_boxes = rng.randint(*num_boxes)
    centers = rng.uniform(lo[:2] * 0.7, hi[:2] * 0.7, (n_boxes, 2))
    zs = rng.uniform(-1.5, 0.5, (n_boxes, 1))
    dims = rng.uniform([1.5, 3.0, 1.4], [2.2, 5.0, 2.0], (n_boxes, 3))
    yaw = rng.uniform(-np.pi, np.pi, (n_boxes, 1))
    vel = rng.uniform(-5, 5, (n_boxes, 2))
    boxes = np.concatenate([centers, zs, dims[:, [0, 1, 2]], vel, yaw],
                           axis=1).astype(np.float32)
    names = np.array([class_names[i % len(class_names)]
                      for i in range(n_boxes)])
    n_bg = num_points * 3 // 4
    bg = np.empty((n_bg, 5), np.float32)
    bg[:, 0:2] = rng.uniform(lo[:2], hi[:2], (n_bg, 2))
    bg[:, 2] = rng.uniform(-2.0, 1.0, n_bg)
    bg[:, 3] = rng.uniform(0, 255, n_bg)
    bg[:, 4] = 0.0
    per_box = (num_points - n_bg) // n_boxes
    obj = []
    for b in range(n_boxes):
        local = rng.uniform(-0.5, 0.5, (per_box, 3)) * dims[b]
        c, s = np.cos(-yaw[b, 0]), np.sin(-yaw[b, 0])
        world = np.empty((per_box, 5), np.float32)
        world[:, 0] = local[:, 0] * c - local[:, 1] * s + centers[b, 0]
        world[:, 1] = local[:, 0] * s + local[:, 1] * c + centers[b, 1]
        world[:, 2] = local[:, 2] + zs[b, 0]
        world[:, 3] = rng.uniform(0, 255, per_box)
        world[:, 4] = 0.0
        obj.append(world)
    return np.concatenate([bg] + obj, axis=0), boxes, names


def pad_points(clouds, max_points):
    """Clouds (m_i, C) -> points (B, max_points, C) f32 and the mask."""
    pts = np.zeros((len(clouds), max_points, clouds[0].shape[1]),
                   np.float32)
    msk = np.zeros((len(clouds), max_points), bool)
    for i, c in enumerate(clouds):
        n = min(len(c), max_points)
        pts[i, :n], msk[i, :n] = c[:n], True
    return pts, msk
