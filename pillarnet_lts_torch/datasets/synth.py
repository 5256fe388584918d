"""A synthetic lidar cloud shaped like a real scan (numpy only).

The port's own copy of the cloud that the JAX package's drivers use
(`__graft_entry__._synth_points_realistic`), so that the port's smoke run
and profiles need nothing from outside the package;
`tests/test_torch_port_scatter.py` pins the two equal bit for bit.
"""

import numpy as np


def synth_points_realistic(batch, n, pc_range, seed=0, nsweeps=10):
    """Range-concentrated multi-sweep cloud approximating a real lidar scan:
    radius ~ exponential mixture (most returns within ~25 m), sweeps revisit
    the same cells (ego barely moves in 0.5 s), object clusters, per-point
    time-lag channel. BEV occupancy lands at a realistic 2-4% of the 1440^2
    grid vs ~11% for the uniform cloud.

    Returns points (batch, n, 5) f32 [x, y, z, intensity, time lag] and a
    (batch, n) bool mask (~2% of the points masked out).
    """
    rng = np.random.RandomState(seed)
    per = n // nsweeps
    max_r = min(pc_range[3], pc_range[4])
    pts = np.zeros((batch, n, 5), np.float32)
    for b in range(batch):
        xs, ys, zs, ts = [], [], [], []
        for s in range(nsweeps):
            m = per if s < nsweeps - 1 else n - per * (nsweeps - 1)
            r = np.minimum(
                np.where(
                    rng.rand(m) < 0.75,
                    rng.exponential(9.0, m) + 1.5,
                    rng.uniform(1.5, max_r, m),
                ),
                max_r - 0.01,
            )
            th = rng.uniform(-np.pi, np.pi, m)
            # small ego-motion between sweeps
            xs.append(r * np.cos(th) + 0.4 * s)
            ys.append(r * np.sin(th))
            zs.append(
                np.where(rng.rand(m) < 0.6,
                         rng.normal(-1.6, 0.15, m),   # ground returns
                         rng.uniform(-2.0, 2.0, m))   # structure
            )
            ts.append(np.full(m, 0.05 * s))
        pts[b, :, 0] = np.concatenate(xs)
        pts[b, :, 1] = np.concatenate(ys)
        pts[b, :, 2] = np.clip(np.concatenate(zs), pc_range[2], pc_range[5])
        pts[b, :, 3] = rng.uniform(0, 255, n)
        pts[b, :, 4] = np.concatenate(ts)
    mask = rng.rand(batch, n) > 0.02
    return pts, mask
