"""Synthetic lidar clouds and training scenes (numpy only).

The port's own copies of the cloud that the JAX package's drivers use
(`__graft_entry__._synth_points_realistic`) and of the JAX package's demo
scenes with ground truth (`datasets/demo.py`), so that the port's smoke
run, profiles and training need nothing from outside the package;
`tests/test_torch_port_scatter.py` and `tests/test_torch_port_train.py`
pin them equal bit for bit. Real nuScenes and Waymo data are not in the
repository.
"""

import numpy as np

from .pipelines import AssignLabel, Preprocess, Reformat


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


def synth_scene(seed, num_points, pc_range, class_names, num_boxes=(3, 9)):
    """A synthetic scene with ground truth: car-sized boxes with points
    inside and uniform clutter around them, 5 point features (x, y, z,
    intensity, time lag 0). The port's copy of the JAX package's
    `datasets/demo.py::DemoDataset._synth_frame` (scene `idx` of a dataset
    with seed s is `seed = s + idx`), pinned equal by the tests;
    `num_boxes` is the [low, high) range of the box count, the demo's
    (3, 9) by default.

    Returns points (num_points', 5) f32, boxes (n, 9) f32 [x, y, z, w, l,
    h, vx, vy, yaw] and names (n,), the classes cycled in order."""
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
    obj_points = []
    for b in range(n_boxes):
        local = rng.uniform(-0.5, 0.5, (per_box, 3)) * dims[b]
        c, s = np.cos(-yaw[b, 0]), np.sin(-yaw[b, 0])
        world = np.empty((per_box, 5), np.float32)
        world[:, 0] = local[:, 0] * c - local[:, 1] * s + centers[b, 0]
        world[:, 1] = local[:, 0] * s + local[:, 1] * c + centers[b, 1]
        world[:, 2] = local[:, 2] + zs[b, 0]
        world[:, 3] = rng.uniform(0, 255, per_box)
        world[:, 4] = 0.0
        obj_points.append(world)

    points = np.concatenate([bg] + obj_points, axis=0)
    return points, boxes, names


class SynthDataset:
    """Training scenes from `synth_scene` through the train pipeline
    (`Preprocess` without augmentation, `AssignLabel` of the config's
    assigner, `Reformat`): example i is scene `seed + i`.

    cfg: a config (`apis.load_config`); the scenes take its
    `point_cloud_range` (else the reader's `pc_range`, of the first stage
    in a two-stage config), `class_names` and
    `train_cfg["assigner"]`. `num_boxes` is passed to `synth_scene`."""

    def __init__(self, cfg, num_frames, num_points, seed=0,
                 num_boxes=(3, 9)):
        self.num_frames = num_frames
        self.num_points = num_points
        self.seed = seed
        self.num_boxes = num_boxes
        self.pc_range = cfg.get("point_cloud_range")
        if self.pc_range is None:
            model = cfg["model"]
            model = model.get("first_stage_cfg", model)
            self.pc_range = model["reader"]["pc_range"]
        self.class_names = list(cfg["class_names"])
        self.pipeline = [
            Preprocess(dict(mode="train", shuffle_points=False,
                            no_augmentation=True,
                            class_names=self.class_names)),
            AssignLabel(cfg["train_cfg"]["assigner"]),
            Reformat(),
        ]

    def __len__(self):
        return self.num_frames

    def __getitem__(self, idx):
        points, boxes, names = synth_scene(
            self.seed + idx, self.num_points, self.pc_range,
            self.class_names, self.num_boxes)
        res = {"type": "DemoDataset", "mode": "train",
               "metadata": {"token": f"synth_{self.seed + idx}"},
               "lidar": {"combined": points,
                         "annotations": {"boxes": boxes, "names": names}}}
        info = None
        for stage in self.pipeline:
            res, info = stage(res, info)
        return res
