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


def _ego_motion(k, step=0.4, yaw=0.005):
    """4 x 4 transform of sweep k into its keyframe: k steps of `step` m
    forward and `yaw` rad of turn."""
    c, s = np.cos(yaw * k), np.sin(yaw * k)
    tm = np.eye(4)
    tm[:2, :2] = [[c, -s], [s, c]]
    tm[0, 3] = -step * k
    return tm


def write_nuscenes_set(root, num_frames, num_points, nsweeps, class_names,
                       pc_range, seed=0, split="val"):
    """A nuScenes-layout set in directory `root`, from the demo scenes:
    per frame a keyframe `.bin` and (nsweeps - 1) sweep `.bin`s of
    `num_points` points x 5 f32 (x, y, z, intensity, ring 0), each sweep
    with its 4 x 4 transform into the keyframe (a small ego motion) and a
    time lag of 0.05 s a step, and `infos_{split}.pkl` holding the frames'
    infos with the scene's boxes as GT (`gt_boxes` (n, 9), `gt_names`,
    `gt_boxes_velocity`, `gt_boxes_token`). Returns the info path."""
    import os
    import pickle

    os.makedirs(os.path.join(root, "samples"), exist_ok=True)
    os.makedirs(os.path.join(root, "sweeps"), exist_ok=True)

    def write(path, points):
        out = np.zeros((len(points), 5), np.float32)
        out[:, :4] = points[:, :4]
        out.tofile(path)
        return path

    infos = []
    for i in range(num_frames):
        points, boxes, names = synth_scene(seed + i, num_points, pc_range,
                                           class_names)
        token = f"nusc_{seed}_{i}"
        sweeps = []
        for k in range(1, nsweeps):
            sweep, _, _ = synth_scene(seed + 1000 * k + i, num_points,
                                      pc_range, class_names)
            sweeps.append({
                "lidar_path": write(os.path.join(
                    root, "sweeps", f"{token}_{k}.bin"), sweep),
                "transform_matrix": _ego_motion(k),
                "time_lag": 0.05 * k,
            })
        infos.append({
            "lidar_path": write(os.path.join(root, "samples",
                                             f"{token}.bin"), points),
            "token": token,
            "sweeps": sweeps,
            "gt_boxes": boxes.astype(np.float64),
            "gt_names": names,
            "gt_boxes_velocity": np.concatenate(
                [boxes[:, 6:8], np.zeros((len(boxes), 1))], axis=1),
            "gt_boxes_token": np.array([f"{token}_box{b}"
                                        for b in range(len(boxes))]),
        })
    path = os.path.join(root, f"infos_{split}.pkl")
    with open(path, "wb") as f:
        pickle.dump(infos, f)
    return path


def write_waymo_set(root, num_frames, num_points, class_names, pc_range,
                    seed=0, split="val", class_counts=None):
    """A Waymo-layout single-sweep set in directory `root`, from the demo
    scenes: per frame a pkl with `lidars.points_xyz` (n, 3) and
    `lidars.points_feature` (n, 2) f32 (intensity, elongation), and
    `infos_{split}.pkl` with the scene's boxes as GT (`gt_boxes` (n, 9),
    upper-case `gt_names`, `num_points_in_gt`, `difficulty`). By default
    a frame holds the demo's 3-8 boxes, the classes cycled; with
    `class_counts` (one count per class, or one such row per frame) each
    frame holds that many boxes of each class. Returns the info path."""
    import os
    import pickle

    os.makedirs(os.path.join(root, split, "lidar"), exist_ok=True)
    infos = []
    counts = None
    if class_counts is not None:
        counts = np.broadcast_to(np.asarray(class_counts, np.int64),
                                 (num_frames, len(class_names)))
    for i in range(num_frames):
        num_boxes = (3, 9)
        if counts is not None:
            num_boxes = (int(counts[i].sum()), int(counts[i].sum()) + 1)
        points, boxes, names = synth_scene(seed + i, num_points, pc_range,
                                           class_names, num_boxes)
        if counts is not None:
            names = np.repeat(np.asarray(class_names), counts[i])
        token = f"seq_{seed}_frame_{i}.pkl"
        path = os.path.join(root, split, "lidar", token)
        elongation = np.random.RandomState(seed + i).uniform(
            0, 1, len(points)).astype(np.float32)
        with open(path, "wb") as f:
            pickle.dump({"lidars": {
                "points_xyz": np.ascontiguousarray(points[:, :3]),
                "points_feature": np.stack(
                    [points[:, 3] / 255.0, elongation], axis=1)}}, f)
        infos.append({
            "path": path,
            "token": token,
            "sweeps": [],
            "gt_boxes": boxes,
            "gt_names": np.char.upper(names.astype(str)),
            "num_points_in_gt": np.full(len(boxes), 50),
            "difficulty": np.zeros(len(boxes), np.int64),
        })
    path = os.path.join(root, f"infos_{split}.pkl")
    with open(path, "wb") as f:
        pickle.dump(infos, f)
    return path


# Waymo's label ids (`datasets/waymo/waymo_infos.py::TYPE_LIST`) of the
# classes a raw frame cycles through: VEHICLE, PEDESTRIAN, CYCLIST, SIGN
_RAW_LABELS = (1, 2, 4, 3)
_RAW_NAMES = ("VEHICLE", "PEDESTRIAN", "CYCLIST", "SIGN")


def _raw_pose(sequence, frame):
    """A vehicle-to-global pose that moves and turns from frame to frame:
    16 f64 values, row-major 4x4."""
    yaw = 0.3 * sequence + 0.02 * frame
    pose = np.eye(4)
    pose[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    pose[:3, 3] = [100.0 * sequence + 1.5 * frame,
                   -20.0 * sequence + 0.25 * frame, 0.5]
    return pose.reshape(16)


def write_waymo_raw(root, split, num_sequences, frames_per_sequence,
                    num_points, pc_range, seed=0):
    """Raw Waymo frames in the layout of `datasets/waymo/waymo_converter.py`
    under `{root}/{split}`, from the demo scenes (`synth_scene`): per
    frame `lidar/seq_S_frame_F.pkl` (`lidars.points_xyz` (n, 3) and
    `points_feature` (n, 2) f32, intensity and elongation) and
    `annos/seq_S_frame_F.pkl` (`frame_name` ending in the frame's
    timestamp in us, 10 Hz; `veh_to_global`, 16 f64 values of a pose that
    moves and turns; `objects`, each with a 9-value f32 Waymo box (centre,
    length, width, height, velocity, heading), its `label` index into
    `TYPE_LIST` (vehicles, pedestrians, cyclists and signs in turn),
    `num_points` and `detection_difficulty_level`). Frame 1 of sequence 0
    has no objects, and every fifth object has no points. A test fixture;
    returns the split's directory."""
    import os
    import pickle

    split_dir = os.path.join(root, split)
    for sub in ("lidar", "annos"):
        os.makedirs(os.path.join(split_dir, sub), exist_ok=True)
    for s in range(num_sequences):
        scene = f"synth_{seed}_{s}"
        for f in range(frames_per_sequence):
            scene_seed = seed + 100 * s + f
            points, boxes, names = synth_scene(scene_seed, num_points,
                                               pc_range, _RAW_NAMES)
            rng = np.random.RandomState(scene_seed)
            stamp = 1_557_000_000_000_000 + s * 10**9 + f * 100_000
            frame_name = f"{scene}_location_sf_Day_{stamp}"
            per_box = (num_points - num_points * 3 // 4) // len(boxes)
            objects = []
            if (s, f) != (0, 1):
                for i, b in enumerate(boxes):
                    objects.append({
                        "id": i,
                        "name": f"{scene}_{f}_{i}",
                        "label": _RAW_LABELS[_RAW_NAMES.index(names[i])],
                        "box": np.array([b[0], b[1], b[2], b[4], b[3], b[5],
                                         b[6], b[7], -np.pi / 2 - b[8]],
                                        dtype=np.float32),
                        "num_points": 0 if i % 5 == 4 else per_box,
                        "detection_difficulty_level": int(rng.randint(1, 3)),
                        "combined_difficulty_level": 0,
                    })
            name = f"seq_{s}_frame_{f}.pkl"
            with open(os.path.join(split_dir, "lidar", name), "wb") as fh:
                pickle.dump({
                    "scene_name": scene, "frame_name": frame_name,
                    "frame_id": f,
                    "lidars": {
                        "points_xyz": np.ascontiguousarray(points[:, :3]),
                        "points_feature": np.stack(
                            [points[:, 3] / 255.0,
                             rng.uniform(0, 1, len(points))],
                            axis=1).astype(np.float32)}}, fh)
            with open(os.path.join(split_dir, "annos", name), "wb") as fh:
                pickle.dump({"scene_name": scene, "frame_name": frame_name,
                             "frame_id": f,
                             "veh_to_global": _raw_pose(s, f),
                             "objects": objects}, fh)
    return split_dir
