"""GT-AUG: paste objects from a ground-truth database into a training scene.

The port's own copy of `pillarnet_lts_tpu/core/sampler/db_sampler.py`:
per-class quotas less the scene's own boxes, each class's database read
in shuffled passes, the drawn boxes filtered by BEV collision with the
scene and with the boxes already placed, and each drawn object's points
(stored relative to its box centre) moved to its box. Group sampling and
per-object rotation raise `NotImplementedError`, as in the JAX package
(no config uses them).

Randomness: the sampler owns a `np.random.RandomState(seed)`, which makes
each class's shuffle at construction and every reshuffle; the JAX package
draws both from numpy's global state, so the two agree when numpy's global
state is seeded with the same seed before the JAX sampler is built and
nothing else draws from it in between. The per-class cursors are shared
by the loader's threads and a lock guards them. With one loader thread a
run repeats bit for bit; with more, which sample takes which database
objects follows the threads' timing, as in the JAX package.
"""

import copy
import logging
import pathlib
import pickle
import threading

import numpy as np

from ..bbox import box_np_ops


class BatchSampler:
    """One class's database read in shuffled passes. A draw of `num` that
    reaches the end of the pass returns only what is left of it and starts
    a new, reshuffled pass (the reference's behaviour)."""

    def __init__(self, sampled_list, rng, name=None, shuffle=True):
        self._sampled_list = sampled_list
        self._rng = rng
        self._indices = np.arange(len(sampled_list))
        if shuffle:
            rng.shuffle(self._indices)
        self._idx = 0
        self._example_num = len(sampled_list)
        self._name = name
        self._shuffle = shuffle
        self._lock = threading.Lock()

    def _sample(self, num):
        with self._lock:
            if self._idx + num >= self._example_num:
                ret = self._indices[self._idx:].copy()
                self._reset()
            else:
                # a copy: another thread may reshuffle the array in place
                ret = self._indices[self._idx:self._idx + num].copy()
                self._idx += num
            return ret

    def _reset(self):
        if self._shuffle:
            self._rng.shuffle(self._indices)
        self._idx = 0

    def sample(self, num):
        return [self._sampled_list[i] for i in self._sample(num)]


def filter_by_difficulty(db_infos, removed_difficulties):
    return {key: [info for info in infos
                  if info["difficulty"] not in removed_difficulties]
            for key, infos in db_infos.items()}


def filter_by_min_num_points(db_infos, min_gt_point_dict):
    for name, min_num in min_gt_point_dict.items():
        if min_num > 0 and name in db_infos:
            db_infos[name] = [info for info in db_infos[name]
                              if info["num_points_in_gt"] >= min_num]
    return db_infos


class DataBaseSampler:
    """The reference's `DataBaseSamplerV2` without group sampling.

    db_infos: {class name: [info]} (`datasets/utils/create_gt_database`);
    groups: [{class name: max count}], one class a group; rate: the share
    of each quota drawn; seed: the sampler's generator's."""

    def __init__(self, db_infos, groups, rate=1.0, global_rot_range=None,
                 logger=None, seed=0):
        self.logger = logger or logging.getLogger("db_sampler")
        for k, v in db_infos.items():
            self.logger.info("load %d %s database infos", len(v), k)
        self.db_infos = db_infos
        self._rate = rate
        self._sample_classes = []
        self._sample_max_nums = []
        if any(len(g) > 1 for g in groups):
            raise NotImplementedError("group sampling is not supported")
        for group_info in groups:
            self._sample_classes += list(group_info.keys())
            self._sample_max_nums += list(group_info.values())
        self.rng = np.random.RandomState(seed)
        self._sampler_dict = {k: BatchSampler(v, self.rng, k)
                              for k, v in db_infos.items()}
        if global_rot_range is not None:
            if not isinstance(global_rot_range, (list, tuple, np.ndarray)):
                global_rot_range = [-global_rot_range, global_rot_range]
            if np.abs(global_rot_range[0] - global_rot_range[1]) >= 1e-3:
                raise NotImplementedError(
                    "per-object global rotation is not supported")

    def sample_all(self, root_path, gt_boxes, gt_names, num_point_features,
                   random_crop=False, **kwargs):
        """Draw each class's quota less its count in `gt_names`, keep the
        boxes that collide with no scene box or earlier kept box, and read
        their points (`root_path` / info path, f32 rows of
        `num_point_features`) moved to the boxes. Returns None when
        nothing was drawn, else a dict of `gt_names`, `difficulty`,
        `gt_boxes`, `points` and `gt_masks` (all True)."""
        sampled_num_dict = {}
        for class_name, max_sample_num in zip(self._sample_classes,
                                              self._sample_max_nums):
            sampled_num = int(max_sample_num
                              - np.sum([n == class_name for n in gt_names]))
            sampled_num_dict[class_name] = np.round(
                self._rate * sampled_num).astype(np.int64)

        sampled = []
        sampled_gt_boxes = []
        avoid_coll_boxes = gt_boxes
        for class_name in self._sample_classes:
            sampled_num = sampled_num_dict[class_name]
            if sampled_num <= 0:
                continue
            sampled_cls = self.sample_class_v2(class_name, sampled_num,
                                               avoid_coll_boxes)
            sampled += sampled_cls
            if sampled_cls:
                sampled_gt_box = np.stack(
                    [s["box3d_lidar"] for s in sampled_cls], axis=0)
                sampled_gt_boxes.append(sampled_gt_box)
                avoid_coll_boxes = np.concatenate(
                    [avoid_coll_boxes, sampled_gt_box], axis=0)
        if not sampled:
            return None

        sampled_gt_boxes = np.concatenate(sampled_gt_boxes, axis=0)
        s_points_list = []
        for info in sampled:
            path = pathlib.Path(root_path) / info["path"]
            try:
                s_points = np.fromfile(str(path), dtype=np.float32).reshape(
                    -1, num_point_features)
            except (OSError, ValueError):
                self.logger.warning("failed reading %s", path)
                continue
            s_points[:, :3] += info["box3d_lidar"][:3]
            s_points_list.append(s_points)
        return {
            "gt_names": np.array([s["name"] for s in sampled]),
            "difficulty": np.array([s.get("difficulty", 0)
                                    for s in sampled]),
            "gt_boxes": sampled_gt_boxes,
            "points": (np.concatenate(s_points_list, axis=0)
                       if s_points_list
                       else np.zeros((0, num_point_features), np.float32)),
            "gt_masks": np.ones((len(sampled),), dtype=np.bool_),
        }

    def sample_class_v2(self, name, num, gt_boxes):
        """Draw `num` of class `name`; keep those whose BEV footprint
        collides with no box of `gt_boxes` and no kept draw before them."""
        if name not in self._sampler_dict:
            return []
        sampled = copy.deepcopy(self._sampler_dict[name].sample(num))
        if not sampled:
            return []
        num_gt = gt_boxes.shape[0]
        num_sampled = len(sampled)
        gt_boxes_bv = box_np_ops.center_to_corner_box2d(
            gt_boxes[:, 0:2], gt_boxes[:, 3:5], gt_boxes[:, -1])
        sp_boxes = np.stack([i["box3d_lidar"] for i in sampled], axis=0)
        sp_boxes_bv = box_np_ops.center_to_corner_box2d(
            sp_boxes[:, 0:2], sp_boxes[:, 3:5], sp_boxes[:, -1])
        total_bv = np.concatenate([gt_boxes_bv, sp_boxes_bv], axis=0)
        coll_mat = box_np_ops.box_collision_test(total_bv, total_bv)
        diag = np.arange(total_bv.shape[0])
        coll_mat[diag, diag] = False

        valid_samples = []
        for i in range(num_gt, num_gt + num_sampled):
            if coll_mat[i].any():
                coll_mat[i] = False
                coll_mat[:, i] = False
            else:
                valid_samples.append(sampled[i - num_gt])
        return valid_samples


def build_db_sampler(cfg, logger=None):
    """The sampler of a config's `db_sampler` dict: its dbinfos pkl
    (`db_info_path`), filtered by `db_prep_steps`, its `sample_groups`,
    `rate` and `global_random_rotation_range_per_object`; `seed` (a key of
    the port's, default 0) seeds its generator."""
    logger = logger or logging.getLogger("db_sampler")
    cfg = dict(cfg)
    with open(cfg["db_info_path"], "rb") as f:
        db_infos = pickle.load(f)
    for prep_cfg in cfg.get("db_prep_steps", []):
        if "filter_by_difficulty" in prep_cfg:
            db_infos = filter_by_difficulty(
                db_infos, prep_cfg["filter_by_difficulty"])
        if "filter_by_min_num_points" in prep_cfg:
            db_infos = filter_by_min_num_points(
                db_infos, prep_cfg["filter_by_min_num_points"])
    return DataBaseSampler(
        db_infos, cfg["sample_groups"], rate=cfg.get("rate", 1.0),
        global_rot_range=cfg.get("global_random_rotation_range_per_object"),
        logger=logger, seed=cfg.get("seed", 0))
