"""Train preprocessing and CenterNet target assignment (numpy, host).

The port's own copy of `pillarnet_lts_tpu/datasets/pipelines/preprocess.py`
(`Preprocess`, `flatten`, `merge_multi_group_label`, `AssignLabel`).
`Preprocess` in train mode runs the JAX package's steps in its order:
drop `DontCare` / `ignore` / `UNKNOWN` boxes, keep boxes with at least
`min_points_in_gt` points, GT-AUG (`core/sampler/db_sampler.py`: the raw
points inside the pasted boxes go, the pasted objects' points come
first), keep the boxes of `class_names` and number them from 1, then flip,
rotate, scale and translate the scene (`core/sampler/augment.py`), and
shuffle the points. `no_augmentation=True` keeps only the class filter
and the shuffle. Every draw but GT-AUG's comes from the sample's
generator `res["rng"]` (which the dataset makes), where the JAX package
draws from numpy's global state; GT-AUG draws from the sampler's own
generator. `AssignLabel` gives the same arrays, bit for bit: per task `hm`
(H, W, C), `anno_box` (max_objs, 10), `ind`, `mask`, `cat` (max_objs,) and
`gt_box` (max_objs, 7), plus `gt_boxes_and_cls` (max_objs, 10).
"""

import numpy as np

from ...core.bbox import box_np_ops
from ...core.bbox.box_np_ops import limit_period  # noqa: F401  (its old home)
from ...core.sampler import augment
from ...core.sampler.db_sampler import build_db_sampler
from ...core.target.center_target import draw_gaussian, gaussian_radius
from ..registry import PIPELINES

_DROPPED_NAMES = ("DontCare", "ignore", "UNKNOWN")


def _dict_select(dict_, inds):
    for k, v in dict_.items():
        dict_[k] = v[inds]


def shuffle_rows(rng, points):
    """`rng.shuffle(points)`, in place, with the same draws and the same
    order: the legacy shuffle swaps a 2-D array's rows one by one under
    the interpreter lock, `permutation` makes the same swaps on an index
    array, and one gather applies them."""
    points[...] = points[rng.permutation(len(points))]


def flatten(box):
    return np.concatenate(box, axis=0)


def merge_multi_group_label(gt_classes, num_classes_by_task):
    flag = 0
    for i in range(len(gt_classes)):
        gt_classes[i] = gt_classes[i] + flag
        flag += num_classes_by_task[i]
    return flatten(gt_classes)


@PIPELINES.register_module
class Preprocess:
    """Train mode: the ground truth filtered and augmented (module
    docstring) as `annotations` {gt_boxes, gt_names, gt_classes}; val
    mode: points only. The cloud is `combined` (points and time lag), or
    a single-sweep Waymo frame's `points`; the augmentations change it in
    place."""

    def __init__(self, cfg):
        self.mode = cfg["mode"]
        self.shuffle_points = cfg["shuffle_points"]
        self.min_points_in_gt = cfg.get("min_points_in_gt", -1)
        self.no_augmentation = cfg.get("no_augmentation", False)
        self.db_sampler = None
        if self.mode == "train":
            self.class_names = cfg["class_names"]
        if self.mode == "train" and not self.no_augmentation:
            self.global_rotation_noise = cfg["global_rot_noise"]
            self.global_scaling_noise = cfg["global_scale_noise"]
            self.global_translate_std = cfg.get("global_translate_std", 0)
            sampler = cfg.get("db_sampler")
            if sampler is not None and sampler.get("enable", True):
                self.db_sampler = build_db_sampler(sampler)

    def __call__(self, res, info):
        res["mode"] = self.mode
        if res["type"] == "WaymoDataset":
            points = res["lidar"].get("combined", res["lidar"]["points"])
        elif res["type"] in ("NuScenesDataset", "DemoDataset"):
            points = res["lidar"]["combined"]
        else:
            raise NotImplementedError(f"dataset type {res['type']!r}")
        if self.mode == "train":
            anno = res["lidar"]["annotations"]
            gt_dict = {"gt_boxes": anno["boxes"],
                       "gt_names": np.array(anno["names"]).reshape(-1)}
            if self.no_augmentation:
                keep = self._class_mask(gt_dict)
            else:
                points, keep = self._augment(res, points, gt_dict)
            _dict_select(gt_dict, keep)
            gt_dict["gt_classes"] = np.array(
                [self.class_names.index(n) + 1 for n in gt_dict["gt_names"]],
                dtype=np.int32)
            if not self.no_augmentation:
                self._global_noise(res["rng"], gt_dict, points)
            res["lidar"]["annotations"] = gt_dict
        if self.shuffle_points:
            shuffle_rows(res["rng"], points)
        res["lidar"]["points"] = points
        return res, info

    def _class_mask(self, gt_dict):
        return np.array([n in self.class_names for n in gt_dict["gt_names"]],
                        dtype=np.bool_)

    def _augment(self, res, points, gt_dict):
        """The steps before the class filter: returns the cloud (with any
        GT-AUG objects) and the class mask of `gt_dict`'s boxes."""
        _dict_select(gt_dict, np.array(
            [i for i, n in enumerate(gt_dict["gt_names"])
             if n not in _DROPPED_NAMES], dtype=np.int64))
        if self.min_points_in_gt > 0:
            counts = box_np_ops.points_count_rbbox(points,
                                                   gt_dict["gt_boxes"])
            _dict_select(gt_dict, counts >= self.min_points_in_gt)
        keep = self._class_mask(gt_dict)
        if self.db_sampler is None:
            return points, keep
        sampled = self.db_sampler.sample_all(
            res["metadata"]["image_prefix"], gt_dict["gt_boxes"],
            gt_dict["gt_names"], res["metadata"]["num_point_features"])
        if sampled is None:
            return points, keep
        gt_dict["gt_names"] = np.concatenate(
            [gt_dict["gt_names"], sampled["gt_names"]], axis=0)
        gt_dict["gt_boxes"] = np.concatenate(
            [gt_dict["gt_boxes"], sampled["gt_boxes"]])
        keep = np.concatenate([keep, sampled["gt_masks"]], axis=0)
        inside = box_np_ops.points_in_rbbox(
            points, sampled["gt_boxes"][sampled["gt_masks"]])
        points = points[np.logical_not(inside.any(-1))]
        return np.concatenate([sampled["points"], points], axis=0), keep

    def _global_noise(self, rng, gt_dict, points):
        boxes = gt_dict["gt_boxes"]
        augment.random_flip_both(boxes, points, rng)
        augment.global_rotation(boxes, points, rng,
                                rotation=self.global_rotation_noise)
        augment.global_scaling_v2(boxes, points, rng,
                                  *self.global_scaling_noise)
        augment.global_translate_(boxes, points, rng,
                                  self.global_translate_std)


@PIPELINES.register_module
class AssignLabel:
    """CenterNet target encoding (`pipelines/preprocess.py:178-350`)."""

    def __init__(self, cfg):
        self.tasks = cfg["target_assigner"]["tasks"]
        self.gaussian_overlap = cfg["gaussian_overlap"]
        self._max_objs = cfg["max_objs"]
        self._min_radius = cfg["min_radius"]
        self._cfg = cfg

    def __call__(self, res, info):
        max_objs = self._max_objs
        class_names_by_task = [t["class_names"] for t in self.tasks]
        num_classes_by_task = [len(t["class_names"]) for t in self.tasks]

        pc_range = np.array(self._cfg["pc_range"], dtype=np.float32)
        pillar_size = np.array(self._cfg["pillar_size"], dtype=np.float32)
        grid_size = np.round(
            (pc_range[3:5] - pc_range[:2]) / pillar_size).astype(np.int64)

        example = {}
        if res["mode"] == "train":
            gt_dict = res["lidar"]["annotations"]

            # the annotations regrouped by task, classes numbered per task
            task_boxes, task_classes, task_names = [], [], []
            flag = 0
            for names in class_names_by_task:
                masks = [np.where(gt_dict["gt_classes"]
                                  == names.index(i) + 1 + flag)
                         for i in names]
                task_boxes.append(np.concatenate(
                    [gt_dict["gt_boxes"][m] for m in masks], axis=0))
                task_classes.append(np.concatenate(
                    [gt_dict["gt_classes"][m] - flag for m in masks]))
                task_names.append(np.concatenate(
                    [gt_dict["gt_names"][m] for m in masks]))
                flag += len(names)

            for task_box in task_boxes:
                task_box[:, -1] = limit_period(task_box[:, -1], offset=0.5,
                                               period=np.pi * 2)

            gt_dict["gt_classes"] = task_classes
            gt_dict["gt_names"] = task_names
            gt_dict["gt_boxes"] = task_boxes
            res["lidar"]["annotations"] = gt_dict

            hms, anno_boxs, inds, masks, cats, gt_boxs = [], [], [], [], [], []
            for idx, task in enumerate(self.tasks):
                stride = int(task["stride"])
                task_grid = grid_size // stride
                hm = np.zeros((len(class_names_by_task[idx]), task_grid[1],
                               task_grid[0]), dtype=np.float32)
                anno_box = np.zeros((max_objs, 10), dtype=np.float32)
                gt_box = np.zeros((max_objs, 7), dtype=np.float32)
                ind = np.zeros((max_objs), dtype=np.int64)
                mask = np.zeros((max_objs), dtype=np.uint8)
                cat = np.zeros((max_objs), dtype=np.int64)

                num_objs = min(gt_dict["gt_boxes"][idx].shape[0], max_objs)
                for k in range(num_objs):
                    box = gt_dict["gt_boxes"][idx][k]
                    cls_id = gt_dict["gt_classes"][idx][k] - 1
                    w = box[3] / (pillar_size * stride)
                    l = box[4] / (pillar_size * stride)  # noqa: E741
                    if w <= 0 or l <= 0:
                        continue
                    radius = gaussian_radius(
                        (l, w), min_overlap=self.gaussian_overlap)
                    if isinstance(self._min_radius, list):
                        radius = max(self._min_radius[cls_id], int(radius))
                    else:
                        radius = max(self._min_radius, int(radius))

                    x, y, z = box[0], box[1], box[2]
                    coor_x = (x - pc_range[0]) / (pillar_size * stride)
                    coor_y = (y - pc_range[1]) / (pillar_size * stride)
                    ct = np.array([coor_x, coor_y], dtype=np.float32)
                    ct_int = ct.astype(np.int32)
                    if not (0 <= ct_int[0] < task_grid[0]
                            and 0 <= ct_int[1] < task_grid[1]):
                        continue

                    draw_gaussian(hm[cls_id], ct, radius)

                    xi, yi = ct_int[0], ct_int[1]
                    cat[k] = cls_id
                    ind[k] = yi * task_grid[0] + xi
                    mask[k] = 1
                    gt_box[k] = (box[[0, 1, 2, 3, 4, 5, 8]]
                                 if box.shape[0] > 7
                                 else box[[0, 1, 2, 3, 4, 5, 6]])
                    if box.shape[0] > 7:
                        vx, vy = box[6:8]
                        rot = box[8] if res["type"] in (
                            "NuScenesDataset", "DemoDataset") else box[-1]
                    else:
                        vx, vy = 0.0, 0.0
                        rot = box[-1]
                    anno_box[k] = np.concatenate(
                        (ct - (xi, yi), z, np.log(box[3:6]), np.array(vx),
                         np.array(vy), np.sin(rot), np.cos(rot)), axis=None)

                hms.append(hm.transpose((1, 2, 0)))
                anno_boxs.append(anno_box)
                gt_boxs.append(gt_box)
                masks.append(mask)
                inds.append(ind)
                cats.append(cat)

            # the flattened ground truth of the two-stage head
            boxes = flatten(gt_dict["gt_boxes"])
            classes = merge_multi_group_label(gt_dict["gt_classes"],
                                              num_classes_by_task)
            gt_boxes_and_cls = np.zeros((max_objs, 10), dtype=np.float32)
            if boxes.shape[0] > 0:
                boxes_and_cls = np.concatenate(
                    (boxes, classes.reshape(-1, 1).astype(np.float32)),
                    axis=1)
                num_obj = min(len(boxes_and_cls), max_objs)
                if boxes.shape[1] == 9:
                    boxes_and_cls = boxes_and_cls[
                        :, [0, 1, 2, 3, 4, 5, 8, 6, 7, 9]]
                gt_boxes_and_cls[:num_obj] = boxes_and_cls[:num_obj]
            example.update(gt_boxes_and_cls=gt_boxes_and_cls, hm=hms,
                           anno_box=anno_boxs, ind=inds, mask=masks, cat=cats,
                           gt_box=gt_boxs)
        res["lidar"]["targets"] = example
        return res, info
