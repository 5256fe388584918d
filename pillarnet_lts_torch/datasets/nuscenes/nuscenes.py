"""nuScenes dataset (the port's copy of the JAX package's
`datasets/nuscenes/nuscenes.py`).

Info-pkl loading with train-time CBGS class-balanced resampling, the
pipeline-driven `get_sensor_data`, and evaluation: the official devkit
when `nuscenes` imports (lidar -> global boxes and attributes, exported
to json, scored by `NuScenesEval`), else the native detection_cvpr_2019
evaluator (`nusc_eval.py`) straight from the info pkls. The CBGS draws come
from `np.random.RandomState(seed)`, which gives what the JAX package draws
from numpy's global state after `np.random.seed(seed)`.
"""

import json
import operator
import pickle
from pathlib import Path

import numpy as np

from ..custom import PointCloudDataset
from ..registry import DATASETS
from .nusc_common import (cls_attr_dist, general_to_detection,
                          lidar_nusc_box_to_global, second_det_to_nusc_box)
from .nusc_eval import evaluate_nusc, gt_from_infos, preds_from_detections


def cbgs_resample(infos, class_names, rng):
    """Class-balanced resampling (CBGS): per class, the frames holding it
    drawn with replacement, as many as bring the class to 1 / len(classes)
    of the duplicated samples."""
    cls_infos = {name: [] for name in class_names}
    for info in infos:
        for name in set(info["gt_names"]):
            if name in class_names:
                cls_infos[name].append(info)
    duplicated = sum(len(v) for v in cls_infos.values())
    cls_dist = {k: len(v) / max(duplicated, 1) for k, v in cls_infos.items()}
    frac = 1.0 / len(class_names)
    ratios = [frac / v if v > 0 else 0.0 for v in cls_dist.values()]
    out = []
    for group, ratio in zip(list(cls_infos.values()), ratios):
        # RandomState.choice with replacement draws randint(0, len(group))
        # whether it is given the list or its length
        out += [group[i] for i in rng.choice(len(group),
                                             int(len(group) * ratio))]
    return out


@DATASETS.register_module
class NuScenesDataset(PointCloudDataset):
    NumPointFeatures = 5  # x, y, z, intensity, ring index

    def __init__(self, info_path, root_path, nsweeps=0, cfg=None,
                 pipeline=None, class_names=None, test_mode=False,
                 version="v1.0-trainval", load_interval=1, seed=0, **kwargs):
        self.load_interval = load_interval
        super().__init__(root_path, info_path, pipeline, test_mode=test_mode,
                         class_names=class_names, seed=seed)
        self.nsweeps = nsweeps
        if self.nsweeps <= 0:
            raise ValueError("NuScenesDataset needs nsweeps >= 1")
        self.load_infos(self._info_path)
        self._num_point_features = NuScenesDataset.NumPointFeatures
        self._name_mapping = general_to_detection
        self.virtual = kwargs.get("virtual", False)
        if self.virtual:
            self._num_point_features = 16
        self.version = version
        self.eval_version = "detection_cvpr_2019"

    def load_infos(self, info_path):
        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        infos = infos[::self.load_interval]
        if not self.test_mode:
            self._nusc_infos = cbgs_resample(
                infos, self._class_names, np.random.RandomState(self.seed))
        elif isinstance(infos, dict):
            self._nusc_infos = [i for v in infos.values() for i in v]
        else:
            self._nusc_infos = infos

    def __len__(self):
        return len(self._nusc_infos)

    def get_sensor_data(self, idx):
        info = self._nusc_infos[idx]
        res = {
            "lidar": {"type": "lidar", "points": None,
                      "nsweeps": self.nsweeps, "annotations": None},
            "metadata": {"image_prefix": self._root_path,
                         "num_point_features": self._num_point_features,
                         "token": info["token"]},
            "calib": None,
            "cam": {},
            "mode": "val" if self.test_mode else "train",
            "virtual": self.virtual,
            "rng": self.sample_rng(idx),
        }
        data, _ = self.pipeline(res, info)
        return data

    def evaluation_native(self, detections, output_dir=None, testset=False,
                          device="cuda"):
        """mAP / NDS by the native detection_cvpr_2019 evaluator, in the
        lidar frame straight from the info pkls (numpy on the host;
        `device` is not used)."""
        if testset:
            return None, None
        mapped = [self._name_mapping.get(n, n) for n in self._class_names]
        metrics = evaluate_nusc(gt_from_infos(self._nusc_infos),
                                preds_from_detections(detections, mapped),
                                verbose=False)
        detail = {}
        result = "Nusc (native eval) Evaluation\n"
        for cname in mapped:
            aps = metrics["label_aps"].get(cname)
            if aps is None:
                continue
            detail[cname] = {f"dist@{k}": v for k, v in aps.items()}
            result += f"{cname}: mean AP {np.mean(list(aps.values())):.4f}\n"
        result += (f"mAP: {metrics['mean_ap']:.4f}  "
                   f"NDS: {metrics['nd_score']:.4f}\n")
        if output_dir:
            with open(Path(output_dir) / "metrics_summary.json", "w") as f:
                json.dump({k: metrics[k] for k in
                           ("mean_ap", "nd_score", "label_aps", "tp_errors")},
                          f, default=float)
        return {"results": {"nusc": result}, "detail": {"nusc": detail}}, None

    def evaluation(self, detections, output_dir=None, testset=False,
                   device="cuda"):
        """The official devkit evaluation of `detections` ({token: dict
        with box3d_lidar / scores / label_preds / metadata}); the native
        evaluator when the nuscenes-devkit does not import."""
        try:
            from nuscenes import NuScenes
            from nuscenes.eval.detection.config import config_factory
        except ImportError:
            print("nuscenes-devkit not installed: using the native "
                  "detection_cvpr_2019 evaluator")
            return self.evaluation_native(detections, output_dir, testset)

        eval_set_map = {"v1.0-mini": "mini_val", "v1.0-trainval": "val",
                        "v1.0-test": "test"}
        nusc = NuScenes(version=self.version,
                        dataroot=str(self._root_path), verbose=True)
        mapped = [self._name_mapping.get(n, n) for n in self._class_names]
        nusc_annos = {"results": {}, "meta": None}
        for det in detections.values():
            token = det["metadata"]["token"]
            annos = []
            boxes = lidar_nusc_box_to_global(
                nusc, second_det_to_nusc_box(det), token)
            for box in boxes:
                name = mapped[box.label]
                if np.sqrt(box.velocity[0] ** 2 + box.velocity[1] ** 2) > 0.2:
                    if name in ("car", "construction_vehicle", "bus",
                                "truck", "trailer"):
                        attr = "vehicle.moving"
                    elif name in ("bicycle", "motorcycle"):
                        attr = "cycle.with_rider"
                    else:
                        attr = None
                elif name == "pedestrian":
                    attr = "pedestrian.standing"
                elif name == "bus":
                    attr = "vehicle.stopped"
                else:
                    attr = None
                if attr is None:
                    attr = max(cls_attr_dist[name].items(),
                               key=operator.itemgetter(1))[0]
                annos.append({
                    "sample_token": token,
                    "translation": box.center.tolist(),
                    "size": box.wlh.tolist(),
                    "rotation": box.orientation.elements.tolist(),
                    "velocity": box.velocity[:2].tolist(),
                    "detection_name": name,
                    "detection_score": box.score,
                    "attribute_name": attr,
                })
            nusc_annos["results"][token] = annos
        nusc_annos["meta"] = {"use_camera": False, "use_lidar": True,
                              "use_radar": False, "use_map": False,
                              "use_external": False}

        name = self._info_path.split("/")[-1].split(".")[0]
        res_path = str(Path(output_dir) / Path(name + ".json"))
        with open(res_path, "w") as f:
            json.dump(nusc_annos, f)
        print(f"Saved predictions to {res_path}")
        if testset:
            return None, None

        from nuscenes.eval.detection.evaluate import NuScenesEval

        nusc_eval = NuScenesEval(
            nusc, config=config_factory(self.eval_version),
            result_path=res_path, eval_set=eval_set_map[self.version],
            output_dir=output_dir, verbose=True)
        nusc_eval.main(plot_examples=0)
        with open(Path(output_dir) / "metrics_summary.json") as f:
            metrics = json.load(f)
        detail = {}
        result = f"Nusc {self.version} Evaluation\n"
        for cname in mapped:
            detail[cname] = {f"dist@{k}": v for k, v in
                             metrics["label_aps"][cname].items()}
            scores = list(metrics["label_aps"][cname].values())
            result += f"{cname}: mean AP {sum(scores) / len(scores):.4f}\n"
        result += (f"mAP: {metrics['mean_ap']:.4f}  "
                   f"NDS: {metrics['nd_score']:.4f}\n")
        return {"results": {"nusc": result}, "detail": {"nusc": detail}}, None
