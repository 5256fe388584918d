"""Waymo Open dataset (the port's copy of the JAX package's
`datasets/waymo/waymo.py`).

Per-frame info pkls, optional class-balanced resampling (`sample`), the
pipeline-driven `get_sensor_data`, and evaluation as the JAX package's:
`detection_pred.bin` for the official metrics tool when
`waymo_open_dataset` imports (`waymo_common.py`), else the detections
pickled and scored by the native AP/APH evaluator (`waymo_eval.py`). The
resampling draws from `np.random.RandomState(seed)`.
"""

import json
import os
import pickle

import numpy as np

from ..custom import PointCloudDataset
from ..nuscenes.nuscenes import cbgs_resample
from ..registry import DATASETS
from . import waymo_common
from .waymo_eval import evaluate_waymo, gt_from_infos, preds_from_detections


@DATASETS.register_module
class WaymoDataset(PointCloudDataset):
    NumPointFeatures = 5  # x, y, z, intensity, elongation

    def __init__(self, info_path, root_path, cfg=None, pipeline=None,
                 class_names=None, test_mode=False, sample=False, nsweeps=1,
                 load_interval=1, seed=0, **kwargs):
        self.load_interval = load_interval
        self.sample = sample
        self.nsweeps = nsweeps
        print("Using {} sweeps".format(nsweeps))
        super().__init__(root_path, info_path, pipeline, test_mode=test_mode,
                         class_names=class_names, seed=seed)
        self._num_point_features = (WaymoDataset.NumPointFeatures
                                    if nsweeps == 1
                                    else WaymoDataset.NumPointFeatures + 1)
        self.load_infos(self._info_path)

    def load_infos(self, info_path):
        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        self._waymo_infos = infos[::self.load_interval]
        if not self.test_mode and self.sample:
            self._waymo_infos = cbgs_resample(
                self._waymo_infos, self._class_names,
                np.random.RandomState(self.seed))
        print("Using {} frames".format(len(self._waymo_infos)))

    def __len__(self):
        return len(self._waymo_infos)

    def get_sensor_data(self, idx):
        info = self._waymo_infos[idx]
        res = {
            "lidar": {"type": "lidar", "points": None, "annotations": None,
                      "nsweeps": self.nsweeps},
            "metadata": {"image_prefix": self._root_path,
                         "num_point_features": self._num_point_features,
                         "token": info["token"]},
            "calib": None,
            "cam": {},
            "mode": "val" if self.test_mode else "train",
            "rng": self.sample_rng(idx),
        }
        data, _ = self.pipeline(res, info)
        return data

    def evaluation(self, detections, output_dir=None, testset=False,
                   device="cuda"):
        """With the waymo-open-dataset devkit: `detection_pred.bin` written
        to `output_dir` for its `compute_detection_metrics_main` (returns
        (None, None)). Without it: the detections pickled to
        `{output_dir}/detections.pkl`, then scored by the native
        evaluator."""
        try:
            waymo_common._devkit()
        except ImportError:
            pass
        else:
            infos = {info["token"]: info for info in self._waymo_infos}
            waymo_common._create_pd_detection(detections, infos, output_dir)
            print(f"Wrote detection_pred.bin to {output_dir}; use the Waymo "
                  "devkit compute_detection_metrics_main against gt.bin")
            return None, None
        if output_dir:
            out = os.path.join(output_dir, "detections.pkl")
            with open(out, "wb") as f:
                pickle.dump(detections, f)
            print(f"raw detections saved to {out}; computing native AP/APH")
        return self.evaluation_native(detections, output_dir, testset,
                                      device=device)

    def evaluation_native(self, detections, output_dir=None, testset=False,
                          device="cuda"):
        """Devkit-free Waymo AP/APH (L1 / L2), the IoU matrices on
        `device` (`waymo_eval.evaluate_waymo`)."""
        if testset:
            return None, None
        metrics = evaluate_waymo(gt_from_infos(self._waymo_infos),
                                 preds_from_detections(detections,
                                                       self._class_names),
                                 class_names=self._class_names,
                                 device=device)
        result = "Waymo (native eval)\n"
        detail = {}
        for level in ("LEVEL_1", "LEVEL_2"):
            for cls, v in metrics[level].items():
                result += (f"{level} {cls}: AP {v['AP']:.4f} "
                           f"APH {v['APH']:.4f}\n")
                detail[f"{level}/{cls}"] = dict(v)
        result += (f"mAP L1 {metrics['mAP_L1']:.4f} "
                   f"mAPH L1 {metrics['mAPH_L1']:.4f} "
                   f"mAP L2 {metrics['mAP_L2']:.4f} "
                   f"mAPH L2 {metrics['mAPH_L2']:.4f}\n")
        if output_dir:
            with open(os.path.join(output_dir, "waymo_metrics.json"),
                      "w") as f:
                json.dump(metrics, f, default=float)
        return {"results": {"waymo": result},
                "detail": {"waymo": detail}}, None
