"""Synthetic dataset of demo scenes (the JAX package's `datasets/demo.py`).

Frame i of a dataset seeded s is `synth.synth_scene(s + i, ...)`: ground
boxes with points inside and clutter around them, 5 point features (x, y,
z, intensity, time lag 0). It runs through the config's pipeline, and its
`evaluation` scores the center-distance mAP against the scenes' own ground
truth, so the whole eval path runs without real data.
"""

import numpy as np

from .custom import PointCloudDataset
from .eval_metric import center_distance_map
from .registry import DATASETS
from .synth import synth_scene


@DATASETS.register_module
class DemoDataset(PointCloudDataset):
    NumPointFeatures = 5

    def __init__(self, root_path="", info_path="", num_frames=16,
                 num_points=20000, pc_range=(-54, -54, -5, 54, 54, 3),
                 class_names=None, pipeline=None, test_mode=False, seed=0,
                 **kwargs):
        super().__init__(root_path, info_path, pipeline=pipeline,
                         test_mode=test_mode, class_names=class_names)
        self.num_frames = num_frames
        self.num_points = num_points
        self.pc_range = pc_range
        # the scenes' seed; the base class's `seed` (the loader's) draws
        # nothing here
        self.scene_seed = seed
        self.class_names = class_names or ["car", "pedestrian"]
        self._metadata = [
            {"image_prefix": "", "num_point_features": 5,
             "token": f"demo_{i}"} for i in range(num_frames)]

    def __len__(self):
        return self.num_frames

    def _synth_frame(self, idx):
        return synth_scene(self.scene_seed + idx, self.num_points,
                           self.pc_range, self.class_names)

    def evaluation(self, detections, output_dir=None, testset=False,
                   device="cuda"):
        """Center-distance mAP against the scenes' ground truth (numpy on
        the host; `device` is not used)."""
        gts = {}
        for i in range(self.num_frames):
            _, boxes, names = self._synth_frame(i)
            labels = np.array([self.class_names.index(n) for n in names],
                              np.int64)
            gts[self._metadata[i]["token"]] = {"box3d_lidar": boxes,
                                               "label_preds": labels}
        result = center_distance_map(detections, gts, self.class_names)
        summary = ", ".join(f"{k}: {v:.3f}"
                            for k, v in result["per_class"].items())
        text = f"demo mAP {result['mAP']:.3f} ({summary})"
        return {"results": {"demo": text}, "detail": {"demo": result}}, None

    def get_sensor_data(self, idx):
        points, boxes, names = self._synth_frame(idx)
        res = {
            "type": "DemoDataset",
            "lidar": {"type": "lidar", "points": points, "combined": points,
                      "nsweeps": 1,
                      "annotations": {"boxes": boxes, "names": names}},
            "metadata": self._metadata[idx],
            "mode": "val" if self.test_mode else "train",
            "virtual": False,
            "rng": self.sample_rng(idx),
        }
        info = {"gt_boxes": boxes, "gt_names": names,
                "token": self._metadata[idx]["token"]}
        if self.pipeline is None:
            return res, info
        data, _ = self.pipeline(res, info)
        return data
