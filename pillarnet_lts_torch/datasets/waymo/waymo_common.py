"""Waymo devkit export (det3d's `waymo_common.py:53-117`).

The port's own copy of `pillarnet_lts_tpu/datasets/waymo/waymo_common.py`:
detections (det3d box convention) -> `metrics_pb2.Objects` in
`detection_pred.bin`, and the infos' ground truth -> `gt.bin`, for the
devkit's `compute_detection_metrics_main`. The devkit
(`waymo-open-dataset`) is imported when a function is called, so the
module imports without it; without it each export raises ImportError,
and `WaymoDataset.evaluation` scores natively instead.
"""

import os
import pickle

import numpy as np

LABEL_TO_TYPE = {0: 1, 1: 2, 2: 4}  # VEHICLE, PEDESTRIAN, CYCLIST


def _devkit():
    from waymo_open_dataset import label_pb2
    from waymo_open_dataset.protos import metrics_pb2

    return label_pb2, metrics_pb2


def _create_pd_detection(detections, infos, result_path, tracking=False):
    """{token: detection} with `infos` {token: info} -> `detection_pred.bin`
    under `result_path`; returns its path."""
    label_pb2, metrics_pb2 = _devkit()
    objects = metrics_pb2.Objects()

    for token, detection in detections.items():
        info = infos[token]
        obj = get_obj_anno(info)

        box3d = np.asarray(detection["box3d_lidar"])
        scores = np.asarray(detection["scores"])
        labels = np.asarray(detection["label_preds"])
        # det3d yaw -> Waymo heading
        box3d = box3d.copy()
        box3d[:, -1] = -box3d[:, -1] - np.pi / 2

        for i in range(box3d.shape[0]):
            det = box3d[i]
            o = metrics_pb2.Object()
            o.context_name = obj["scene_name"]
            o.frame_timestamp_micros = int(obj["frame_name"].split("_")[-1])

            box = label_pb2.Label.Box()
            box.center_x = det[0]
            box.center_y = det[1]
            box.center_z = det[2]
            box.length = det[4]
            box.width = det[3]
            box.height = det[5]
            box.heading = det[-1]
            o.object.box.CopyFrom(box)
            o.score = float(scores[i])
            o.object.type = LABEL_TO_TYPE[int(labels[i])]
            objects.objects.append(o)

    path = os.path.join(result_path, "detection_pred.bin")
    with open(path, "wb") as f:
        f.write(objects.SerializeToString())
    return path


def get_obj_anno(info):
    """The frame's anno pkl (its `scene_name`, `frame_name`), or both names
    taken from the info where the pkl is not on disk."""
    anno_path = info.get("anno_path")
    if anno_path is not None and os.path.exists(anno_path):
        with open(anno_path, "rb") as f:
            return pickle.load(f)
    return {
        "scene_name": info.get("scene_name",
                               info["token"].split("_frame_")[0]),
        "frame_name": info.get("frame_name", info["token"]),
    }


def _create_gt_detection(infos, result_path, tracking=False):
    """The infos' ground truth, back in the Waymo convention, -> `gt.bin`
    under `result_path`; returns its path."""
    label_pb2, metrics_pb2 = _devkit()
    objects = metrics_pb2.Objects()
    type_by_name = {"VEHICLE": 1, "PEDESTRIAN": 2, "CYCLIST": 4}

    for info in infos:
        obj = get_obj_anno(info)
        names = info.get("gt_names", [])
        boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 9))))
        if boxes.shape[0]:
            boxes = boxes.copy()
            # det3d -> Waymo: undo yaw' = -pi/2 - yaw and the l/w swap
            boxes[:, -1] = -np.pi / 2 - boxes[:, -1]
            boxes[:, [3, 4]] = boxes[:, [4, 3]]
        for i in range(boxes.shape[0]):
            o = metrics_pb2.Object()
            o.context_name = obj["scene_name"]
            o.frame_timestamp_micros = int(obj["frame_name"].split("_")[-1])
            box = label_pb2.Label.Box()
            box.center_x = boxes[i, 0]
            box.center_y = boxes[i, 1]
            box.center_z = boxes[i, 2]
            box.length = boxes[i, 3]
            box.width = boxes[i, 4]
            box.height = boxes[i, 5]
            box.heading = boxes[i, -1]
            o.object.box.CopyFrom(box)
            o.score = 1.0
            o.object.type = type_by_name.get(str(names[i]), 0)
            objects.objects.append(o)

    path = os.path.join(result_path, "gt.bin")
    with open(path, "wb") as f:
        f.write(objects.SerializeToString())
    return path
