"""nuScenes helpers of the eval path: the category -> detection name map,
attribute priors and the box conversions of the devkit export.

The port's copy of the pieces of `pillarnet_lts_tpu/datasets/nuscenes/
nusc_common.py` that evaluation and the dataset need. The devkit
(`nuscenes`, `pyquaternion`) is imported only by the export functions, and
only when they are called. `create_nuscenes_infos` (info creation, which
needs the devkit) is not ported.
"""

import numpy as np

general_to_detection = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.wheelchair": "ignore",
    "human.pedestrian.stroller": "ignore",
    "human.pedestrian.personal_mobility": "ignore",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "animal": "ignore",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": "ignore",
    "vehicle.emergency.police": "ignore",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.pushable_pullable": "ignore",
    "movable_object.debris": "ignore",
    "static_object.bicycle_rack": "ignore",
}

# attribute frequency priors for detections with ambiguous attributes
# (most-frequent attribute per class on nuScenes train)
cls_attr_dist = {
    "barrier": {"": 1},
    "traffic_cone": {"": 1},
    "bicycle": {"cycle.without_rider": 1},
    "motorcycle": {"cycle.without_rider": 1},
    "car": {"vehicle.parked": 1},
    "bus": {"vehicle.stopped": 1},
    "construction_vehicle": {"vehicle.parked": 1},
    "trailer": {"vehicle.parked": 1},
    "truck": {"vehicle.parked": 1},
    "pedestrian": {"pedestrian.standing": 1},
}


def second_det_to_nusc_box(detection):
    """Detector output dict -> list of nuscenes Box objects
    (`nusc_common.py:160-185` `_second_det_to_nusc_box`).

    Requires the nuscenes-devkit (pyquaternion); imported lazily.
    """
    from nuscenes.utils.data_classes import Box
    from pyquaternion import Quaternion

    box3d = np.asarray(detection["box3d_lidar"])
    scores = np.asarray(detection["scores"])
    labels = np.asarray(detection["label_preds"])
    box3d = box3d.copy()
    box3d[:, -1] = -box3d[:, -1] - np.pi / 2

    box_list = []
    for i in range(box3d.shape[0]):
        quat = Quaternion(axis=[0, 0, 1], radians=box3d[i, -1])
        velocity = ((*box3d[i, 6:8], 0.0) if box3d.shape[1] == 9
                    else (np.nan,) * 3)
        box = Box(
            box3d[i, :3],
            box3d[i, [4, 3, 5]],  # wlh -> nusc (w, l, h) ordering
            quat,
            label=int(labels[i]),
            score=float(scores[i]),
            velocity=velocity,
        )
        box_list.append(box)
    return box_list


def lidar_nusc_box_to_global(nusc, boxes, sample_token):
    """Ego->global transform (`nusc_common.py:188-203`)."""
    from pyquaternion import Quaternion

    s_record = nusc.get("sample", sample_token)
    sample_data_token = s_record["data"]["LIDAR_TOP"]
    sd_record = nusc.get("sample_data", sample_data_token)
    cs_record = nusc.get(
        "calibrated_sensor", sd_record["calibrated_sensor_token"]
    )
    pose_record = nusc.get("ego_pose", sd_record["ego_pose_token"])

    box_list = []
    for box in boxes:
        box.rotate(Quaternion(cs_record["rotation"]))
        box.translate(np.array(cs_record["translation"]))
        box.rotate(Quaternion(pose_record["rotation"]))
        box.translate(np.array(pose_record["translation"]))
        box_list.append(box)
    return box_list


def _quaternion_yaw(q):
    """Yaw of a nuScenes box orientation quaternion."""
    v = q.rotate(np.array([1.0, 0.0, 0.0]))
    return np.arctan2(v[1], v[0])
