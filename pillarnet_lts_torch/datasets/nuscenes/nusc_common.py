"""nuScenes helpers: the category -> detection name map, attribute priors,
the box conversions of the devkit export and the info creation.

The port's own copy of `pillarnet_lts_tpu/datasets/nuscenes/
nusc_common.py`. The devkit (`nuscenes`, `pyquaternion`) is imported only
by the functions that need it, and only when they are called: without it
they raise ImportError naming the missing package.
"""

import pickle
from functools import reduce
from pathlib import Path

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


def create_nuscenes_infos(root_path, version="v1.0-trainval", nsweeps=10,
                          filter_zero=True):
    """The info pkls of a nuScenes release under `root_path` (det3d's
    `nusc_common.py:548-623` and `_fill_trainval_infos:354-470`, the
    lidar's fields): per key frame the lidar path, the f64 transforms
    `ref_from_car` and `car_from_global`, `nsweeps - 1` earlier sweeps
    each with the f64 4x4 that moves its points into the key frame and its
    time lag, and outside the test split the boxes in det3d's 9-value
    layout, their velocities in the lidar frame, mapped names, tokens and
    attributes, boxes without lidar or radar points dropped with
    `filter_zero`. Writes `infos_{train,val}_{nsweeps:02d}sweeps_withvelo_
    filter_{filter_zero}.pkl` (v1.0-test: `infos_test_..._withvelo.pkl`),
    the JAX package's files byte for byte; returns (train, val) infos.
    Needs the devkit."""
    from nuscenes import NuScenes
    from nuscenes.utils import splits
    from nuscenes.utils.geometry_utils import transform_matrix
    from pyquaternion import Quaternion

    nusc = NuScenes(version=version, dataroot=root_path, verbose=True)

    if version == "v1.0-trainval":
        train_scenes, val_scenes = splits.train, splits.val
    elif version == "v1.0-test":
        train_scenes, val_scenes = splits.test, []
    elif version == "v1.0-mini":
        train_scenes, val_scenes = splits.mini_train, splits.mini_val
    else:
        raise ValueError("unknown nuScenes version")

    scene_name_to_token = {s["name"]: s["token"] for s in nusc.scene}
    train_tokens = {scene_name_to_token[n] for n in train_scenes
                    if n in scene_name_to_token}
    val_tokens = {scene_name_to_token[n] for n in val_scenes
                  if n in scene_name_to_token}
    test = version == "v1.0-test"

    train_infos, val_infos = [], []
    for sample in nusc.sample:
        ref_sd_token = sample["data"]["LIDAR_TOP"]
        ref_sd_rec = nusc.get("sample_data", ref_sd_token)
        ref_cs_rec = nusc.get(
            "calibrated_sensor", ref_sd_rec["calibrated_sensor_token"]
        )
        ref_pose_rec = nusc.get("ego_pose", ref_sd_rec["ego_pose_token"])
        ref_time = 1e-6 * ref_sd_rec["timestamp"]
        ref_lidar_path, ref_boxes, _ = nusc.get_sample_data(ref_sd_token)

        ref_from_car = transform_matrix(
            ref_cs_rec["translation"], Quaternion(ref_cs_rec["rotation"]),
            inverse=True,
        )
        car_from_global = transform_matrix(
            ref_pose_rec["translation"], Quaternion(ref_pose_rec["rotation"]),
            inverse=True,
        )

        info = {
            "lidar_path": str(ref_lidar_path),
            "token": sample["token"],
            "sweeps": [],
            "ref_from_car": ref_from_car,
            "car_from_global": car_from_global,
            "timestamp": ref_time,
        }

        # accumulate previous sweeps with keyframe transforms
        curr_sd_rec = ref_sd_rec
        sweeps = []
        while len(sweeps) < nsweeps - 1:
            if curr_sd_rec["prev"] == "":
                if len(sweeps) == 0:
                    sweeps.append({
                        "lidar_path": str(ref_lidar_path),
                        "sample_data_token": curr_sd_rec["token"],
                        "transform_matrix": None,
                        "time_lag": 0.0,
                    })
                else:
                    sweeps.append(sweeps[-1])
            else:
                curr_sd_rec = nusc.get("sample_data", curr_sd_rec["prev"])
                current_pose_rec = nusc.get(
                    "ego_pose", curr_sd_rec["ego_pose_token"]
                )
                global_from_car = transform_matrix(
                    current_pose_rec["translation"],
                    Quaternion(current_pose_rec["rotation"]), inverse=False,
                )
                current_cs_rec = nusc.get(
                    "calibrated_sensor", curr_sd_rec["calibrated_sensor_token"]
                )
                car_from_current = transform_matrix(
                    current_cs_rec["translation"],
                    Quaternion(current_cs_rec["rotation"]), inverse=False,
                )
                tm = reduce(np.dot, [ref_from_car, car_from_global,
                                     global_from_car, car_from_current])
                sweeps.append({
                    "lidar_path": nusc.get_sample_data_path(
                        curr_sd_rec["token"]
                    ),
                    "sample_data_token": curr_sd_rec["token"],
                    "transform_matrix": tm,
                    "time_lag": ref_time - 1e-6 * curr_sd_rec["timestamp"],
                })
        info["sweeps"] = sweeps

        if not test:
            annotations = [
                nusc.get("sample_annotation", t) for t in sample["anns"]
            ]
            locs = np.array([b.center for b in ref_boxes]).reshape(-1, 3)
            dims = np.array([b.wlh for b in ref_boxes]).reshape(-1, 3)
            # box_velocity is global-frame; rotate into the lidar frame the
            # way the reference does by transforming box.velocity along with
            # the box (`nusc_common.py:260-270,497`): v_ref = R_cs^-1 @
            # R_pose^-1 @ v_global. Regression targets and AVE are
            # lidar-frame quantities.
            rot_ref = ref_from_car[:3, :3] @ car_from_global[:3, :3]
            velocity = np.array(
                [nusc.box_velocity(t) for t in sample["anns"]]
            ).reshape(-1, 3) @ rot_ref.T
            rots = np.array(
                [_quaternion_yaw(b.orientation) for b in ref_boxes]
            ).reshape(-1, 1)
            names = np.array([b.name for b in ref_boxes])
            tokens = np.array([b.token for b in ref_boxes])
            # det3d 9-dim layout: x, y, z, w, l, h, vx, vy, -yaw - pi/2
            gt_boxes = np.concatenate(
                [locs, dims, velocity[:, :2], -rots - np.pi / 2], axis=1
            )
            mapped = np.array(
                [general_to_detection.get(n, n) for n in names]
            )
            num_pts = np.array(
                [a["num_lidar_pts"] + a["num_radar_pts"]
                 for a in annotations]
            )
            mask = np.ones(len(ref_boxes), bool)
            if filter_zero:
                # reference keeps boxes seen by lidar OR radar
                # (`nusc_common.py:492`)
                mask = num_pts > 0
            # attribute names (additive field beyond the reference layout):
            # feeds the native evaluator's AAE (`nusc_eval.py`); absent in
            # reference-created pkls, where AAE degrades gracefully
            attrs = np.array([
                nusc.get("attribute", a["attribute_tokens"][0])["name"]
                if a["attribute_tokens"] else ""
                for a in annotations
            ])
            info["gt_boxes"] = gt_boxes[mask]
            info["gt_boxes_velocity"] = velocity[mask]
            info["gt_names"] = mapped[mask]
            info["gt_boxes_token"] = tokens[mask]
            info["gt_attributes"] = attrs[mask]

        if sample["scene_token"] in train_tokens:
            train_infos.append(info)
        elif sample["scene_token"] in val_tokens:
            val_infos.append(info)

    root = Path(root_path)
    if test:
        with open(root / f"infos_test_{nsweeps:02d}sweeps_withvelo.pkl",
                  "wb") as f:
            pickle.dump(train_infos, f)
    else:
        for split, infos in (("train", train_infos), ("val", val_infos)):
            with open(root / f"infos_{split}_{nsweeps:02d}sweeps_withvelo_"
                      f"filter_{filter_zero}.pkl", "wb") as f:
                pickle.dump(infos, f)
    return train_infos, val_infos


def _quaternion_yaw(q):
    """Yaw of a nuScenes box orientation quaternion."""
    v = q.rotate(np.array([1.0, 0.0, 0.0]))
    return np.arctan2(v[1], v[0])
