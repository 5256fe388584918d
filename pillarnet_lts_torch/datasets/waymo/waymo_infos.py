"""Waymo info creation from the converter's per-frame pkls (no devkit).

The port's own copy of `pillarnet_lts_tpu/datasets/waymo/waymo_infos.py`
(det3d's `waymo_common.py:192-323`). `create_waymo_infos` walks
`{root}/{split}/lidar/seq_S_frame_F.pkl` in (sequence, frame) order and
writes `infos_{split}_{nsweeps:02d}sweeps_filter_zero_gt.pkl`: per frame
the lidar and anno paths, the token, the timestamp (s) and a chain of
`nsweeps - 1` earlier frames of its sequence, each with the f64 4x4
`transform_matrix` that moves its points into the frame
(`ref_from_global @ global_from_car`) and its `time_lag` (s); the first
frame of a sequence repeats itself with no transform. Outside the test
split the boxes go from the Waymo convention to det3d's (yaw' = -pi/2 -
yaw, length and width swapped), and only objects with points are kept,
with the additive `num_points_in_gt` and `difficulty` fields that the
native Waymo evaluator reads.
"""

import os
import pickle
from functools import reduce

import numpy as np

TYPE_LIST = ["UNKNOWN", "VEHICLE", "PEDESTRIAN", "SIGN", "CYCLIST"]


def get_obj(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def veh_pos_to_transform(veh_pos):
    """vehicle->global 4x4 -> (global_from_car, car_from_global)."""
    def _inverse_rigid(tm):
        inv = np.eye(4, dtype=tm.dtype)
        inv[:3, :3] = tm[:3, :3].T
        inv[:3, 3] = -tm[:3, :3].T @ tm[:3, 3]
        return inv

    return veh_pos, _inverse_rigid(veh_pos)


def _fill_infos(root_path, frames, split="train", nsweeps=1):
    infos = []
    for frame_name in frames:
        lidar_path = os.path.join(root_path, split, "lidar", frame_name)
        ref_path = os.path.join(root_path, split, "annos", frame_name)

        ref_obj = get_obj(ref_path)
        ref_time = 1e-6 * int(ref_obj["frame_name"].split("_")[-1])
        ref_pose = np.reshape(ref_obj["veh_to_global"], [4, 4])
        _, ref_from_global = veh_pos_to_transform(ref_pose)

        info = {
            "path": lidar_path,
            "anno_path": ref_path,
            "token": frame_name,
            "timestamp": ref_time,
            "sweeps": [],
        }

        sequence_id = int(frame_name.split("_")[1])
        frame_id = int(frame_name.split("_")[3][:-4])

        prev_id = frame_id
        sweeps = []
        while len(sweeps) < nsweeps - 1:
            if prev_id <= 0:
                if len(sweeps) == 0:
                    sweeps.append({
                        "path": lidar_path,
                        "token": frame_name,
                        "transform_matrix": None,
                        "time_lag": 0,
                    })
                else:
                    sweeps.append(sweeps[-1])
            else:
                prev_id -= 1
                curr_name = f"seq_{sequence_id}_frame_{prev_id}.pkl"
                curr_lidar_path = os.path.join(root_path, split, "lidar",
                                               curr_name)
                curr_label_path = os.path.join(root_path, split, "annos",
                                               curr_name)
                curr_obj = get_obj(curr_label_path)
                curr_pose = np.reshape(curr_obj["veh_to_global"], [4, 4])
                global_from_car, _ = veh_pos_to_transform(curr_pose)
                # f64, in this order: the reference's float order
                tm = reduce(np.dot, [ref_from_global, global_from_car])
                curr_time = int(curr_obj["frame_name"].split("_")[-1])
                sweeps.append({
                    "path": curr_lidar_path,
                    "transform_matrix": tm,
                    "time_lag": ref_time - 1e-6 * curr_time,
                })
        info["sweeps"] = sweeps

        if split != "test":
            annos = ref_obj["objects"]
            num_points_in_gt = np.array([a["num_points"] for a in annos])
            gt_boxes = np.array([a["box"] for a in annos]).reshape(-1, 9)
            if len(gt_boxes) != 0:
                # Waymo -> det3d convention
                gt_boxes[:, -1] = -np.pi / 2 - gt_boxes[:, -1]
                gt_boxes[:, [3, 4]] = gt_boxes[:, [4, 3]]
            gt_names = np.array([TYPE_LIST[a["label"]] for a in annos])
            mask = (num_points_in_gt > 0).reshape(-1)
            info["gt_boxes"] = gt_boxes[mask].astype(np.float32)
            info["gt_names"] = gt_names[mask].astype(str)
            info["num_points_in_gt"] = num_points_in_gt[mask].astype(
                np.int32)
            info["difficulty"] = np.array([
                a.get("difficulty", a.get("detection_difficulty_level", 0))
                for a in annos
            ])[mask].astype(np.int32)
        infos.append(info)
    return infos


def sort_frame(frames):
    """Frame file names in (sequence, frame) order: `np.argsort` of
    `seq * 1000 + frame`, as the reference sorts (not a stable sort)."""
    indices = []
    for f in frames:
        seq_id = int(f.split("_")[1])
        frame_id = int(f.split("_")[3][:-4])
        indices.append(seq_id * 1000 + frame_id)
    rank = list(np.argsort(np.array(indices)))
    return [frames[r] for r in rank]


def get_available_frames(root, split):
    dir_path = os.path.join(root, split, "lidar")
    frames = sort_frame(list(os.listdir(dir_path)))
    print(split, "split exist frame num:", len(frames))
    return frames


def create_waymo_infos(root_path, split="train", nsweeps=1):
    """Write the infos of `{root_path}/{split}`; returns their path."""
    frames = get_available_frames(root_path, split)
    infos = _fill_infos(root_path, frames, split, nsweeps)
    print(f"sample: {len(infos)}")
    out = os.path.join(root_path,
                       f"infos_{split}_{nsweeps:02d}sweeps_filter_zero_gt.pkl")
    with open(out, "wb") as f:
        pickle.dump(infos, f)
    return out
