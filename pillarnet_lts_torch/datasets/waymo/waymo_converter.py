"""Waymo Open Dataset tfrecords -> the per-frame pkls `waymo_infos` reads.

The port's own copy of `pillarnet_lts_tpu/datasets/waymo/waymo_converter.py`
(det3d's `waymo_converter.py:25-71` and `waymo_decoder.py:22-200`): each
tfrecord frame becomes a lidar pkl (the range images' points of every
return, with intensity and elongation) and an anno pkl (the
vehicle-to-global pose and the labelled boxes, their velocities in the
vehicle frame), named `seq_{record}_frame_{frame}.pkl` under
`{root}/lidar` and `{root}/annos`. tensorflow, `waymo_open_dataset` and
`pyquaternion` are imported inside the functions that use them, so the
module imports without them; without them a conversion raises
ImportError.

    python -m pillarnet_lts_torch.datasets.waymo.waymo_converter \\
        --root_path data/Waymo/train --record_path 'tfrecords/*.tfrecord'
"""

import argparse
import glob
import multiprocessing
import os
import pickle

import numpy as np


def _frame_name(frame):
    return "{scene_name}_{location}_{time_of_day}_{timestamp}".format(
        scene_name=frame.context.name,
        location=frame.context.stats.location,
        time_of_day=frame.context.stats.time_of_day,
        timestamp=frame.timestamp_micros,
    )


def decode_frame(frame, frame_id):
    """The lidar pkl of a frame (`waymo_decoder.py:22-42`)."""
    from waymo_open_dataset.utils import range_image_utils  # noqa: F401

    points_xyz, points_feature = extract_points(
        frame.lasers, frame.context.laser_calibrations, frame.pose)
    return {
        "scene_name": frame.context.name,
        "frame_name": _frame_name(frame),
        "frame_id": frame_id,
        "lidars": {
            "points_xyz": points_xyz,
            "points_feature": points_feature,
        },
    }


def decode_annos(frame, frame_id):
    """The anno pkl of a frame (`waymo_decoder.py:45-68`)."""
    from pyquaternion import Quaternion  # noqa: F401

    veh_to_global = np.array(frame.pose.transform).reshape(4, 4)
    ref_pose = np.reshape(np.array(frame.pose.transform), [4, 4])
    global_from_ref_rotation = ref_pose[:3, :3]
    objects = extract_objects(frame.laser_labels, global_from_ref_rotation)
    return {
        "scene_name": frame.context.name,
        "frame_name": _frame_name(frame),
        "frame_id": frame_id,
        "veh_to_global": veh_to_global,
        "objects": objects,
    }


def extract_points(lasers, laser_calibrations, frame_pose):
    """Range images -> cartesian points (n, 3) and (intensity, elongation)
    (n, 2), f32 (`waymo_decoder.py:71-155`)."""
    import tensorflow as tf  # noqa: F401
    from waymo_open_dataset import dataset_pb2
    from waymo_open_dataset.utils import frame_utils

    frame = dataset_pb2.Frame()
    frame.pose.CopyFrom(frame_pose)
    for laser in lasers:
        frame.lasers.append(laser)
    for calib in laser_calibrations:
        frame.context.laser_calibrations.append(calib)

    (range_images, camera_projections, _, range_image_top_pose) = (
        frame_utils.parse_range_image_and_camera_projection(frame))
    points, _ = frame_utils.convert_range_image_to_point_cloud(
        frame, range_images, camera_projections, range_image_top_pose,
        keep_polar_features=True)
    points_all = np.concatenate(points, axis=0)
    # keep_polar_features rows: (range, intensity, elongation, x, y, z)
    points_xyz = points_all[:, 3:6].astype(np.float32)
    points_feature = points_all[:, 1:3].astype(np.float32)
    return points_xyz, points_feature


def global_vel_to_ref(vel, global_from_ref_rotation):
    """A global (vx, vy) in the vehicle frame (`waymo_decoder.py:156`)."""
    vel = [vel[0], vel[1], 0.0]
    vel = np.dot(np.linalg.inv(global_from_ref_rotation), vel)
    return [vel[0], vel[1]]


def extract_objects(laser_labels, global_from_ref_rotation):
    """The labelled boxes of a frame (`waymo_decoder.py:164-200`)."""
    from waymo_open_dataset import label_pb2  # noqa: F401

    objects = []
    for object_id, label in enumerate(laser_labels):
        box = label.box
        speed = global_vel_to_ref(
            [label.metadata.speed_x, label.metadata.speed_y],
            global_from_ref_rotation)
        objects.append({
            "id": object_id,
            "name": label.id,
            "label": label.type,
            "box": np.array([box.center_x, box.center_y, box.center_z,
                             box.length, box.width, box.height,
                             speed[0], speed[1], box.heading],
                            dtype=np.float32),
            "num_points": label.num_lidar_points_in_box,
            "detection_difficulty_level": label.detection_difficulty_level,
            "combined_difficulty_level": label.detection_difficulty_level,
        })
    return objects


def convert_one(args):
    """Every frame of one tfrecord -> its lidar and anno pkls."""
    idx, fname, lidar_path, anno_path = args
    import tensorflow as tf
    from waymo_open_dataset import dataset_pb2

    dataset = tf.data.TFRecordDataset(fname, compression_type="")
    for frame_id, data in enumerate(dataset):
        frame = dataset_pb2.Frame()
        frame.ParseFromString(bytearray(data.numpy()))
        decoded_frame = decode_frame(frame, frame_id)
        decoded_annos = decode_annos(frame, frame_id)
        name = f"seq_{idx}_frame_{frame_id}.pkl"
        with open(os.path.join(lidar_path, name), "wb") as f:
            pickle.dump(decoded_frame, f)
        with open(os.path.join(anno_path, name), "wb") as f:
            pickle.dump(decoded_annos, f)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Waymo Data Converter")
    parser.add_argument("--root_path", type=str, required=True)
    parser.add_argument("--record_path", type=str, required=True)
    parser.add_argument("--workers", type=int, default=16)
    args = parser.parse_args(argv)

    lidar_path = os.path.join(args.root_path, "lidar")
    anno_path = os.path.join(args.root_path, "annos")
    os.makedirs(lidar_path, exist_ok=True)
    os.makedirs(anno_path, exist_ok=True)

    fnames = sorted(glob.glob(args.record_path))
    print(f"Number of files {len(fnames)}")
    work = [(i, f, lidar_path, anno_path) for i, f in enumerate(fnames)]
    with multiprocessing.get_context("spawn").Pool(args.workers) as p:
        p.map(convert_one, work)


if __name__ == "__main__":
    main()
