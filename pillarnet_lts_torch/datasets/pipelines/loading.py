"""Point-cloud and annotation loading (host numpy).

The port's copy of `pillarnet_lts_tpu/datasets/pipelines/loading.py`:
nuScenes keyframe + (nsweeps - 1) sweeps moved into the keyframe by their
stored 4 x 4 matrices, with a per-point time-lag channel; Waymo per-frame
pkl objects with tanh-normalized intensity. One change: the nuScenes sweep
order is drawn from the sample's own generator (`res["rng"]`, a
`np.random.RandomState` that the dataset makes per sample), where the JAX
package draws from numpy's global state; the same seed gives the same
draws. The order matters: `collate_batch` truncates a cloud at
`max_points`, and another order drops other points.
"""

import os
import pickle
from pathlib import Path

import numpy as np

from ..registry import PIPELINES


def read_file(path, num_point_feature=4, virtual=False):
    """(N, num_point_feature) f32 of a nuScenes `.bin` (5 f32 per point);
    `virtual` appends the MVP virtual points of `<dir>_VIRTUAL/`."""
    points = np.fromfile(path, dtype=np.float32).reshape(-1, 5)[
        :, :num_point_feature]
    if not virtual:
        return points
    tokens = path.split("/")
    seg_path = os.path.join(*tokens[:-2], tokens[-2] + "_VIRTUAL",
                            tokens[-1] + ".pkl.npy")
    data_dict = np.load(seg_path, allow_pickle=True).item()
    virtual_points1 = data_dict["real_points"][
        :, [0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14]]
    virtual_points2 = data_dict["virtual_points"]
    points = np.concatenate(
        [points, np.ones([points.shape[0], 15 - num_point_feature])], axis=1)
    virtual_points1 = np.concatenate(
        [virtual_points1, np.zeros([virtual_points1.shape[0], 1])], axis=1)
    virtual_points2 = np.concatenate(
        [virtual_points2, -1 * np.ones([virtual_points2.shape[0], 1])],
        axis=1)
    return np.concatenate([points, virtual_points1, virtual_points2],
                          axis=0).astype(np.float32)


def remove_close(points, radius):
    """Drop points within `radius` of the ego origin in x and y; points
    (C, N), column layout."""
    x_filt = np.abs(points[0, :]) < radius
    y_filt = np.abs(points[1, :]) < radius
    not_close = np.logical_not(np.logical_and(x_filt, y_filt))
    return points[:, not_close]


def read_sweep(sweep, virtual=False):
    """A nuScenes sweep in the keyframe's frame: (points (N, 4), time lags
    (N, 1))."""
    min_distance = 1.0
    points_sweep = read_file(str(sweep["lidar_path"]), virtual=virtual).T
    points_sweep = remove_close(points_sweep, min_distance)
    nbr_points = points_sweep.shape[1]
    if sweep["transform_matrix"] is not None:
        points_sweep[:3, :] = sweep["transform_matrix"].dot(
            np.vstack((points_sweep[:3, :], np.ones(nbr_points))))[:3, :]
    curr_times = sweep["time_lag"] * np.ones((1, points_sweep.shape[1]))
    return points_sweep.T, curr_times.T


def get_obj(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def read_single_waymo(obj):
    points_xyz = obj["lidars"]["points_xyz"]
    points_feature = obj["lidars"]["points_feature"]
    points_feature[:, 0] = np.tanh(points_feature[:, 0])
    return np.concatenate([points_xyz, points_feature], axis=-1)


def read_single_waymo_sweep(sweep):
    obj = get_obj(sweep["path"])
    points_sweep = read_single_waymo(obj).T
    nbr_points = points_sweep.shape[1]
    if sweep["transform_matrix"] is not None:
        points_sweep[:3, :] = sweep["transform_matrix"].dot(
            np.vstack((points_sweep[:3, :], np.ones(nbr_points))))[:3, :]
    curr_times = sweep["time_lag"] * np.ones((1, points_sweep.shape[1]))
    return points_sweep.T, curr_times.T


def _with_times(res, points_list, times_list):
    points = np.concatenate(points_list, axis=0)
    times = np.concatenate(times_list, axis=0).astype(points.dtype)
    res["lidar"]["points"] = points
    res["lidar"]["times"] = times
    res["lidar"]["combined"] = np.hstack([points, times])


@PIPELINES.register_module
class LoadPointCloudFromFile:
    def __init__(self, dataset="NuScenesDataset", **kwargs):
        self.type = dataset

    def __call__(self, res, info):
        res["type"] = self.type
        if self.type == "NuScenesDataset":
            nsweeps = res["lidar"]["nsweeps"]
            virtual = res.get("virtual", False)
            points = read_file(str(Path(info["lidar_path"])),
                               virtual=virtual)
            points_list = [points]
            times_list = [np.zeros((points.shape[0], 1))]
            if nsweeps - 1 != len(info["sweeps"]):
                raise ValueError(f"nsweeps {nsweeps} should equal the "
                                 f"sweep list's length + 1 "
                                 f"({len(info['sweeps'])} + 1)")
            for i in res["rng"].choice(len(info["sweeps"]), nsweeps - 1,
                                       replace=False):
                points_sweep, times_sweep = read_sweep(info["sweeps"][i],
                                                       virtual=virtual)
                points_list.append(points_sweep)
                times_list.append(times_sweep)
            _with_times(res, points_list, times_list)
        elif self.type == "WaymoDataset":
            nsweeps = res["lidar"]["nsweeps"]
            points = read_single_waymo(get_obj(info["path"]))
            res["lidar"]["points"] = points
            if nsweeps > 1:
                if nsweeps - 1 != len(info["sweeps"]):
                    raise ValueError(f"nsweeps {nsweeps} should equal the "
                                     f"sweep list's length + 1")
                points_list = [points]
                times_list = [np.zeros((points.shape[0], 1))]
                for i in range(nsweeps - 1):
                    points_sweep, times_sweep = read_single_waymo_sweep(
                        info["sweeps"][i])
                    points_list.append(points_sweep)
                    times_list.append(times_sweep)
                _with_times(res, points_list, times_list)
        elif self.type != "DemoDataset":  # the demo makes its own points
            raise NotImplementedError(f"dataset type {self.type!r}")
        return res, info


@PIPELINES.register_module
class LoadPointCloudAnnotations:
    def __init__(self, with_bbox=True, **kwargs):
        pass

    def __call__(self, res, info):
        if res["type"] in ("NuScenesDataset", "DemoDataset") \
                and "gt_boxes" in info:
            gt_boxes = info["gt_boxes"].astype(np.float32)
            gt_boxes[np.isnan(gt_boxes)] = 0
            res["lidar"]["annotations"] = {
                "boxes": gt_boxes,
                "names": info["gt_names"],
                "tokens": info.get("gt_boxes_token"),
                "velocities": info.get("gt_boxes_velocity"),
            }
        elif res["type"] == "WaymoDataset" and "gt_boxes" in info:
            res["lidar"]["annotations"] = {
                "boxes": info["gt_boxes"].astype(np.float32),
                "names": info["gt_names"],
            }
        return res, info
