"""The ground-truth database that GT-AUG samples from.

The port's own copy of `pillarnet_lts_tpu/datasets/utils/create_gt_database.py`:
the train split through the loading pipeline (points and annotations),
each object's points cut out with `points_in_rbbox`, moved to its box
centre and written as one `.bin` of f32 rows of the first
`point_features` columns (`{token}_{name}_{i}.bin` under `db_path`), and a
dbinfos pkl {class name: [info]} with the keys `name`, `path` (relative
to the data root), `image_idx`, `gt_idx`, `box3d_lidar`,
`num_points_in_gt`, `difficulty` (0) and `group_id` (one a box, counted
over the run).

The defaults are the JAX package's: `gt_database_{n}sweeps[_withvelo]`
and `dbinfos_train_{n}sweeps[_withvelo].pkl` (`_withvelo` for nuScenes
only; the Waymo configs read `dbinfos_train_1sweeps_withvelo.pkl`, so
pass `dbinfo_path` for them). As in the JAX package the dataset is built
in train mode, so a nuScenes set goes through its class-balanced
resampling over `used_classes`; its draws come from the dataset's seed 0.
"""

import pickle
from pathlib import Path

import numpy as np

from ...core.bbox import box_np_ops
from ..builder import build_dataset


def create_groundtruth_database(dataset_class_name, data_path,
                                info_path=None, used_classes=None,
                                db_path=None, dbinfo_path=None,
                                relative_path=True, nsweeps=None, **kwargs):
    """Write the database of `dataset_class_name` ("NuScenesDataset" or
    "WaymoDataset") over the infos at `info_path` under `data_path`;
    returns the dbinfos dict."""
    pipeline = [
        dict(type="LoadPointCloudFromFile", dataset=dataset_class_name),
        dict(type="LoadPointCloudAnnotations", with_bbox=True),
    ]
    if dataset_class_name == "NuScenesDataset":
        nsweeps = nsweeps or 10
        point_features = 5
        suffix = f"_{nsweeps}sweeps_withvelo"
    elif dataset_class_name == "WaymoDataset":
        nsweeps = nsweeps or 1
        point_features = 5 if nsweeps == 1 else 6
        suffix = f"_{nsweeps}sweeps"
    else:
        raise NotImplementedError(dataset_class_name)

    dataset = build_dataset(dict(
        type=dataset_class_name, root_path=data_path, info_path=info_path,
        pipeline=pipeline, test_mode=False, nsweeps=nsweeps,
        class_names=used_classes or [], sample=False))

    root_path = Path(data_path)
    db_path = Path(db_path) if db_path else root_path / f"gt_database{suffix}"
    dbinfo_path = (Path(dbinfo_path) if dbinfo_path
                   else root_path / f"dbinfos_train{suffix}.pkl")
    db_path.mkdir(parents=True, exist_ok=True)

    all_db_infos = {}
    group_counter = 0
    for index in range(len(dataset)):
        res = dataset.get_sensor_data(index)
        lidar = res.get("lidar")
        if lidar is None or lidar["annotations"] is None:
            continue
        points = lidar.get("combined", lidar["points"])
        annos = lidar["annotations"]
        image_idx = res["metadata"]["token"]
        gt_boxes = annos["boxes"]
        names = np.asarray(annos["names"])
        if gt_boxes.shape[0] == 0:
            continue

        point_indices = box_np_ops.points_in_rbbox(points, gt_boxes)
        for i in range(gt_boxes.shape[0]):
            if used_classes is not None and names[i] not in used_classes:
                continue
            filename = f"{image_idx}_{names[i]}_{i}.bin"
            filepath = db_path / filename
            gt_points = points[point_indices[:, i]].copy()
            gt_points[:, :3] -= gt_boxes[i, :3]
            gt_points[:, :point_features].astype(np.float32).tofile(filepath)
            all_db_infos.setdefault(names[i], []).append({
                "name": names[i],
                "path": (db_path.stem + "/" + filename if relative_path
                         else str(filepath)),
                "image_idx": image_idx,
                "gt_idx": i,
                "box3d_lidar": gt_boxes[i],
                "num_points_in_gt": gt_points.shape[0],
                "difficulty": 0,
                "group_id": group_counter,
            })
            group_counter += 1
        if index % 100 == 0:
            print(f"gt database: {index}/{len(dataset)}")

    for k, v in all_db_infos.items():
        print(f"load {len(v)} {k} database infos")
    with open(dbinfo_path, "wb") as f:
        pickle.dump(all_db_infos, f)
    return all_db_infos
