"""Dataset preparation CLI of the port (the JAX package's
`tools/create_data.py`).

    python -m pillarnet_lts_torch.tools.create_data nuscenes_data_prep \\
        --root_path data/nuScenes [--version v1.0-trainval] [--nsweeps 10]
    python -m pillarnet_lts_torch.tools.create_data waymo_data_prep \\
        --root_path data/Waymo [--split train] [--nsweeps 1]

On a first run it writes the split's info pkl (nuScenes: with the
nuscenes-devkit, `create_nuscenes_infos`; Waymo: from the per-frame pkls
that `datasets/waymo/waymo_converter.py` extracts with the
waymo-open-dataset devkit, `create_waymo_infos`, which needs no devkit),
then the GT-AUG database of the training split
(`create_groundtruth_database`). The file names are the JAX package's:
the Waymo database's dbinfos is `dbinfos_train_1sweeps.pkl`, which the
Waymo configs do not read (they read `..._withvelo.pkl`); point their
`db_info_path` at it. Each command prints its seconds and the host
library its box tests ran on (`native`; None: the numpy route).
"""

import argparse
import os
import time

from .. import native
from ..datasets.utils.create_gt_database import create_groundtruth_database

WAYMO_CLASSES = ["VEHICLE", "PEDESTRIAN", "CYCLIST"]


def nuscenes_data_prep(root_path, version="v1.0-trainval", nsweeps=10,
                       filter_zero=True):
    # the infos of the split that was asked for: infos_test_* for
    # v1.0-test, infos_train_* / infos_val_* otherwise
    if version == "v1.0-test":
        info_path = os.path.join(
            root_path, f"infos_test_{nsweeps:02d}sweeps_withvelo.pkl")
    else:
        info_path = os.path.join(
            root_path,
            f"infos_train_{nsweeps:02d}sweeps_withvelo_filter_{filter_zero}"
            ".pkl")
    if not os.path.exists(info_path):
        from ..datasets.nuscenes.nusc_common import create_nuscenes_infos

        create_nuscenes_infos(root_path, version=version, nsweeps=nsweeps,
                              filter_zero=filter_zero)
    if version == "v1.0-test":
        return  # no GT database for the test split
    create_groundtruth_database("NuScenesDataset", root_path, info_path,
                                nsweeps=nsweeps)


def waymo_data_prep(root_path, split="train", nsweeps=1):
    info_path = os.path.join(
        root_path, f"infos_{split}_{nsweeps:02d}sweeps_filter_zero_gt.pkl")
    if not os.path.exists(info_path):
        from ..datasets.waymo.waymo_infos import create_waymo_infos

        create_waymo_infos(root_path, split=split, nsweeps=nsweeps)
    if split != "train":
        return  # GT-AUG's database augments training only
    create_groundtruth_database("WaymoDataset", root_path, info_path,
                                nsweeps=nsweeps, used_classes=WAYMO_CLASSES)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Prepare a dataset")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("nuscenes_data_prep")
    p1.add_argument("--root_path", required=True)
    p1.add_argument("--version", default="v1.0-trainval")
    p1.add_argument("--nsweeps", type=int, default=10)

    p2 = sub.add_parser("waymo_data_prep")
    p2.add_argument("--root_path", required=True)
    p2.add_argument("--split", default="train")
    p2.add_argument("--nsweeps", type=int, default=1)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    start = time.perf_counter()
    if args.cmd == "nuscenes_data_prep":
        nuscenes_data_prep(args.root_path, args.version, args.nsweeps)
    else:
        waymo_data_prep(args.root_path, args.split, args.nsweeps)
    seconds = time.perf_counter() - start
    print(f"{args.cmd}: {seconds:.3f} s, host library: "
          f"{native.library_path() if native.available() else None}")


if __name__ == "__main__":
    main()
