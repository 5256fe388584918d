"""PyTorch port, the data path of evaluation: the on-disk nuScenes and
Waymo datasets and the demo set, their pipelines, the threaded loader and
the double-flip groups, against the JAX package on the same files.

The sets are written to `tmp_path` in the real on-disk layout
(`datasets/synth.py::write_nuscenes_set` / `write_waymo_set`): a few frames
of a few thousand points, 3 nuScenes sweeps. Tolerance: none. Samples
(points, targets, metadata), the CBGS lists and the loaders' batch orders
equal the JAX package's bit for bit. The JAX package draws the sweep
order and the CBGS resampling from numpy's global state, the port from
generators it owns (`PointCloudDataset.sample_rng(idx)` =
`RandomState([seed, idx])` for the sweeps and the train-mode point
shuffle, CBGS from `RandomState(seed)`); the JAX side is seeded the same
way before each draw.
"""

import copy
import os
import pickle
import threading

import numpy as np
import pytest

from pillarnet_lts_tpu.datasets.demo import DemoDataset as JDemo
from pillarnet_lts_tpu.datasets.loader.build_loader import (
    DataLoader as JDataLoader)
from pillarnet_lts_tpu.datasets.nuscenes.nuscenes import (
    NuScenesDataset as JNuScenes)
from pillarnet_lts_tpu.datasets.pipelines.formating import (
    Reformat as JReformat)
from pillarnet_lts_tpu.datasets.pipelines.test_aug import (
    DoubleFlip as JDoubleFlip)
from pillarnet_lts_tpu.datasets.waymo.waymo import WaymoDataset as JWaymo
from pillarnet_lts_tpu.parallel.collate import collate_batch as jcollate
from pillarnet_lts_torch.apis import load_config
from pillarnet_lts_torch.datasets import (DataLoader, DemoDataset,
                                          NuScenesDataset, WaymoDataset,
                                          build_dataset, collate_batch)
from pillarnet_lts_torch.datasets.nuscenes.nuscenes import cbgs_resample
from pillarnet_lts_torch.datasets.pipelines import DoubleFlip, Reformat
from pillarnet_lts_torch.datasets.synth import (_ego_motion,
                                                write_nuscenes_set,
                                                write_waymo_set)
import test_torch_port_threads  # noqa: F401  (one torch thread)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NUSC = load_config(os.path.join(ROOT, "configs/pillarnet/pillarnet34_nusc.py"))
WAYMO = load_config(os.path.join(ROOT,
                                 "configs/pillarnet/pillarnet34_waymo.py"))
DEMO = load_config(os.path.join(ROOT, "configs/demo/pillarnet18_demo.py"))
SEED = 5
N_FRAMES, N_POINTS, N_SWEEPS = 6, 3000, 3


@pytest.fixture(scope="module")
def nusc_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    return root, write_nuscenes_set(root, N_FRAMES, N_POINTS, N_SWEEPS,
                                    NUSC["class_names"],
                                    NUSC["point_cloud_range"], seed=3)


@pytest.fixture(scope="module")
def waymo_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("waymo"))
    return root, write_waymo_set(root, 4, N_POINTS, WAYMO["class_names"],
                                 WAYMO["point_cloud_range"], seed=7)


def train_pipeline(cfg):
    """The config's train pipeline without augmentation or GT-AUG (what
    the port runs); the points shuffled as the config says."""
    pre = dict(cfg["train_preprocessor"], no_augmentation=True,
               db_sampler=None)
    return [st if st["type"] != "Preprocess" else dict(st, cfg=pre)
            for st in cfg["train_pipeline"]]


def split_cfg(cfg, root, info, test_mode, **kw):
    split = cfg["data"]["val" if test_mode else "train"]
    out = dict(split, root_path=root, info_path=info, test_mode=test_mode,
               pipeline=(cfg["test_pipeline"] if test_mode
                         else train_pipeline(cfg)), **kw)
    out.pop("type")
    return out


def assert_same_sample(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, list):
            assert len(got[k]) == len(v), k
            for g, w in zip(got[k], v):
                np.testing.assert_array_equal(g, w, err_msg=k)
        elif isinstance(v, dict):
            assert got[k] == v, k
        else:
            assert got[k].dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def jax_sample(ds, seed, idx):
    """JAX sample idx with numpy's global state seeded as the port seeds
    the sample's generator."""
    np.random.seed([seed, idx])
    return ds[idx]


@pytest.mark.parametrize("test_mode", [True, False], ids=["val", "train"])
def test_nuscenes_samples_equal_jax(nusc_set, test_mode):
    root, info = nusc_set
    cfg = split_cfg(NUSC, root, info, test_mode, nsweeps=N_SWEEPS)
    np.random.seed(SEED)  # the JAX package's CBGS draws
    want_ds = JNuScenes(**copy.deepcopy(cfg))
    got_ds = NuScenesDataset(**copy.deepcopy(cfg), seed=SEED)
    assert ([i["token"] for i in got_ds._nusc_infos]
            == [i["token"] for i in want_ds._nusc_infos])
    if not test_mode:  # CBGS duplicated some frames
        assert len(got_ds) > N_FRAMES
    for idx in range(len(got_ds)):
        got = got_ds[idx]
        assert_same_sample(got, jax_sample(want_ds, SEED, idx))
    assert got["points"].shape[1] == 5  # x, y, z, intensity, time lag


@pytest.mark.parametrize("test_mode,nsweeps", [
    (True, 1), (False, 1), (True, 2)], ids=["val", "train", "val-2sweeps"])
def test_waymo_samples_equal_jax(waymo_set, tmp_path, test_mode, nsweeps):
    root, info = waymo_set
    if nsweeps > 1:  # each frame's previous frame as its sweep
        with open(info, "rb") as f:
            infos = pickle.load(f)
        for k, i in enumerate(infos):
            i["sweeps"] = [{"path": infos[k - 1]["path"],
                            "transform_matrix": _ego_motion(1),
                            "time_lag": 0.1}]
        info = str(tmp_path / "infos_2sweeps.pkl")
        with open(info, "wb") as f:
            pickle.dump(infos, f)
    cfg = split_cfg(WAYMO, root, info, test_mode, nsweeps=nsweeps,
                    sample=not test_mode)
    np.random.seed(SEED)
    want_ds = JWaymo(**copy.deepcopy(cfg))
    got_ds = WaymoDataset(**copy.deepcopy(cfg), seed=SEED)
    assert ([i["token"] for i in got_ds._waymo_infos]
            == [i["token"] for i in want_ds._waymo_infos])
    for idx in range(len(got_ds)):
        got = got_ds[idx]
        assert_same_sample(got, jax_sample(want_ds, SEED, idx))
    assert got["points"].shape[1] == 5 + (nsweeps > 1)


def test_waymo_set_class_counts(tmp_path):
    """`write_waymo_set(class_counts=)`: every frame holds that many GT
    boxes of each class, and its val samples equal the JAX package's."""
    root = str(tmp_path)
    info = write_waymo_set(root, 2, N_POINTS, WAYMO["class_names"],
                           WAYMO["point_cloud_range"], seed=8,
                           class_counts=(5, 3, 1))
    with open(info, "rb") as f:
        infos = pickle.load(f)
    for i in infos:
        names, counts = np.unique(i["gt_names"], return_counts=True)
        assert dict(zip(names, counts)) == {"VEHICLE": 5, "PEDESTRIAN": 3,
                                            "CYCLIST": 1}
        assert len(i["gt_boxes"]) == 9
    cfg = split_cfg(WAYMO, root, info, True, nsweeps=1, sample=False)
    want_ds = JWaymo(**copy.deepcopy(cfg))
    got_ds = WaymoDataset(**copy.deepcopy(cfg), seed=SEED)
    for idx in range(len(got_ds)):
        assert_same_sample(got_ds[idx], jax_sample(want_ds, SEED, idx))


def test_waymo_set_class_counts_per_frame(tmp_path):
    """`write_waymo_set(class_counts=)` with one row per frame: frame i
    holds row i's boxes of each class, absent classes included; a row
    equal to a single `class_counts` writes the same frame."""
    rows = [(4, 2, 0), (30, 14, 2), (5, 3, 1)]
    args = (3, N_POINTS, WAYMO["class_names"], WAYMO["point_cloud_range"])
    info = write_waymo_set(str(tmp_path / "rows"), *args, seed=8,
                           class_counts=rows)
    same = write_waymo_set(str(tmp_path / "one"), *args, seed=8,
                           class_counts=(5, 3, 1))
    with open(info, "rb") as f:
        infos = pickle.load(f)
    with open(same, "rb") as f:
        want = pickle.load(f)[2]
    for i, row in zip(infos, rows):
        got = {n: int((i["gt_names"] == n).sum())
               for n in ("VEHICLE", "PEDESTRIAN", "CYCLIST")}
        assert tuple(got.values()) == row
        assert len(i["gt_boxes"]) == sum(row)
    for k in ("gt_boxes", "gt_names"):
        np.testing.assert_array_equal(infos[2][k], want[k])


@pytest.mark.parametrize("test_mode", [True, False], ids=["val", "train"])
def test_demo_samples_equal_jax(test_mode):
    split = dict(DEMO["data"]["val" if test_mode else "train"], seed=4,
                 num_points=2048)
    if not test_mode:
        split["pipeline"] = train_pipeline(DEMO)
    split.pop("type")
    want_ds = JDemo(**copy.deepcopy(split))
    got_ds = build_dataset(dict(copy.deepcopy(split), type="DemoDataset"))
    assert isinstance(got_ds, DemoDataset)
    for idx in range(len(got_ds)):
        assert_same_sample(got_ds[idx], jax_sample(want_ds, 0, idx))


def test_sweep_and_cbgs_draws_equal_numpy_global(nusc_set):
    """The sweep order (a permutation when every sweep is taken) and the
    CBGS draws from the port's generators equal numpy's global draws
    under the same seed."""
    root, info = nusc_set
    ds = NuScenesDataset(**split_cfg(NUSC, root, info, True,
                                     nsweeps=N_SWEEPS))
    for seed in (0, 1, 12345):
        ds.set_seed(seed)
        for idx in (0, 1, 7):
            got = ds.sample_rng(idx).choice(9, 9, replace=False)
            np.random.seed([seed, idx])
            want = np.random.choice(9, 9, replace=False)
            np.testing.assert_array_equal(got, want)
            assert sorted(got) == list(range(9))
    with open(info, "rb") as f:
        infos = pickle.load(f)
    for seed in (0, 3):
        got = cbgs_resample(infos, NUSC["class_names"],
                            np.random.RandomState(seed))
        np.random.seed(seed)
        want = JNuScenes(info_path=info, root_path=root, nsweeps=N_SWEEPS,
                         class_names=NUSC["class_names"],
                         pipeline=[])._nusc_infos
        assert [i["token"] for i in got] == [i["token"] for i in want]


class _Toy:
    def __init__(self, n=10, poison=None):
        self.n, self.poison = n, poison

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.poison:
            raise ValueError(f"corrupt sample {i}")
        return {"points": np.full((4, 5), float(i), np.float32),
                "metadata": {"token": str(i)}}


def tokens(batches):
    return [[m["token"] for m in b["metadata"]] for b in batches]


@pytest.mark.parametrize("shuffle,drop_last,bs", [
    (False, False, 4), (True, False, 4), (True, True, 3), (False, True, 1)])
def test_loader_batches_equal_jax_order(shuffle, drop_last, bs):
    for epoch in (0, 2):
        kw = dict(batch_size=bs, shuffle=shuffle, max_points=8, seed=1,
                  drop_last=drop_last)
        got = DataLoader(_Toy(10), num_workers=3, **kw)
        want = JDataLoader(_Toy(10), num_workers=1, **kw)  # in order
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        g, w = list(got), list(want)
        assert len(g) == len(got) == len(want)
        assert tokens(g) == tokens(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a["points"], b["points"])
            np.testing.assert_array_equal(a["points_mask"], b["points_mask"])
    if not drop_last:
        assert sorted(t for b in tokens(g) for t in b) == sorted(
            str(i) for i in range(10))


def test_loader_training_order_unchanged():
    """The trainer's loader (shuffle, drop_last, seed 0): the order of
    the synchronous loader it replaced, `RandomState(epoch)` over the
    indices, the last short batch dropped."""
    loader = DataLoader(_Toy(11), 4, shuffle=True, num_workers=2,
                        max_points=8)
    for epoch in range(3):
        loader.set_epoch(epoch)
        idx = np.arange(11)
        np.random.RandomState(epoch).shuffle(idx)
        want = [[str(i) for i in idx[b * 4:(b + 1) * 4]] for b in range(2)]
        assert tokens(loader) == want


def test_loader_worker_failure_raises():
    loader = DataLoader(_Toy(16, poison=5), 4, num_workers=2, max_points=8)
    with pytest.raises(RuntimeError, match="worker failed") as exc:
        list(loader)
    assert "corrupt sample 5" in str(exc.value.__cause__)


def test_loader_shards_and_abandoned_pass():
    shards = [DataLoader(_Toy(10), 1, num_workers=1, max_points=8,
                         num_shards=4, shard_index=i) for i in range(4)]
    assert [len(s) for s in shards] == [3, 3, 3, 3]  # wrap-around padding
    before = threading.active_count()
    loader = DataLoader(_Toy(40), 2, num_workers=3, max_points=8)
    it = iter(loader)
    next(it)
    it.close()  # a consumer that stops early leaves no thread behind
    assert threading.active_count() == before


def test_loader_seeds_the_dataset_per_epoch(nusc_set):
    root, info = nusc_set
    ds = NuScenesDataset(**split_cfg(NUSC, root, info, True,
                                     nsweeps=N_SWEEPS))
    loader = DataLoader(ds, 2, num_workers=2, max_points=20000, seed=9,
                        drop_last=False)
    loader.set_epoch(1)
    first = list(loader)
    assert ds.seed == 10
    again = list(loader)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a["points"], b["points"])


def test_double_flip_groups_equal_jax():
    pts = np.random.RandomState(0).randn(100, 5).astype(np.float32)
    bundles = []
    for flip, fmt in ((DoubleFlip(), Reformat(double_flip=True)),
                      (JDoubleFlip(), JReformat(double_flip=True))):
        res = {"mode": "val", "metadata": {"token": "t0"},
               "lidar": {"points": pts.copy()}}
        res, _ = flip(res, {})
        bundles.append(fmt(res, {})[0])
    got, want = bundles
    assert isinstance(got, list) and len(got) == 4
    for g, w in zip(got, want):
        assert g["metadata"] == w["metadata"]
        np.testing.assert_array_equal(g["points"], w["points"])
    np.testing.assert_array_equal(got[3]["points"][:, :2], -pts[:, :2])
    other = [dict(b, metadata={"token": "t1"}) for b in got]
    gb = collate_batch([got, other], max_points=128)
    wb = jcollate([want, other], max_points=128)
    for k in ("points", "points_mask"):
        np.testing.assert_array_equal(gb[k], wb[k])
    assert gb["points"].shape[0] == 8
    assert gb["metadata"] == wb["metadata"]
    assert [m["token"] for m in gb["metadata"][::4]] == ["t0", "t1"]
