"""PyTorch port, dataset preparation: `tools/create_data.py`, the Waymo
infos, the devkit paths and the host C++ library (`native/`), against
the JAX package on the same inputs.

Inputs: raw Waymo frames in the converter's layout written by
`datasets/synth.py::write_waymo_raw` from seeded demo scenes (2
sequences, a frame without objects, objects without points, a moving
pose), and a stub nuScenes / pyquaternion / waymo-open-dataset that both
packages see through `sys.modules` for the length of one test (neither
devkit is installed, and no stub is installed into either package).

Tolerance: none. The info pkls, the GT database's `.bin` files and
dbinfos, and the devkit exports are equal byte for byte; the native
functions bit for bit, comparing the two packages' libraries in one
process (`-march=native` code equals only on one machine), and skipped
where a library did not build (as `tests/test_native.py` skips).
"""

import contextlib
import fcntl
import importlib
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest

import pillarnet_lts_tpu.native as jnative
from pillarnet_lts_tpu.core.bbox import box_np_ops as jops
from pillarnet_lts_tpu.core.target import center_target as jtarget
from pillarnet_lts_tpu.datasets.waymo import waymo_converter as jconv
from pillarnet_lts_tpu.datasets.waymo import waymo_infos as jinfos
import pillarnet_lts_torch.native as tnative
from pillarnet_lts_torch.apis import load_config
from pillarnet_lts_torch.core.bbox import box_np_ops as tops
from pillarnet_lts_torch.datasets.nuscenes import nusc_common as tnusc
from pillarnet_lts_torch.datasets.synth import write_waymo_raw
from pillarnet_lts_torch.datasets.waymo import waymo_common as tcommon
from pillarnet_lts_torch.datasets.waymo import waymo_converter as tconv
from pillarnet_lts_torch.datasets.waymo import waymo_infos as tinfos
from pillarnet_lts_torch.tools import create_data

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from tools import create_data as jcreate_data  # noqa: E402
import test_torch_port_threads  # noqa: F401, E402  (one torch thread)

PC_RANGE = [-75.2, -75.2, -2.0, 75.2, 75.2, 4.0]
POINTS = 3000
SEQUENCES, FRAMES = 2, 3  # 6 frames a split


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("waymo_raw"))
    for split, seed in (("train", 3), ("val", 4)):
        write_waymo_raw(root, split, SEQUENCES, FRAMES, POINTS, PC_RANGE,
                        seed=seed)
    return root


# one lock for every xdist worker, beside the port's git-ignored builds
NATIVE_LOCK = os.path.join(ROOT, "build", "pillarnet_lts_torch",
                           "jax_native.lock")


def jax_native_error():
    """Build the JAX package's host library (`make -C csrc`) under an
    exclusive lock that every test process takes, then let its module load
    the finished file: a process whose first load met a half-written file
    (or none) has `_TRIED` set and would give None for good. Returns None,
    or the compiler's failure. The module is not reloaded: other JAX
    modules hold its functions, which keep its old globals."""
    if jnative._LIB is not None:
        return None
    os.makedirs(os.path.dirname(NATIVE_LOCK), exist_ok=True)
    with open(NATIVE_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            run = subprocess.run(["make", "-C", os.path.join(ROOT, "csrc")],
                                 capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"make -C csrc: {e}"
        if run.returncode != 0:
            return (f"make -C csrc exited {run.returncode}: "
                    f"{run.stderr[-2000:]}")
        jnative._TRIED = False
        if jnative._load() is None:
            return "csrc/libpillar_pipeline.so built but did not load"
    return None


def need_natives():
    """Skip only where a compiler fails: the JAX package's library is built
    first (`jax_native_error`), the port's at its first use."""
    error = jax_native_error()
    if error is not None:
        pytest.skip(f"the compiler failed for the JAX package's host "
                    f"library: {error}")
    if not tnative.available():
        pytest.skip(f"the compiler failed for the port's host library: "
                    f"{tnative.build_error()}")


def read(path):
    with open(path, "rb") as f:
        return f.read()


def files(path):
    return {f: read(os.path.join(path, f)) for f in sorted(os.listdir(path))}


def assert_same(got, want, where="infos"):
    """Every key, every value: arrays with equal dtypes and values (NaN
    equal to NaN), lists item by item, the rest by ==."""
    assert type(got) is type(want), where
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert np.array_equal(got, want,
                              equal_nan=want.dtype.kind in "fc"), where
    else:
        assert got == want, where


# ---- Waymo infos -------------------------------------------------------------


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("nsweeps", [1, 2])
def test_create_waymo_infos_equals_jax(raw, split, nsweeps):
    """The info pkl of each split and sweep count: every key and value of
    every frame equal to the JAX package's, and the file byte for byte;
    the sweep chains' f64 transforms and time lags, the first frame of a
    sequence repeating itself, the box conversion, the `num_points > 0`
    filter."""
    want_path = jinfos.create_waymo_infos(raw, split=split, nsweeps=nsweeps)
    want_bytes = read(want_path)
    with open(want_path, "rb") as f:
        want = pickle.load(f)
    os.remove(want_path)
    got_path = tinfos.create_waymo_infos(raw, split=split, nsweeps=nsweeps)
    assert got_path == want_path
    assert read(got_path) == want_bytes
    with open(got_path, "rb") as f:
        got = pickle.load(f)
    os.remove(got_path)
    assert_same(got, want)
    assert len(got) == SEQUENCES * FRAMES
    assert [i["token"] for i in got] == [
        f"seq_{s}_frame_{k}.pkl" for s in range(SEQUENCES)
        for k in range(FRAMES)]
    assert any(len(i["gt_boxes"]) == 0 for i in got)  # seq 0, frame 1
    assert all(i["num_points_in_gt"].min() > 0 for i in got
               if len(i["gt_boxes"]))
    if nsweeps == 2:
        moved = [i["sweeps"][0] for i in got
                 if i["sweeps"][0]["transform_matrix"] is not None]
        assert len(moved) == SEQUENCES * (FRAMES - 1)
        assert all(s["transform_matrix"].dtype == np.float64
                   and not np.allclose(s["transform_matrix"], np.eye(4))
                   and s["time_lag"] > 0 for s in moved)


def test_sort_frame_is_the_jax_order():
    names = [f"seq_{s}_frame_{f}.pkl" for s in (10, 2, 0) for f in (11, 3, 0)]
    assert tinfos.sort_frame(names) == jinfos.sort_frame(names)
    pose = np.arange(16, dtype=np.float64).reshape(4, 4)
    pose[:3, :3] = np.linalg.qr(np.random.RandomState(0).rand(3, 3))[0]
    for g, w in zip(tinfos.veh_pos_to_transform(pose),
                    jinfos.veh_pos_to_transform(pose)):
        np.testing.assert_array_equal(g, w)


# ---- waymo_data_prep: infos, GT database, dbinfos -----------------------------


def _move_out(root, out):
    """Move what a preparation wrote under `root` (the info pkls, the
    database, the dbinfos) to `out`."""
    os.makedirs(out)
    for name in os.listdir(root):
        if name not in ("train", "val"):
            os.rename(os.path.join(root, name), os.path.join(out, name))


def _prep(prep, root, out):
    """Run `prep` for both splits under `root`, then move what it wrote to
    `out`."""
    for split in ("train", "val"):
        prep(root, split=split, nsweeps=1)
    _move_out(root, out)


@pytest.mark.parametrize("route", ["numpy", "native"])
def test_create_data_cli_reports_the_host_library(raw, tmp_path, capsys,
                                                  route):
    """The CLI prints its seconds and the host library its box tests ran
    on: the library's path natively, None on the numpy route."""
    if route == "native":
        need_natives()
    with (cs.numpy_route(tnative) if route == "numpy"
          else contextlib.nullcontext()):
        create_data.main(["waymo_data_prep", "--root_path", raw,
                          "--split", "train"])
    _move_out(raw, tmp_path / "out")
    said = capsys.readouterr().out.splitlines()[-1]
    assert said.startswith("waymo_data_prep: ")
    assert said.endswith("s, host library: " + (
        tnative.library_path() if route == "native" else "None"))


@pytest.mark.parametrize("route", ["numpy", "native"])
def test_waymo_data_prep_equals_jax(raw, tmp_path, route):
    """`waymo_data_prep` for train and val writes the JAX package's
    `tools/create_data.py` files byte for byte: both info pkls, every
    `gt_database_1sweeps/*.bin` and `dbinfos_train_1sweeps.pkl` (the
    classes VEHICLE, PEDESTRIAN, CYCLIST; signs and objects without points
    left out). Once on both packages' numpy route, once native against
    native."""
    if route == "native":
        need_natives()
    with (cs.numpy_route(jnative, tnative) if route == "numpy"
          else contextlib.nullcontext()):
        _prep(jcreate_data.waymo_data_prep, raw, tmp_path / "jax")
        _prep(create_data.waymo_data_prep, raw, tmp_path / "port")
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax")) == [
        "dbinfos_train_1sweeps.pkl", "gt_database_1sweeps",
        "infos_train_01sweeps_filter_zero_gt.pkl",
        "infos_val_01sweeps_filter_zero_gt.pkl"]
    for name in ("dbinfos_train_1sweeps.pkl",
                 "infos_train_01sweeps_filter_zero_gt.pkl",
                 "infos_val_01sweeps_filter_zero_gt.pkl"):
        assert read(tmp_path / "port" / name) == read(
            tmp_path / "jax" / name), name
    bins = files(tmp_path / "port" / "gt_database_1sweeps")
    assert bins == files(tmp_path / "jax" / "gt_database_1sweeps")
    with open(tmp_path / "port" / "dbinfos_train_1sweeps.pkl", "rb") as f:
        dbinfos = pickle.load(f)
    assert sorted(dbinfos) == ["CYCLIST", "PEDESTRIAN", "VEHICLE"]
    assert len(bins) == sum(len(v) for v in dbinfos.values()) > 0


def test_waymo_configs_read_a_name_create_data_does_not_write(raw, tmp_path):
    """The JAX package's name fault, kept: `waymo_data_prep` writes
    `dbinfos_train_1sweeps.pkl`, and every Waymo config with GT-AUG reads
    `dbinfos_train_1sweeps_withvelo.pkl`."""
    with cs.numpy_route(jnative, tnative):
        _prep(create_data.waymo_data_prep, raw, tmp_path / "out")
    written = set(os.listdir(tmp_path / "out"))
    assert "dbinfos_train_1sweeps.pkl" in written
    read_names = set()
    for dirpath, _, names in os.walk(os.path.join(ROOT, "configs")):
        for name in names:
            if "waymo" not in name or not name.endswith(".py"):
                continue
            cfg = load_config(os.path.join(dirpath, name))
            for step in cfg["data"]["train"].get("pipeline") or []:
                sampler = (step.get("cfg") or {}).get("db_sampler")
                if step["type"] == "Preprocess" and sampler:
                    read_names.add(os.path.basename(sampler["db_info_path"]))
    assert read_names == {"dbinfos_train_1sweeps_withvelo.pkl"}
    assert not read_names & written


# ---- the devkit paths --------------------------------------------------------


class Quaternion:
    """pyquaternion's surface that the info creation uses: (w, x, y, z)
    components or an axis and angle; `rotation_matrix`, `rotate`."""

    def __init__(self, q=None, axis=None, radians=None):
        if axis is not None:
            axis = np.asarray(axis, float) / np.linalg.norm(axis)
            q = [np.cos(radians / 2), *(np.sin(radians / 2) * axis)]
        self.q = np.asarray(q, float) / np.linalg.norm(q)

    @property
    def rotation_matrix(self):
        w, x, y, z = self.q
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])

    def rotate(self, v):
        return self.rotation_matrix @ np.asarray(v, float)


def transform_matrix(translation, rotation, inverse=False):
    """nuscenes.utils.geometry_utils.transform_matrix."""
    tm = np.eye(4)
    if inverse:
        rot_inv = rotation.rotation_matrix.T
        tm[:3, :3] = rot_inv
        tm[:3, 3] = rot_inv.dot(-np.array(translation))
    else:
        tm[:3, :3] = rotation.rotation_matrix
        tm[:3, 3] = np.array(translation)
    return tm


class NuScenes:
    """A two-scene nuScenes: 2 key frames a scene, sweeps between them
    (the first key frame of scene 0 has none, of scene 1 one), boxes of
    mapped, ignored and unmapped categories with velocities (one NaN),
    attributes (some none) and lidar / radar point counts (some zero)."""

    def __init__(self, version, dataroot, verbose=True):
        rng = np.random.RandomState(7)
        self.tables = {k: {} for k in ("sample", "sample_data", "ego_pose",
                                       "calibrated_sensor",
                                       "sample_annotation", "attribute")}
        self.scene, self.sample, self.boxes, self.velocity = [], [], {}, {}
        cats = ["vehicle.car", "human.pedestrian.adult", "animal",
                "movable_object.barrier", "vehicle.truck"]
        attrs = ["vehicle.moving", "pedestrian.standing", ""]
        for a in attrs[:2]:
            self.tables["attribute"][a] = {"name": a}
        stamp = 1_533_000_000_000_000
        for s in range(2):
            self.scene.append({"name": f"scene-000{s + 1}",
                               "token": f"scene{s}"})
            prev = ""
            for k in range(6):  # key frames: records s and s + 3
                tok = f"sd{s}_{k}"
                stamp += 50_000
                pose = f"pose{s}_{k}"
                self.tables["ego_pose"][pose] = {
                    "translation": list(rng.uniform(-50, 50, 3)),
                    "rotation": list(rng.uniform(-1, 1, 4))}
                cal = f"cal{s}"
                self.tables["calibrated_sensor"][cal] = {
                    "translation": [0.9, 0.0, 1.8],
                    "rotation": [0.7, 0.0, 0.0, 0.7]}
                self.tables["sample_data"][tok] = {
                    "token": tok, "prev": prev, "timestamp": stamp,
                    "ego_pose_token": pose, "calibrated_sensor_token": cal,
                    "filename": f"sweeps/{tok}.bin"}
                prev = tok
                if k % 3 != s:
                    continue
                anns = []
                for b in range(4):
                    ann = f"ann{s}_{k}_{b}"
                    anns.append(ann)
                    box = types.SimpleNamespace(
                        center=rng.uniform(-30, 30, 3),
                        wlh=rng.uniform(0.5, 5, 3),
                        orientation=Quaternion(
                            axis=[0, 0, 1], radians=rng.uniform(-3, 3)),
                        name=cats[(s + k + b) % len(cats)], token=ann)
                    self.boxes.setdefault(tok, []).append(box)
                    vel = rng.uniform(-5, 5, 3)
                    if b == 3 and s == 1:
                        vel[:] = np.nan
                    self.velocity[ann] = vel
                    self.tables["sample_annotation"][ann] = {
                        "num_lidar_pts": int(b != 2) * 3,
                        "num_radar_pts": int(b == 1),
                        "attribute_tokens": [attrs[b % 3]] if b % 3 < 2
                        else []}
                sample = {"token": f"sample{s}_{k}", "scene_token": f"scene{s}",
                          "data": {"LIDAR_TOP": tok}, "anns": anns}
                self.sample.append(sample)

    def get(self, table, token):
        if table == "sample":
            return next(s for s in self.sample if s["token"] == token)
        return self.tables[table][token]

    def get_sample_data_path(self, token):
        return f"/data/nuscenes/{self.tables['sample_data'][token]['filename']}"

    def get_sample_data(self, token):
        return self.get_sample_data_path(token), self.boxes[token], None

    def box_velocity(self, token):
        return self.velocity[token]


def stub_nuscenes(monkeypatch):
    nuscenes = types.ModuleType("nuscenes")
    nuscenes.NuScenes = NuScenes
    utils = types.ModuleType("nuscenes.utils")
    splits = types.ModuleType("nuscenes.utils.splits")
    splits.train, splits.val = ["scene-0001"], ["scene-0002"]
    splits.test, splits.mini_train, splits.mini_val = [], [], []
    geometry = types.ModuleType("nuscenes.utils.geometry_utils")
    geometry.transform_matrix = transform_matrix
    utils.splits, utils.geometry_utils = splits, geometry
    nuscenes.utils = utils
    pyquaternion = types.ModuleType("pyquaternion")
    pyquaternion.Quaternion = Quaternion
    for name, mod in (("nuscenes", nuscenes), ("nuscenes.utils", utils),
                      ("nuscenes.utils.splits", splits),
                      ("nuscenes.utils.geometry_utils", geometry),
                      ("pyquaternion", pyquaternion)):
        monkeypatch.setitem(sys.modules, name, mod)


@pytest.mark.parametrize("nsweeps", [1, 3])
def test_create_nuscenes_infos_equals_jax(tmp_path, monkeypatch, nsweeps):
    """Under the stub devkit: both info pkls equal the JAX package's byte
    for byte and key for key (sweep chains through `prev`, the f64
    transforms, velocities rotated into the lidar frame, mapped names,
    attributes, the lidar-or-radar filter)."""
    from pillarnet_lts_tpu.datasets.nuscenes import nusc_common as jnusc

    stub_nuscenes(monkeypatch)
    want = jnusc.create_nuscenes_infos(str(tmp_path), nsweeps=nsweeps)
    names = sorted(os.listdir(tmp_path))
    want_bytes = {n: read(tmp_path / n) for n in names}
    for n in names:
        os.remove(tmp_path / n)
    got = tnusc.create_nuscenes_infos(str(tmp_path), nsweeps=nsweeps)
    assert sorted(os.listdir(tmp_path)) == names == [
        f"infos_{s}_{nsweeps:02d}sweeps_withvelo_filter_True.pkl"
        for s in ("train", "val")]
    for n in names:
        assert read(tmp_path / n) == want_bytes[n], n
    assert_same(got, want)
    train, val = got
    assert len(train) == len(val) == 2
    assert all(len(i["sweeps"]) == nsweeps - 1 for i in train + val)
    assert sum(len(i["gt_boxes"]) for i in train + val) < 16  # filtered


def test_nuscenes_data_prep_builds_infos_then_the_database(tmp_path,
                                                           monkeypatch):
    """`nuscenes_data_prep` calls the info creation on a first run (the
    stub devkit, a recording stand-in for the database): the same calls
    as the JAX package's CLI."""
    from pillarnet_lts_tpu.datasets.utils import create_gt_database as jgt

    calls = {"jax": [], "port": []}
    for mod, key in ((create_data, "port"), (jgt, "jax")):
        monkeypatch.setattr(mod, "create_groundtruth_database",
                            lambda *a, rec=calls[key], **k: rec.append(
                                (a[0], a[2], k)))
    stub_nuscenes(monkeypatch)
    for key, prep in (("jax", jcreate_data.nuscenes_data_prep),
                      ("port", create_data.nuscenes_data_prep)):
        root = tmp_path / key
        root.mkdir()
        prep(str(root), nsweeps=2)
        assert sorted(os.listdir(root)) == [
            "infos_train_02sweeps_withvelo_filter_True.pkl",
            "infos_val_02sweeps_withvelo_filter_True.pkl"]
    (jname, jinfo, jkw), = calls["jax"]
    (name, info, kw), = calls["port"]
    assert (name, os.path.basename(info), kw) == (
        jname, os.path.basename(jinfo), jkw)


class _Box:
    def CopyFrom(self, other):
        self.__dict__.update(vars(other))


class _Object:
    def __init__(self):
        self.object = types.SimpleNamespace(box=_Box(), type=0)


class _Objects:
    def __init__(self):
        self.objects = []

    def SerializeToString(self):
        return pickle.dumps([(o.context_name, o.frame_timestamp_micros,
                              o.score, o.object.type,
                              sorted(vars(o.object.box).items()))
                             for o in self.objects])


def stub_waymo(monkeypatch):
    """waymo_open_dataset's message surface that the exports use."""
    wod = types.ModuleType("waymo_open_dataset")
    label_pb2 = types.ModuleType("waymo_open_dataset.label_pb2")
    label_pb2.Label = types.SimpleNamespace(Box=_Box)
    protos = types.ModuleType("waymo_open_dataset.protos")
    metrics_pb2 = types.ModuleType("waymo_open_dataset.protos.metrics_pb2")
    metrics_pb2.Object, metrics_pb2.Objects = _Object, _Objects
    wod.label_pb2, wod.protos, protos.metrics_pb2 = label_pb2, protos, \
        metrics_pb2
    for name, mod in (("waymo_open_dataset", wod),
                      ("waymo_open_dataset.label_pb2", label_pb2),
                      ("waymo_open_dataset.protos", protos),
                      ("waymo_open_dataset.protos.metrics_pb2", metrics_pb2)):
        monkeypatch.setitem(sys.modules, name, mod)


JAX_COMMON = "pillarnet_lts_tpu.datasets.waymo.waymo_common"


def test_waymo_exports_equal_jax_under_a_stub_devkit(raw, tmp_path,
                                                     monkeypatch):
    """`_create_pd_detection` and `_create_gt_detection` under the stub
    devkit write what the JAX package's write (every object's context,
    timestamp from the anno pkl, score, type and box fields); and the
    port's `WaymoDataset.evaluation` with the devkit writes
    `detection_pred.bin` and scores nothing, as the JAX package's does."""
    from pillarnet_lts_torch.datasets import WaymoDataset

    infos_path = tinfos.create_waymo_infos(raw, split="val")
    with open(infos_path, "rb") as f:
        infos = pickle.load(f)
    ds = WaymoDataset(infos_path, raw, test_mode=True)
    os.remove(infos_path)
    rng = np.random.RandomState(5)
    dets = {}
    for info in infos:
        n = len(info["gt_boxes"]) + 1
        dets[info["token"]] = {
            "box3d_lidar": rng.uniform(-30, 30, (n, 9)).astype(np.float32),
            "scores": rng.uniform(0, 1, n).astype(np.float32),
            "label_preds": rng.randint(0, 3, n)}
    stub_waymo(monkeypatch)
    monkeypatch.delitem(sys.modules, JAX_COMMON, raising=False)
    try:
        jcommon = importlib.import_module(JAX_COMMON)
        by_token = {i["token"]: i for i in infos}
        for fn, args in (("_create_pd_detection", (dets, by_token)),
                         ("_create_gt_detection", (infos,))):
            (tmp_path / "jax").mkdir(exist_ok=True)
            (tmp_path / "port").mkdir(exist_ok=True)
            want = getattr(jcommon, fn)(*args, str(tmp_path / "jax"))
            got = getattr(tcommon, fn)(*args, str(tmp_path / "port"))
            assert os.path.basename(got) == os.path.basename(want)
            assert read(got) == read(want), fn
            assert len(pickle.loads(read(got))) > len(infos)
        (tmp_path / "eval").mkdir()
        assert ds.evaluation(dets, str(tmp_path / "eval"),
                             device="cpu") == (None, None)
        assert os.listdir(tmp_path / "eval") == ["detection_pred.bin"]
        assert read(tmp_path / "eval" / "detection_pred.bin") == read(
            tmp_path / "port" / "detection_pred.bin")
    finally:
        sys.modules.pop(JAX_COMMON, None)
        monkeypatch.delattr(sys.modules["pillarnet_lts_tpu.datasets.waymo"],
                            "waymo_common", raising=False)


def test_devkit_paths_raise_import_error_without_the_devkit(tmp_path,
                                                            monkeypatch):
    """With `nuscenes`, `pyquaternion`, `waymo_open_dataset` and
    `tensorflow` unimportable, every devkit path raises ImportError naming
    the package; the modules themselves import."""
    for name in ("nuscenes", "pyquaternion", "waymo_open_dataset",
                 "tensorflow"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="nuscenes"):
        tnusc.create_nuscenes_infos(str(tmp_path))
    with pytest.raises(ImportError, match="nuscenes"):
        create_data.nuscenes_data_prep(str(tmp_path))
    for call in (lambda: tcommon._create_pd_detection({}, {}, str(tmp_path)),
                 lambda: tcommon._create_gt_detection([], str(tmp_path)),
                 lambda: tconv.extract_objects([], np.eye(3)),
                 lambda: tconv.convert_one((0, "r", "l", "a"))):
        with pytest.raises(ImportError, match="waymo_open_dataset|tensorflow"):
            call()
    frame = types.SimpleNamespace()
    with pytest.raises(ImportError, match="pyquaternion"):
        tconv.decode_annos(frame, 0)
    with pytest.raises(ImportError, match="waymo_open_dataset"):
        tconv.decode_frame(frame, 0)


def test_global_vel_to_ref_equals_jax():
    rng = np.random.RandomState(2)
    for _ in range(5):
        rot = np.linalg.qr(rng.randn(3, 3))[0]
        vel = list(rng.uniform(-20, 20, 2))
        got = tconv.global_vel_to_ref(vel, rot)
        want = jconv.global_vel_to_ref(vel, rot)
        assert [type(v) for v in got] == [type(v) for v in want]
        np.testing.assert_array_equal(got, want)


# ---- the native library -------------------------------------------------------


def test_native_functions_equal_jax_native():
    """The four functions of the port's library against the JAX package's
    on the same inputs, bit for bit."""
    need_natives()
    rng = np.random.RandomState(0)
    pts = rng.uniform(-20, 20, (20000, 5)).astype(np.float32)
    boxes = np.zeros((9, 9), np.float32)
    boxes[:, :3] = rng.uniform(-15, 15, (9, 3))
    boxes[:, 3:6] = rng.uniform(1, 6, (9, 3))
    boxes[:, -1] = rng.uniform(-np.pi, np.pi, 9)
    got = tnative.points_in_rbbox(pts, boxes)
    np.testing.assert_array_equal(got, jnative.points_in_rbbox(pts, boxes))
    assert got.any()
    assert tnative.points_in_rbbox(pts, boxes[:0]) is None

    corners = tops.center_to_corner_box2d(boxes[:, :2], boxes[:, 3:5],
                                          boxes[:, -1])
    np.testing.assert_array_equal(tnative.box_collision_test(corners, corners),
                                  jnative.box_collision_test(corners, corners))

    hm_got = np.zeros((64, 48), np.float32)
    hm_want = hm_got.copy()
    centers = rng.uniform(-3, 66, (12, 2)).astype(np.float32)
    radii = rng.randint(0, 6, 12).astype(np.int32)
    assert tnative.draw_gaussians(hm_got, centers, radii)
    assert jnative.draw_gaussians(hm_want, centers, radii)
    np.testing.assert_array_equal(hm_got, hm_want)
    assert hm_got.max() > 0
    with pytest.raises(ValueError, match="float32"):
        tnative.draw_gaussians(hm_got.astype(np.float64), centers, radii)

    tf = np.eye(4, dtype=np.float32)
    tf[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
    tf[:3, 3] = (1.5, -2.0, 0.25)
    for t in (tf, None):
        np.testing.assert_array_equal(tnative.transform_sweep(pts, t, 0.05),
                                      jnative.transform_sweep(pts, t, 0.05))


def test_box_np_ops_dispatch_as_jax(monkeypatch):
    """`points_in_rbbox` goes to the library for centred boxes and to numpy
    for another origin; `box_collision_test` goes to it for either
    winding; both packages call theirs alike; without a library both run
    the numpy route."""
    calls = {"port": [], "jax": []}
    for mod, key in ((tnative, "port"), (jnative, "jax")):
        for fn in ("points_in_rbbox", "box_collision_test"):
            monkeypatch.setattr(mod, fn, lambda *a, fn=fn, key=key:
                                calls[key].append(fn))
    rng = np.random.RandomState(4)
    pts = rng.uniform(-5, 5, (100, 4)).astype(np.float32)
    boxes = np.array([[0, 0, 0, 2, 3, 2, 0.3]], np.float32)
    corners = tops.center_to_corner_box2d(boxes[:, :2], boxes[:, 3:5],
                                          boxes[:, -1])
    for ops, key in ((tops, "port"), (jops, "jax")):
        ops.points_in_rbbox(pts, boxes)
        ops.points_in_rbbox(pts, boxes, origin=(0.5, 0.5, 0.0))
        ops.box_collision_test(corners, corners)
        ops.box_collision_test(corners, corners, clockwise=False)
        ops.box_collision_test(corners[:0], corners)
    assert calls["port"] == calls["jax"] == [
        "points_in_rbbox", "box_collision_test", "box_collision_test"]
    # a None from the library: the numpy route, equal in both packages
    np.testing.assert_array_equal(
        tops.points_in_rbbox(pts, boxes), jops.points_in_rbbox(pts, boxes))
    np.testing.assert_array_equal(
        tops.points_in_rbbox(pts, boxes, origin=(0.5, 0.5, 0.0)),
        jops.points_in_rbbox(pts, boxes, origin=(0.5, 0.5, 0.0)))


def test_native_build_failure_is_kept(tmp_path, monkeypatch):
    """A compiler that fails: `available()` is False, the functions return
    None / False, and `build_error()` holds the compiler's stderr; the
    build goes under `build/`, never under `csrc/`."""
    monkeypatch.setattr(tnative, "_state", {"tried": False, "lib": None,
                                            "error": None})
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'no such compiler feature' >&2\nexit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    assert not tnative.available()
    assert "no such compiler feature" in tnative.build_error()
    assert "exit 3" in tnative.build_error()
    assert tnative.points_in_rbbox(np.zeros((1, 3), np.float32),
                                   np.ones((1, 7), np.float32)) is None
    assert tnative.draw_gaussians(np.zeros((2, 2), np.float32),
                                  np.zeros((1, 2)), np.zeros(1)) is False
    assert os.listdir(tmp_path / "build") == []
    assert tnative.BUILD_DIR.endswith("build")
    assert not any(f.endswith(".so") for f in os.listdir(
        os.path.dirname(tnative.SOURCE)))


def test_native_library_lands_under_build():
    need_natives()
    path = tnative.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(ROOT, "build",
                                                 "pillarnet_lts_torch")
    # the JAX package's source, its header comment aside
    jsrc = read(os.path.join(ROOT, "csrc", "pillar_pipeline.cpp"))
    tsrc = read(tnative.SOURCE)
    assert jsrc[jsrc.index(b"#include"):] == tsrc[tsrc.index(b"#include"):]


def test_draw_gaussians_native_equals_the_target_stamp():
    """The library's stamp equals the JAX package's numpy gaussian target
    (`center_target.draw_gaussian`) within 2e-6, as `tests/test_native.py`
    holds the JAX package's library."""
    need_natives()
    hm = np.zeros((40, 40), np.float32)
    want = hm.copy()
    centers = np.array([[10.0, 12.0], [0.0, 39.0], [25.0, 5.0]], np.float32)
    radii = np.array([3, 2, 5], np.int32)
    tnative.draw_gaussians(hm, centers, radii)
    for c, r in zip(centers, radii):
        jtarget.draw_gaussian(want, c, int(r))
    np.testing.assert_allclose(hm, want, atol=2e-6)
