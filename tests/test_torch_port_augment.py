"""PyTorch port, the training data path: box geometry, the global and
per-object augmentations, the GT-AUG sampler and its database, and the
train `Preprocess`, against the JAX package's numpy route on the same
inputs.

Tolerance: none; every array equals the JAX package's bit for bit. Both
packages send `points_in_rbbox` and `box_collision_test` to their host
C++ when it is built (`csrc/libpillar_pipeline.so`,
`pillarnet_lts_torch/native`; f32, and it may differ from numpy at box
faces); each comparison runs one route on both sides: the numpy route,
pinned by making both packages' `native` functions return None, so the
tests hold whether or not a library is built, or, where both libraries
are built, the two native routes against each other.

The two random streams: the JAX package draws the augmentations, the
point shuffle and the GT-AUG reshuffles from numpy's global state; the
port draws the first two from the sample's generator
(`RandomState([seed, idx])`) and the reshuffles from the sampler's own
`RandomState(seed)`. The JAX side is lined up by seeding numpy's global
state as the port seeds each generator: with the sampler's seed before the
JAX sampler is built, and with [seed, idx] before each JAX sample; in the
pipeline test the JAX sampler's reshuffles draw from a generator that
continues numpy's state after its construction, as the port's does.
"""

import copy
import os
import pickle
import sys
import threading

import numpy as np
import pytest

import pillarnet_lts_tpu.native as jnative
import pillarnet_lts_torch.native as tnative
from pillarnet_lts_tpu.core.bbox import box_np_ops as jops
from pillarnet_lts_tpu.core.sampler import augment as jaug
from pillarnet_lts_tpu.core.sampler import db_sampler as jdb
from pillarnet_lts_tpu.core.sampler import per_object_noise as jnoise
from pillarnet_lts_tpu.datasets.nuscenes.nuscenes import (
    NuScenesDataset as JNuScenes)
from pillarnet_lts_tpu.datasets.pipelines.preprocess import (
    Preprocess as JPreprocess)
from pillarnet_lts_tpu.datasets.utils.create_gt_database import (
    create_groundtruth_database as jcreate_gt)
from pillarnet_lts_tpu.datasets.waymo.waymo import WaymoDataset as JWaymo
from pillarnet_lts_torch.apis import load_config
from pillarnet_lts_torch.core.bbox import box_np_ops as tops
from pillarnet_lts_torch.core.sampler import augment as taug
from pillarnet_lts_torch.core.sampler import db_sampler as tdb
from pillarnet_lts_torch.core.sampler import per_object_noise as tnoise
from pillarnet_lts_torch.datasets import WaymoDataset
from pillarnet_lts_torch.datasets.pipelines import preprocess as tpre
from pillarnet_lts_torch.datasets.synth import (write_nuscenes_set,
                                                write_waymo_set)
from pillarnet_lts_torch.datasets.utils import create_groundtruth_database
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_torch_port_dataprep import need_natives
from test_torch_port_datasets import assert_same_sample

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

RCNN = load_config(os.path.join(ROOT,
                                "configs/pillarrcnn/pillarrcnn18_waymo.py"))
NUSC = load_config(os.path.join(ROOT, "configs/pillarnet/pillarnet34_nusc.py"))
WAYMO_CLASSES = list(RCNN["class_names"])
COUNTS = (6, 3, 1)  # boxes of each class in a written Waymo frame
SEED = 11


@pytest.fixture
def numpy_route():
    """Both packages' numpy route of the two box tests."""
    with cs.numpy_route(jnative, tnative):
        yield


@pytest.fixture
def native_routes():
    """Both packages' native routes, each library built first (skips only
    where a compiler fails: `test_torch_port_dataprep.need_natives`)."""
    need_natives()


def random_boxes(rng, n, width=9, spread=20.0):
    """(n, width) f32 boxes: centre, size, [velocity,] yaw in [-pi, pi)."""
    boxes = np.zeros((n, width), np.float32)
    boxes[:, :2] = rng.uniform(-spread, spread, (n, 2))
    boxes[:, 2] = rng.uniform(-1.5, 0.5, n)
    boxes[:, 3:6] = rng.uniform([0.6, 0.8, 1.2], [2.5, 5.0, 2.2], (n, 3))
    if width > 7:
        boxes[:, 6:8] = rng.uniform(-5, 5, (n, 2))
    boxes[:, -1] = rng.uniform(-np.pi, np.pi, n)
    return boxes


def face_points(boxes):
    """For each axis-aligned box: its 8 corners, its 6 face centres and the
    points 2^-10 m outside each face centre (x, y, z, 2 features); exact
    in f32, and in the box frame, for boxes on a 0.25 m lattice."""
    out = []
    for b in boxes:
        c, h = b[:3], b[3:6] / np.float32(2)
        for sx in (-1, 1):
            for sy in (-1, 1):
                for sz in (-1, 1):
                    out.append(c + np.array([sx, sy, sz], np.float32) * h)
        for ax in range(3):
            for s in (-1, 1):
                p = c.copy()
                p[ax] = c[ax] + s * h[ax]
                out.append(p)
                q = p.copy()
                q[ax] = p[ax] + np.float32(s * 2.0 ** -10)
                out.append(q)
    pts = np.zeros((len(out), 5), np.float32)
    pts[:, :3] = out
    return pts


# ---- box geometry -----------------------------------------------------------

def test_points_in_rbbox_equals_the_numpy_route(numpy_route):
    """Random rotated boxes against a cloud of 2.5 chunks, and points on
    the corners and faces of axis-aligned boxes (and 2^-10 m outside):
    equal to the JAX numpy route; a face point is inside, one just outside
    is not."""
    rng = np.random.RandomState(1)
    boxes = random_boxes(rng, 35)
    pts = np.zeros((int(2.5 * tops._CHUNK), 5), np.float32)
    pts[:, :3] = rng.uniform([-22, -22, -3], [22, 22, 2], (len(pts), 3))
    got = tops.points_in_rbbox(pts, boxes)
    np.testing.assert_array_equal(got, jops.points_in_rbbox(pts, boxes))
    assert got.any()
    np.testing.assert_array_equal(tops.points_count_rbbox(pts, boxes),
                                  jops.points_count_rbbox(pts, boxes))

    # axis-aligned boxes on a 0.25 m lattice: the faces are exact in f32
    aligned = random_boxes(rng, 6)
    aligned[:, :6] = np.round(aligned[:, :6] * 4) / 4
    aligned[:, -1] = 0.0
    faces = face_points(aligned)
    got = tops.points_in_rbbox(faces, aligned)
    np.testing.assert_array_equal(got, jops.points_in_rbbox(faces, aligned))
    per_box = faces.shape[0] // len(aligned)
    for b in range(len(aligned)):
        own = got[b * per_box:(b + 1) * per_box, b]
        inside = np.ones(per_box, bool)
        inside[8 + 1::2] = False  # the points just outside a face
        np.testing.assert_array_equal(own, inside)
    assert tops.points_in_rbbox(pts, boxes[:0]).shape == (len(pts), 0)


@pytest.mark.parametrize("clockwise", [True, False])
def test_box_collision_test_equals_the_numpy_route(numpy_route, clockwise):
    """Crowded boxes (many overlaps, some nested, some sharing an edge)."""
    rng = np.random.RandomState(2)
    boxes = random_boxes(rng, 40, spread=6.0)
    boxes[5] = boxes[4] * np.array([1, 1, 1, 0.5, 0.5, 1, 1, 1, 1],
                                   np.float32)  # nested
    boxes[7, :] = boxes[6, :]
    boxes[7, 0] += boxes[6, 3]  # side by side
    boxes[6:8, -1] = 0.0
    corners = tops.center_to_corner_box2d(boxes[:, :2], boxes[:, 3:5],
                                          boxes[:, -1])
    want_corners = jops.center_to_corner_box2d(boxes[:, :2], boxes[:, 3:5],
                                               boxes[:, -1])
    np.testing.assert_array_equal(corners, want_corners)
    got = tops.box_collision_test(corners, corners[:25], clockwise)
    np.testing.assert_array_equal(
        got, jops.box_collision_test(corners, corners[:25], clockwise))
    assert got.any() and not got.all()
    assert tops.box_collision_test(corners[:0], corners).shape == (0, 40)


def test_box_tests_native_route_equals_jax_native(native_routes):
    """Where both libraries are built: the port's `points_in_rbbox` (the
    rotated boxes and the face points of the numpy-route test) and
    `box_collision_test` (crowded boxes) go to its C++ and equal the JAX
    package's C++ route bit for bit."""
    rng = np.random.RandomState(1)
    boxes = random_boxes(rng, 35)
    pts = np.zeros((20000, 5), np.float32)
    pts[:, :3] = rng.uniform([-22, -22, -3], [22, 22, 2], (len(pts), 3))
    aligned = random_boxes(rng, 6)
    aligned[:, :6] = np.round(aligned[:, :6] * 4) / 4
    aligned[:, -1] = 0.0
    for p, b in ((pts, boxes), (face_points(aligned), aligned)):
        got = tops.points_in_rbbox(p, b)
        np.testing.assert_array_equal(got, tnative.points_in_rbbox(p, b))
        np.testing.assert_array_equal(got, jops.points_in_rbbox(p, b))
    crowded = random_boxes(np.random.RandomState(2), 40, spread=6.0)
    corners = tops.center_to_corner_box2d(crowded[:, :2], crowded[:, 3:5],
                                          crowded[:, -1])
    got = tops.box_collision_test(corners, corners[:25])
    np.testing.assert_array_equal(
        got, tnative.box_collision_test(corners, corners[:25]))
    np.testing.assert_array_equal(
        got, jops.box_collision_test(corners, corners[:25]))
    assert got.any() and not got.all()


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_rotations_corners_and_periods_equal_jax(axis):
    rng = np.random.RandomState(3 + axis)
    pts32 = rng.randn(50, 3).astype(np.float32)
    angles = rng.uniform(-4, 4, 7)
    sets = rng.randn(7, 8, 3)
    np.testing.assert_array_equal(
        tops.rotation_3d_in_axis(sets, angles, axis),
        jops.rotation_3d_in_axis(sets, angles, axis))
    for p in (pts32, pts32.astype(np.float64)):
        got = tops.rotation_points_single_angle(p, 0.7, axis)
        assert got.dtype == p.dtype
        np.testing.assert_array_equal(
            got, jops.rotation_points_single_angle(p, 0.7, axis))
    boxes = random_boxes(rng, 7)
    np.testing.assert_array_equal(
        tops.center_to_corner_box3d(boxes[:, :3], boxes[:, 3:6],
                                    boxes[:, -1], axis=axis),
        jops.center_to_corner_box3d(boxes[:, :3], boxes[:, 3:6],
                                    boxes[:, -1], axis=axis))
    corners = tops.corners_nd(boxes[:, 3:5], origin=(0.5, 0.0))
    np.testing.assert_array_equal(
        corners, jops.corners_nd(boxes[:, 3:5], origin=(0.5, 0.0)))
    np.testing.assert_array_equal(tops.corner_to_standup_nd(corners),
                                  jops.corner_to_standup_nd(corners))
    np.testing.assert_array_equal(tops.rotation_2d(corners, angles),
                                  jops.rotation_2d(corners, angles))
    np.testing.assert_array_equal(tops.limit_period(angles, 0.5, 2 * np.pi),
                                  jops.limit_period(angles, 0.5, 2 * np.pi))
    assert tpre.limit_period is tops.limit_period  # its old home


# ---- the augmentations ------------------------------------------------------

def _scene(seed, width):
    rng = np.random.RandomState(seed)
    points = rng.uniform(-30, 30, (500, 5)).astype(np.float32)
    return random_boxes(rng, 9, width), points


def _both(fn_port, fn_jax, seed, width):
    """The port's fn on copies of a scene drawing from RandomState(seed),
    the JAX package's on other copies drawing from numpy's global state
    seeded the same: the outputs, and each side's generator state after."""
    boxes, points = _scene(seed, width)
    rng = np.random.RandomState(seed)
    tb, tp = boxes.copy(), points.copy()
    out_t = fn_port(tb, tp, rng)
    np.random.seed(seed)
    jb, jp = boxes.copy(), points.copy()
    out_j = fn_jax(jb, jp)
    return (tb, tp, out_t, rng.get_state()), (jb, jp, out_j,
                                              np.random.get_state())


_AUGMENTS = {
    "flip": (lambda b, p, r: taug.random_flip_both(b, p, r),
             lambda b, p: jaug.random_flip_both(b, p)),
    "flip_about": (lambda b, p, r: taug.random_flip_both(b, p, r,
                                                         flip_coor=3.5),
                   lambda b, p: jaug.random_flip_both(b, p, flip_coor=3.5)),
    "rotation": (lambda b, p, r: taug.global_rotation(
                     b, p, r, rotation=[-0.78539816, 0.78539816]),
                 lambda b, p: jaug.global_rotation(
                     b, p, rotation=[-0.78539816, 0.78539816])),
    "scaling": (lambda b, p, r: taug.global_scaling_v2(b, p, r, 0.95, 1.05),
                lambda b, p: jaug.global_scaling_v2(b, p, 0.95, 1.05)),
    "translate": (lambda b, p, r: taug.global_translate_(b, p, r, 0.5),
                  lambda b, p: jaug.global_translate_(b, p, 0.5)),
    "translate_xyz": (lambda b, p, r: taug.global_translate_(
                          b, p, r, [0.2, 0.4, 0.1]),
                      lambda b, p: jaug.global_translate_(
                          b, p, [0.2, 0.4, 0.1])),
}


@pytest.mark.parametrize("width", [9, 7])
@pytest.mark.parametrize("name", sorted(_AUGMENTS))
def test_augmentations_equal_jax_in_place(name, width):
    """Each augmentation on 9-column boxes (with velocities) and 7-column
    ones: the same boxes and points, changed in place, the same number of
    draws. Seeds that take both flips are among those tried."""
    for seed in range(4):
        (tb, tp, out_t, st), (jb, jp, out_j, sj) = _both(*_AUGMENTS[name],
                                                         seed, width)
        assert out_t[0] is tb and out_t[1] is tp  # in place
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(st[1], sj[1])
        assert st[2] == sj[2]
        boxes, points = _scene(seed, width)
        assert not np.array_equal(tp, points) or name.startswith("flip")


@pytest.mark.parametrize("n", [0, 1, 2, 1000, 50000])
def test_shuffle_rows_equals_numpy_shuffle(n):
    """`Preprocess`'s point shuffle gives `np.random.shuffle`'s order (the
    JAX package's) and leaves the generator where it leaves it."""
    points = np.random.RandomState(n).rand(n, 5).astype(np.float32)
    got, g = points.copy(), np.random.RandomState(9)
    tpre.shuffle_rows(g, got)
    np.random.seed(9)
    want = points.copy()
    np.random.shuffle(want)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(g.get_state()[1], np.random.get_state()[1])
    assert g.get_state()[2] == np.random.get_state()[2]


def test_scaling_scales_velocities_and_translation_takes_z_from_std0():
    """The reference's quirks, kept: scaling scales every column but yaw;
    the z shift is drawn with std[0]."""
    boxes, points = _scene(0, 9)
    b = boxes.copy()
    taug.global_scaling_v2(b, points.copy(), np.random.RandomState(0),
                           2.0, 2.0 + 1e-9)
    np.testing.assert_allclose(b[:, :8], boxes[:, :8] * 2.0, rtol=1e-6)
    np.testing.assert_array_equal(b[:, 8], boxes[:, 8])
    b = boxes.copy()
    taug.global_translate_(b, points.copy(), np.random.RandomState(0),
                           [1.0, 0.0, 0.0])
    shift = b[0, :3] - boxes[0, :3]
    assert shift[1] == 0 and shift[0] != 0 and shift[2] != 0


@pytest.mark.parametrize("case", ["all", "masked", "no_points"])
def test_noise_per_object_equals_jax(numpy_route, case):
    """9 boxes crowded so that some tries collide; points in and around
    them; a valid mask that skips a third of the boxes."""
    rng = np.random.RandomState(5)
    boxes = random_boxes(rng, 9, spread=6.0)
    points = rng.uniform(-8, 8, (3000, 5)).astype(np.float32)
    mask = None if case != "masked" else np.arange(9) % 3 != 0
    tb, jb = boxes.copy(), boxes.copy()
    tp = None if case == "no_points" else points.copy()
    jp = None if case == "no_points" else points.copy()
    g = np.random.RandomState(6)
    tnoise.noise_per_object_(tb, tp, g, valid_mask=mask,
                             rotation_perturb=0.3, center_noise_std=1.5)
    np.random.seed(6)
    jnoise.noise_per_object_(jb, jp, valid_mask=mask, rotation_perturb=0.3,
                             center_noise_std=1.5)
    np.testing.assert_array_equal(tb, jb)
    if tp is not None:
        np.testing.assert_array_equal(tp, jp)
        assert not np.array_equal(tp, points)
    assert not np.array_equal(tb, boxes)


# ---- the GT database and the sampler ----------------------------------------

@pytest.fixture(scope="module")
def waymo_db(tmp_path_factory):
    """4 Waymo-layout train frames of 3,000 points with 6 / 3 / 1 boxes of
    the three classes, and the port's GT database over them (the
    configs' dbinfos name)."""
    root = str(tmp_path_factory.mktemp("waymo_db"))
    info = write_waymo_set(root, 4, 3000, WAYMO_CLASSES,
                           RCNN["point_cloud_range"], seed=9, split="train",
                           class_counts=COUNTS)
    dbinfo = os.path.join(root, "dbinfos_train_1sweeps_withvelo.pkl")
    with cs.numpy_route(jnative, tnative):
        infos = create_groundtruth_database("WaymoDataset", root, info,
                                            used_classes=WAYMO_CLASSES,
                                            dbinfo_path=dbinfo)
    return root, info, dbinfo, infos


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


def test_waymo_gt_database_equals_jax(waymo_db, tmp_path, numpy_route):
    """The `.bin` bytes (object-centred xyz and the 5 point features) and
    the dbinfos pkl bytes equal the JAX package's over the same frames;
    the default names are the JAX package's `_1sweeps` ones."""
    root, info, dbinfo, infos = waymo_db
    jroot = tmp_path / "jax"
    jcreate_gt("WaymoDataset", root, info, used_classes=WAYMO_CLASSES,
               db_path=str(jroot / "gt_database_1sweeps"),
               dbinfo_path=str(jroot / "dbinfos.pkl"))
    want = _files(jroot / "gt_database_1sweeps")
    assert _files(os.path.join(root, "gt_database_1sweeps")) == want
    assert len(want) == 4 * sum(COUNTS)
    with open(dbinfo, "rb") as f, open(jroot / "dbinfos.pkl", "rb") as g:
        assert f.read() == g.read()
    assert [len(infos[c]) for c in WAYMO_CLASSES] == [4 * c for c in COUNTS]
    assert infos["VEHICLE"][0]["num_points_in_gt"] > 5
    # the default file names
    create_groundtruth_database("WaymoDataset", root, info,
                                used_classes=["CYCLIST"],
                                db_path=str(tmp_path / "p"))
    assert os.path.exists(os.path.join(root, "dbinfos_train_1sweeps.pkl"))


def test_nuscenes_gt_database_equals_jax(tmp_path, monkeypatch, numpy_route):
    """3 nuScenes frames of 3 sweeps: both packages build the set in train
    mode (class-balanced resampling over `used_classes`, then each frame's
    sweep draws): JAX under numpy's global state seeded 0 before the
    resampling and [0, idx] before each frame, the port from the same
    seeds. The `.bin` bytes and the dbinfos pkl bytes are equal."""
    root = str(tmp_path / "nusc")
    info = write_nuscenes_set(root, 3, 2000, 3, NUSC["class_names"],
                              NUSC["point_cloud_range"], seed=2,
                              split="train")
    used = ["car", "truck", "pedestrian"]
    create_groundtruth_database("NuScenesDataset", root, info,
                                used_classes=used, nsweeps=3)
    seeded = JNuScenes.get_sensor_data

    def get_sensor_data(self, idx):
        np.random.seed([0, idx])
        return seeded(self, idx)

    monkeypatch.setattr(JNuScenes, "get_sensor_data", get_sensor_data)
    jroot = tmp_path / "jax"
    np.random.seed(0)
    jcreate_gt("NuScenesDataset", root, info, used_classes=used, nsweeps=3,
               db_path=str(jroot / "gt_database_3sweeps_withvelo"),
               dbinfo_path=str(jroot / "dbinfos.pkl"))
    want = _files(jroot / "gt_database_3sweeps_withvelo")
    assert want
    assert _files(os.path.join(root, "gt_database_3sweeps_withvelo")) == want
    with open(os.path.join(root, "dbinfos_train_3sweeps_withvelo.pkl"),
              "rb") as f, open(jroot / "dbinfos.pkl", "rb") as g:
        assert f.read() == g.read()


GROUPS = [dict(VEHICLE=15), dict(PEDESTRIAN=10), dict(CYCLIST=10)]


def _scene_boxes(rng):
    names = np.array(["VEHICLE"] * rng.randint(0, 8)
                     + ["PEDESTRIAN"] * rng.randint(0, 4) + ["CYCLIST"])
    return random_boxes(rng, len(names), spread=40.0), names


def test_sampler_equals_jax_over_reshuffles(waymo_db, numpy_route):
    """The sampler alone over 8 scenes: each draws 8-15 vehicles (of 24),
    6-10 pedestrians (of 12) and 9 cyclists (of 4), so every class's pass
    ends and reshuffles at least twice. Every output equals the JAX
    sampler's, built under np.random.seed(SEED), and the generators have
    drawn the same."""
    root, _, _, infos = waymo_db
    np.random.seed(SEED)
    want_s = jdb.DataBaseSampler(copy.deepcopy(infos), GROUPS)
    got_s = tdb.DataBaseSampler(copy.deepcopy(infos), GROUPS, seed=SEED)
    rng = np.random.RandomState(12)
    pasted = 0
    for _ in range(8):
        boxes, names = _scene_boxes(rng)
        got = got_s.sample_all(root, boxes, names, 5)
        want = want_s.sample_all(root, boxes, names, 5)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        pasted += len(got["gt_boxes"])
    assert pasted > 8 * 5
    np.testing.assert_array_equal(got_s.rng.get_state()[1],
                                  np.random.get_state()[1])
    for k in infos:
        np.testing.assert_array_equal(got_s._sampler_dict[k]._indices,
                                      want_s._sampler_dict[k]._indices)


def test_build_db_sampler_filters_as_jax(waymo_db):
    """`build_db_sampler` of the two-stage Waymo config's `db_sampler`
    (min-points and difficulty filters) on the database: the same
    infos a class as the JAX package's; group sampling and per-object
    rotation raise."""
    _, _, dbinfo, infos = waymo_db
    cfg = dict(RCNN["db_sampler"], db_info_path=dbinfo)
    least = int(np.median([i["num_points_in_gt"] for i in infos["VEHICLE"]]))
    cfg["db_prep_steps"] = [dict(filter_by_min_num_points=dict(
        VEHICLE=least + 1, PEDESTRIAN=5, CYCLIST=5)),
        dict(filter_by_difficulty=[-1])]
    got = tdb.build_db_sampler(cfg).db_infos
    want = jdb.build_db_sampler(cfg).db_infos
    assert {k: [i["path"] for i in v] for k, v in got.items()} == \
        {k: [i["path"] for i in v] for k, v in want.items()}
    assert len(got["VEHICLE"]) < len(infos["VEHICLE"])
    with pytest.raises(NotImplementedError):
        tdb.DataBaseSampler(infos, [dict(VEHICLE=2, CYCLIST=1)])
    with pytest.raises(NotImplementedError):
        tdb.DataBaseSampler(infos, GROUPS, global_rot_range=[0, 0.5])


def test_batch_sampler_returns_the_remainder_then_reshuffles():
    s = tdb.BatchSampler(list(range(5)), np.random.RandomState(0))
    first = list(s._indices)
    assert s.sample(3) == first[:3]
    assert s.sample(3) == first[3:]  # idx + num >= n: the rest only
    assert s._idx == 0 and sorted(s._indices) == list(range(5))


def test_batch_sampler_cursor_under_threads():
    """16 threads take one object at a time, 40 passes over 7 objects with
    the interpreter switching every microsecond: every pass hands out each
    object once, so each comes out 40 times (a lost cursor update would
    hand one out twice in a pass)."""
    n, passes, threads = 7, 40, 16
    s = tdb.BatchSampler(list(range(n)), np.random.RandomState(1))
    out, lock = [], threading.Lock()
    per = n * passes // threads + 1
    todo = [per] * threads
    todo[-1] = n * passes - per * (threads - 1)

    def work(k):
        got = [x for _ in range(k) for x in s.sample(1)]
        with lock:
            out.extend(got)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(k,)) for k in todo]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert np.bincount(out, minlength=n).tolist() == [passes] * n


# ---- the train pipeline -----------------------------------------------------

def _train_split(root, info, dbinfo):
    """The two-stage Waymo config's train split over the written frames;
    the port's GT-AUG sampler seeded SEED (`db_sampler.seed`, which the
    JAX package does not read)."""
    pipeline = copy.deepcopy(RCNN["train_pipeline"])
    for st in pipeline:
        if st["type"] == "Preprocess":
            st["cfg"]["db_sampler"].update(db_info_path=dbinfo, seed=SEED)
    return dict(root_path=root, info_path=info, nsweeps=1,
                class_names=WAYMO_CLASSES, pipeline=pipeline, sample=False)


def test_train_pipeline_with_gt_aug_equals_jax(waymo_db, monkeypatch,
                                               numpy_route):
    """`pillarrcnn18_waymo`'s train pipeline as written (GT-AUG 15 / 10 /
    10, min points 5, flips, rotation, scaling, translation, shuffle,
    targets) over the 4 frames twice: every sample equals the JAX
    package's (streams lined up as the module docstring says)."""
    root, info, dbinfo, _ = waymo_db
    split = _train_split(root, info, dbinfo)
    port = WaymoDataset(**copy.deepcopy(split))
    tsampler = port.pipeline.transforms[2].db_sampler
    np.random.seed(SEED)
    jds = JWaymo(**copy.deepcopy(split))
    side = np.random.RandomState()
    side.set_state(np.random.get_state())

    def reset(self):
        if self._shuffle:
            side.shuffle(self._indices)
        self._idx = 0

    monkeypatch.setattr(jdb.BatchSampler, "_reset", reset)
    n_boxes = 0
    for _ in range(2):
        for idx in range(len(port)):
            np.random.seed([port.seed, idx])
            want = jds[idx]
            got = port[idx]
            assert_same_sample(got, want)
            n_boxes += int((got["gt_boxes_and_cls"][:, 3] > 0).sum())
    assert n_boxes > 2 * 4 * sum(COUNTS)  # GT-AUG added boxes
    np.testing.assert_array_equal(side.get_state()[1],
                                  tsampler.rng.get_state()[1])


@pytest.mark.parametrize("kind", ["NuScenesDataset", "WaymoDataset"])
def test_preprocess_drops_names_and_sparse_boxes_as_jax(kind, numpy_route):
    """The branches no config takes: `DontCare` / `ignore` / `UNKNOWN`
    boxes dropped and `min_points_in_gt=40` (some boxes hold fewer),
    then the class filter, the augmentations and the shuffle, on a
    scene with 9-column (nuScenes) or 7-column boxes: equal to the JAX
    `Preprocess` drawing from numpy's global state seeded as the port's
    generator."""
    rng = np.random.RandomState(8)
    width = 9 if kind == "NuScenesDataset" else 7
    boxes = random_boxes(rng, 12, width)
    names = np.array(["car", "DontCare", "pedestrian", "ignore", "car",
                      "UNKNOWN", "bus", "car", "pedestrian", "car", "car",
                      "pedestrian"])
    inside = [rng.uniform(-0.4, 0.4, (n, 3)) * boxes[b, 3:6] + boxes[b, :3]
              for b, n in enumerate(rng.randint(0, 90, 12))]
    points = np.concatenate(
        [rng.uniform([-25, -25, -3], [25, 25, 2], (4000, 3))] + inside)
    points = np.concatenate([points, rng.rand(len(points), 2)], 1).astype(
        np.float32)
    cfg = dict(mode="train", shuffle_points=True, min_points_in_gt=40,
               global_rot_noise=[-0.78539816, 0.78539816],
               global_scale_noise=[0.95, 1.05], global_translate_std=0.5,
               class_names=["car", "pedestrian"])

    def res(with_rng):
        out = {"type": kind, "metadata": {"token": "t"},
               "lidar": {"combined": points.copy(), "points": points.copy(),
                         "annotations": {"boxes": boxes.copy(),
                                         "names": names}}}
        if with_rng:
            out["rng"] = np.random.RandomState([3, 1])
        return out

    got, _ = tpre.Preprocess(cfg)(res(True), None)
    np.random.seed([3, 1])
    want, _ = JPreprocess(cfg)(res(False), None)
    np.testing.assert_array_equal(got["lidar"]["points"],
                                  want["lidar"]["points"])
    for k in ("gt_boxes", "gt_names", "gt_classes"):
        np.testing.assert_array_equal(got["lidar"]["annotations"][k],
                                      want["lidar"]["annotations"][k], k)
    kept = got["lidar"]["annotations"]["gt_names"]
    assert 0 < len(kept) < 8 and "bus" not in kept


def test_every_config_builds_its_train_preprocess(waymo_db):
    """No config's train `Preprocess` raises any more (GT-AUG configs read
    the database written here)."""
    _, _, dbinfo, _ = waymo_db
    names = []
    for d in ("configs/pillarnet", "configs/pillarrcnn", "configs/demo"):
        for f in sorted(os.listdir(os.path.join(ROOT, d))):
            if not f.endswith(".py"):
                continue
            cfg = load_config(os.path.join(ROOT, d, f))
            for st in cfg.get("train_pipeline") or []:
                if st["type"] != "Preprocess":
                    continue
                pre = copy.deepcopy(st["cfg"])
                if (pre.get("db_sampler") or {}).get("enable", False):
                    pre["db_sampler"]["db_info_path"] = dbinfo
                tpre.Preprocess(pre)
                names.append(f)
    assert len(names) >= 15, names
