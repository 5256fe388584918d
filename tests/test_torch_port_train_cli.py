"""PyTorch port, the training runtime around the step: the training CLI,
the pretrained load, precise BN, the TensorBoard hook and the
`exp_decay` / `manual_stepping` schedules, against the JAX package where
it has the same function.

Tolerances:
- the schedules: rtol 1e-6 / atol 1e-9 of the JAX package's jitted
  schedules (as `test_torch_port_train.py` holds one-cycle), the
  staircase exponent equal at every step; AdamW on them within rtol 1e-6
  of optax over 4 steps;
- `load_pretrained`: the loaded model equal, tensor for tensor, to the
  JAX package's `load_pretrained` result carried over by
  `load_jax_variables`, and the same names in each report list;
- `recompute_batch_stats`: the port's exact batch statistics within
  1e-4 x (|running| + |batch|) + 1e-6 of the JAX forward's own (each
  read off one running-average update in f64, whose f32 rounding the
  1 / momentum = 100 multiplies), and the JAX package's
  `recompute_batch_stats` within its own extrapolation error, 8 f32 ulps
  of the statistics' size over momentum^2;
- the TensorBoard hook: the same (tag, step, value) triples as the JAX
  hook, the values as f32;
- the CLI: no tolerance; a resumed run's last checkpoint equals the
  uninterrupted run's tensor for tensor.
"""

import copy
import glob
import logging
import math
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import struct

from pillarnet_lts_tpu.models import build_detector as build_jax_detector
from pillarnet_lts_tpu.runtime import hooks as jhooks
from pillarnet_lts_tpu.runtime import precise_bn as jprecise
from pillarnet_lts_tpu.runtime import torch_convert as jconv
from pillarnet_lts_tpu.runtime.checkpoint import (
    load_pretrained as jload_pretrained)
from pillarnet_lts_tpu.runtime.log_buffer import LogBuffer as JLogBuffer
from pillarnet_lts_tpu.solver import optim as joptim
from pillarnet_lts_torch.apis import (apply_pretrained, build_model_from_cfg,
                                      load_config, optimizer_from_cfg,
                                      train_detector)
from pillarnet_lts_torch.datasets import DemoDataset, collate_batch
from pillarnet_lts_torch.datasets.pipelines import preprocess as tpre
from pillarnet_lts_torch.runtime import convert
from pillarnet_lts_torch.runtime.checkpoint import (load_pretrained,
                                                    save_checkpoint)
from pillarnet_lts_torch.runtime.hooks import TensorboardLoggerHook
from pillarnet_lts_torch.runtime.log_buffer import LogBuffer
from pillarnet_lts_torch.runtime.precise_bn import recompute_batch_stats
from pillarnet_lts_torch.runtime.train_step import batch_to_device
from pillarnet_lts_torch.solver import build_optimizer
from pillarnet_lts_torch.solver.optim import (exponential_decay_schedule,
                                              manual_stepping_schedule)
from pillarnet_lts_torch.tools import train as train_cli
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_torch_port_modules import random_variables

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DEMO = os.path.join(ROOT, "configs", "demo", "pillarnet18_demo.py")
RCNN_DEMO = os.path.join(ROOT, "configs", "demo", "pillarrcnn18_demo.py")


# ---- the lr schedules -------------------------------------------------------

_SCHEDULES = {
    "exp_staircase": dict(type="exp_decay", init_lr=3e-3, decay_length=0.1,
                          decay_factor=0.8, staircase=True),
    "exp_smooth": dict(type="exp_decay", init_lr=3e-3, decay_length=0.07,
                       decay_factor=0.8, staircase=False),
    "manual": dict(type="manual_stepping", boundaries=[0.3, 0.55, 0.8],
                   rates=[1e-3, 5e-4, 1e-4, 1e-5]),
}


def _port_schedule(lr, total):
    if lr["type"] == "exp_decay":
        return exponential_decay_schedule(total, lr["init_lr"],
                                          lr["decay_length"],
                                          lr["decay_factor"],
                                          lr["staircase"])
    return manual_stepping_schedule(total, lr["boundaries"], lr["rates"])


def _jax_schedule(lr, total):
    if lr["type"] == "exp_decay":
        return joptim.exponential_decay_schedule(total, lr["init_lr"],
                                                 lr["decay_length"],
                                                 lr["decay_factor"],
                                                 lr["staircase"])
    return joptim.manual_stepping_schedule(total, lr["boundaries"],
                                           lr["rates"])


@pytest.mark.parametrize("total_steps", [7, 40, 1013])
@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_schedules_match_jax(name, total_steps):
    """Every step of the run and two past it, the boundaries and the
    staircase edges among them."""
    lr = _SCHEDULES[name]
    steps = np.arange(total_steps + 2)
    want = np.asarray(jax.jit(jax.vmap(_jax_schedule(lr, total_steps)))(
        steps))
    got = np.array([_port_schedule(lr, total_steps)(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    # the staircase and the stepping take their steps at the same steps
    assert np.array_equal(np.diff(got) != 0, np.diff(want) != 0)
    assert len(set(got.tolist())) > 1


@pytest.mark.parametrize("name", ["exp_staircase", "manual"])
def test_adamw_on_the_other_schedules_matches_optax(name):
    """4 steps of AdamW (b1 0.9, clip 35) on each schedule over 8 steps."""
    rng = np.random.RandomState(4)
    shapes = {"a": (8, 4, 3, 3), "b": (8,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * g).astype(np.float32)
              for k, s in shapes.items()} for g in (80.0, 0.5, 3.0, 1e-3)]
    lr = _SCHEDULES[name]
    tx = joptim.build_optimizer(dict(type="adam", wd=0.01), lr, 8,
                                grad_clip_norm=35.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)

    @jax.jit
    def update(g, st, p):
        upd, st = tx.update(g, st, p)
        return optax.apply_updates(p, upd), st

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = build_optimizer(list(tp.values()), dict(type="adam", wd=0.01), lr,
                          8, grad_clip_norm=35.0)
    for g in grads:
        jp, state = update({k: jnp.asarray(v) for k, v in g.items()}, state,
                           jp)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-9)
    with pytest.raises(NotImplementedError):
        build_optimizer(list(tp.values()), dict(type="adam"),
                        dict(type="cosine"), 8)


# ---- the TensorBoard hook ---------------------------------------------------

class _FakeTrainer(types.SimpleNamespace):
    """What the hooks read of a trainer: the work dir, logger, log buffer
    and the iteration counters."""


def _drive(hook, trainer, iters=7, interval=2):
    hook.before_run(trainer)
    rng = np.random.RandomState(0)
    for i in range(iters):
        trainer.inner_iter = i
        trainer.log_buffer.update({"loss": float(rng.rand() * 10),
                                   "grad_norm": float(rng.rand() * 100)})
        hook.after_train_iter(trainer)
        trainer.iter += 1
    hook.after_run(trainer)


class _RecordingWriter:
    log = []

    def __init__(self, log_dir):
        self.log_dir = log_dir

    def scalar(self, tag, value, step):
        self.log.append((tag, int(step), float(np.float32(value))))

    def flush(self):
        pass


def _no_tensorflow(monkeypatch):
    """tensorboard without TensorFlow (its `notf` marker): the same event
    files, without TensorFlow's ~12 s import."""
    monkeypatch.setitem(sys.modules, "tensorboard.compat.notf",
                        types.ModuleType("tensorboard.compat.notf"))


def _events(log_dir):
    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader)

    out = []
    for path in sorted(glob.glob(os.path.join(log_dir, "events.*"))):
        for ev in EventFileLoader(path).Load():
            for v in ev.summary.value:
                value = (v.simple_value if v.HasField("simple_value")
                         else v.tensor.float_val[0])
                out.append((v.tag, int(ev.step), float(value)))
    return out


def test_tensorboard_hook_writes_what_the_jax_hook_writes(tmp_path,
                                                          monkeypatch):
    """7 iterations at interval 2: the port's event file holds the JAX
    hook's scalars (flax's writer replaced by a recorder)."""
    _no_tensorflow(monkeypatch)
    fake = types.ModuleType("flax.metrics.tensorboard")
    fake.SummaryWriter = _RecordingWriter
    monkeypatch.setitem(sys.modules, "flax.metrics.tensorboard", fake)
    import flax.metrics
    monkeypatch.setattr(flax.metrics, "tensorboard", fake, raising=False)
    _RecordingWriter.log = []
    _drive(jhooks.TensorboardLoggerHook(interval=2),
           _FakeTrainer(work_dir=str(tmp_path / "j"), iter=0,
                        log_buffer=JLogBuffer(),
                        logger=logging.getLogger("j")))
    _drive(TensorboardLoggerHook(interval=2),
           _FakeTrainer(work_dir=str(tmp_path / "t"), iter=0,
                        log_buffer=LogBuffer(),
                        logger=logging.getLogger("t")))
    got = _events(str(tmp_path / "t" / "tf_logs"))
    assert sorted(got) == sorted(_RecordingWriter.log)
    assert len(got) == 2 * 3


def test_tensorboard_hook_without_tensorboard_does_nothing(tmp_path,
                                                           monkeypatch,
                                                           caplog):
    """Without the package the hook logs one warning and writes nothing,
    as the JAX hook writes nothing without flax's writer."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "flax.metrics.tensorboard", None)
    import flax.metrics
    monkeypatch.delattr(flax.metrics, "tensorboard", raising=False)
    jhook = jhooks.TensorboardLoggerHook(interval=2)
    _drive(jhook, _FakeTrainer(work_dir=str(tmp_path / "j"), iter=0,
                               log_buffer=JLogBuffer(),
                               logger=logging.getLogger("j")))
    assert jhook.writer is None
    hook = TensorboardLoggerHook(interval=2)
    with caplog.at_level(logging.WARNING):
        _drive(hook, _FakeTrainer(work_dir=str(tmp_path / "t"), iter=0,
                                  log_buffer=LogBuffer(),
                                  logger=logging.getLogger("t")))
    assert hook.writer is None
    assert [r.levelname for r in caplog.records] == ["WARNING"]
    assert not os.path.exists(tmp_path / "t")


# ---- the pretrained load ----------------------------------------------------

@pytest.fixture(scope="module")
def rcnn_pair():
    """numpy variables of a pillarrcnn18_demo model and of a PillarNet of
    its first stage's config, with their configs."""
    cfg = load_config(RCNN_DEMO)
    first = dict(cfg, model=copy.deepcopy(cfg["model"]["first_stage_cfg"]))
    pts = jnp.zeros((1, 64, 5), jnp.float32)
    msk = jnp.ones((1, 64), bool)
    out = []
    for c, s in ((cfg, 31), (first, 32)):
        jm = build_jax_detector(copy.deepcopy(c["model"]),
                                train_cfg=c["train_cfg"],
                                test_cfg=c["test_cfg"])
        out.append((c, jax.tree_util.tree_map(
            np.array, random_variables(jm, s, pts, msk, train=False))))
    return out


def _ports(pair):
    """Each (config, variables) of `rcnn_pair` with a port model of it."""
    return [(c, v, convert.load_jax_variables(
        build_model_from_cfg(c, device="cpu"), v)) for c, v in pair]


def _path_names(model, prefix=()):
    """{'params/a/b/leaf': port name} of a port model."""
    return {"/".join(k): name for k, (_, _, name, _) in
            convert._targets(model).items() if k[0] != "quant"}


def test_load_pretrained_into_single_det_matches_jax(tmp_path, rcnn_pair):
    """A PillarNet checkpoint into PillarRCNN's `single_det`, with one
    leaf left out, one extra and one of another shape: the model equals
    the JAX package's result tensor for tensor, and each report list
    names the same leaves."""
    import orbax.checkpoint as ocp

    (rcfg, rvars, rport), (_, svars, sport) = _ports(rcnn_pair)
    src = copy.deepcopy(svars)
    del src["params"]["head_net"]["task0"]["hm_out"]["bias"]
    src["params"]["extra"] = {"kernel": np.ones((3, 2), np.float32)}
    dense = src["params"]["reader_net"]["pfn_dense_0"]
    dense["kernel"] = np.zeros((dense["kernel"].shape[0] + 1,
                                dense["kernel"].shape[1]), np.float32)
    ocp.PyTreeCheckpointer().save(str(tmp_path / "jax_src"), src)
    want_vars, want = jload_pretrained(rvars, str(tmp_path / "jax_src"),
                                       subtree="single_det")

    state = sport.state_dict()
    del state["head_net.task0.hm_out.bias"]
    state["extra.weight"] = torch.ones(2, 3)
    w = state["reader_net.pfn_dense_0.weight"]
    state["reader_net.pfn_dense_0.weight"] = torch.zeros(w.shape[0],
                                                         w.shape[1] + 1)
    torch.save({"model": state, "optimizer": {}, "meta": {}},
               tmp_path / "src.pth")
    got = load_pretrained(rport, str(tmp_path / "src.pth"),
                          subtree="single_det")

    expect = convert.load_jax_variables(build_model_from_cfg(rcfg, "cpu"),
                                        want_vars).state_dict()
    for k, v in rport.state_dict().items():
        assert torch.equal(v, expect[k]), k
    rnames, snames = _path_names(rport), _path_names(sport)
    assert sorted(got["loaded"]) == sorted(rnames[p] for p in want["loaded"])
    assert sorted(got["missing"]) == sorted(rnames[p]
                                            for p in want["missing"])
    # a leaf of another shape is also missing: nothing filled it
    assert sorted(got["missing"]) == [
        "single_det.head_net.task0.hm_out.bias",
        "single_det.reader_net.pfn_dense_0.weight"]
    assert got["shape_mismatch"] == ["reader_net.pfn_dense_0.weight"]
    assert [snames[p] for p in want["shape_mismatch"]] == \
        got["shape_mismatch"]
    assert got["unexpected"] == ["extra.weight"]
    assert want["unexpected"] == ["params/extra/kernel"]
    assert len(got["loaded"]) == len(state) - 2


def test_apply_pretrained_reads_the_config_and_warns_on_a_missing_file(
        tmp_path, caplog, rcnn_pair):
    """`first_stage_cfg.pretrained` names a trainer checkpoint of the
    first stage: `single_det` takes it; `pretrained` naming no file, or a
    reference state_dict for the first stage, logs a warning and leaves
    the model as it was."""
    (rcfg, _, rport), (scfg, _, sport) = _ports(rcnn_pair)
    save_checkpoint(str(tmp_path), sport,
                    optimizer_from_cfg(sport, scfg, 4), 1, {"epoch": 1})
    model_cfg = copy.deepcopy(rcfg["model"])
    model_cfg["first_stage_cfg"]["pretrained"] = str(tmp_path / "epoch_1.pth")
    apply_pretrained(rport, model_cfg)
    for k, v in sport.state_dict().items():
        assert torch.equal(rport.state_dict()["single_det." + k], v), k

    before = {k: v.clone() for k, v in rport.state_dict().items()}
    torch.save(sport.state_dict(), tmp_path / "bare.pth")
    model_cfg = dict(rcfg["model"], pretrained=str(tmp_path / "none.pth"))
    model_cfg["first_stage_cfg"] = dict(model_cfg["first_stage_cfg"],
                                        pretrained=str(tmp_path / "bare.pth"))
    with caplog.at_level(logging.WARNING):
        apply_pretrained(rport, model_cfg, logging.getLogger("pretrained"))
    warned = [r.getMessage() for r in caplog.records
              if r.levelname == "WARNING"]
    assert len(warned) == 2 and all("no pretrained model" in w
                                    for w in warned), warned
    for k, v in rport.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_a_reference_checkpoint_loads_non_strict(tmp_path):
    """`model.pretrained` naming a reference det3d `.pth` that lacks three
    leaves: the model equals what the JAX package's non-strict conversion
    (`convert_state_dict(strict=False)` onto the model's variables) makes
    of it, so the missing leaves keep the model's values; and
    `convert.variables_of` inverts `load_jax_variables` exactly."""
    cfg = load_config(DEMO)
    jm = build_jax_detector(copy.deepcopy(cfg["model"]),
                            train_cfg=cfg["train_cfg"],
                            test_cfg=cfg["test_cfg"])
    v = jax.tree_util.tree_map(np.array, random_variables(
        jm, 51, jnp.zeros((1, 64, 5)), jnp.ones((1, 64), bool),
        train=False))
    port = convert.load_jax_variables(build_model_from_cfg(cfg, "cpu"), v)
    back = convert.variables_of(port)
    flat = jax.tree_util.tree_flatten_with_path
    assert [p for p, _ in flat(back)[0]] == [p for p, _ in flat(v)[0]]
    for (p, a), (_, b) in zip(flat(back)[0], flat(v)[0]):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))

    rng = np.random.RandomState(2)
    sd = {k: (rng.randn(*shape) * 0.1).astype(np.float32)
          for _, (k, shape) in jconv.expected_source_keys(v).items()}
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = np.abs(sd[k]) + 0.5
    for k in sorted(sd)[:3]:
        del sd[k]
    want, rep = jconv.convert_state_dict(sd, v, strict=False)
    assert len(rep["missing"]) == 3
    torch.save({"state_dict": {k: torch.from_numpy(x) for k, x in
                               sd.items()}}, tmp_path / "ref.pth")
    apply_pretrained(port, dict(cfg["model"],
                                pretrained=str(tmp_path / "ref.pth")))
    expect = convert.load_jax_variables(build_model_from_cfg(cfg, "cpu"),
                                        want).state_dict()
    for k, t in port.state_dict().items():
        assert torch.equal(t, expect[k]), k


# ---- precise BN -------------------------------------------------------------

@struct.dataclass
class _State:
    params: dict
    batch_stats: dict


class _JittedTrainApply:
    """A flax module whose train-mode `apply` is jitted (the JAX
    package's `batch_stats_for` calls it eagerly)."""

    def __init__(self, module):
        self._f = jax.jit(lambda v, p, m, rngs: module.apply(
            v, p, m, train=True, mutable=["batch_stats"], rngs=rngs))

    def apply(self, v, p, m, train, mutable, rngs):
        assert train and mutable == ["batch_stats"]
        return self._f(v, p, m, rngs)


def test_recompute_batch_stats_matches_jax():
    """pillarnet18_demo, two batches of two demo scenes: the port's
    precise statistics against the JAX forward's own batch statistics
    and against the JAX package's `recompute_batch_stats` (tolerances in
    the module docstring); the model stays in eval mode and its weights
    are untouched."""
    cfg = load_config(DEMO)
    ds = DemoDataset(num_frames=4, num_points=4096,
                     pc_range=cfg["point_cloud_range"],
                     class_names=cfg["class_names"], seed=3,
                     pipeline=[dict(type="Reformat")], test_mode=True)
    batches = [collate_batch([ds[2 * i], ds[2 * i + 1]], 8192)
               for i in range(2)]
    jm = build_jax_detector(copy.deepcopy(cfg["model"]),
                            train_cfg=cfg["train_cfg"],
                            test_cfg=cfg["test_cfg"])
    jb = [{"points": jnp.asarray(b["points"]),
           "points_mask": jnp.asarray(b["points_mask"])} for b in batches]
    v = jax.tree_util.tree_map(np.array, random_variables(
        jm, 5, jb[0]["points"], jb[0]["points_mask"], train=False))
    jitted = _JittedTrainApply(jm)
    want = jprecise.recompute_batch_stats(
        jitted, _State(v["params"], v["batch_stats"]), jb).batch_stats

    # the JAX forward's own statistics: B = R0 + (R1 - R0) / m, in f64
    m = 0.01
    own = None
    for b in jb:
        _, r1 = jitted.apply(v, b["points"], b["points_mask"], True,
                             ["batch_stats"],
                             {"dropout": jax.random.PRNGKey(0),
                              "sampler": jax.random.PRNGKey(1)})
        step = jax.tree_util.tree_map(
            lambda r0, r: np.float64(r0) + (np.float64(r) - r0) / m,
            v["batch_stats"], r1["batch_stats"])
        own = step if own is None else jax.tree_util.tree_map(
            np.add, own, step)
    own = jax.tree_util.tree_map(lambda x: x / len(jb), own)

    port = convert.load_jax_variables(build_model_from_cfg(cfg, "cpu"), v)
    weights = {k: p.detach().clone() for k, p in port.named_parameters()}
    recompute_batch_stats(port, [batch_to_device(b, "cpu") for b in batches])
    assert not port.training
    for k, p in port.named_parameters():
        assert torch.equal(p, weights[k]), k

    def as_port(stats):
        return convert.load_jax_variables(
            build_model_from_cfg(cfg, "cpu"),
            {"params": v["params"], "batch_stats": jax.tree_util.tree_map(
                lambda x: np.asarray(x, np.float32), stats)}).state_dict()

    got = port.state_dict()
    r0, own_sd, want_sd = as_port(v["batch_stats"]), as_port(own), \
        as_port(want)
    eps, n = float(np.finfo(np.float32).eps), 0
    for k in got:
        if not k.endswith(("running_mean", "running_var")):
            continue
        scale = r0[k].abs() + own_sd[k].abs()
        assert ((got[k] - own_sd[k]).abs() <= 1e-4 * scale + 1e-6).all(), k
        assert ((got[k] - want_sd[k]).abs()
                <= 8 * eps * scale / m ** 2 + 1e-6).all(), k
        assert not torch.equal(got[k], r0[k]), k
        n += 1
    assert n > 20


# ---- the CLI ----------------------------------------------------------------

@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port's CPU work here: the suite runs in
    several processes on few cores, where torch's thread pools crowd each
    other out."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# the demo config with a small train set: 2 frames of 1,024 points in one
# batch, one loader thread, two epochs (one step each)
_SMALL = ("data['train'] = dict(data['train'], num_frames=2, "
          "num_points=1024)\n"
          "data.update(samples_per_gpu=2, workers_per_gpu=1, "
          "max_points=2048)\n"
          "total_epochs = 2\n")


def _config(path, *lines):
    """A config file at `path` that runs the demo config, then `lines`."""
    path.write_text(f"exec(open({DEMO!r}).read())\n" + "".join(lines))
    return str(path)


def _cli(*args):
    return train_cli.main([*map(str, args), "--device", "cpu"])


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The CLI on the small demo config: run `a` (two epochs, seed 7),
    `b` resumed from a's first checkpoint, `c` resumed from a's last, and
    `pre`, one epoch of a config whose `model.pretrained` is a's last
    checkpoint."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg = _config(tmp / "small.py", _SMALL)
    pre = _config(tmp / "pre.py", _SMALL, "total_epochs = 1\n",
                  f"model['pretrained'] = "
                  f"{str(tmp / 'a' / 'epoch_2.pth')!r}\n")
    runs = {"cfg": cfg, "tmp": tmp}
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs["a"] = _cli(cfg, "--work_dir", tmp / "a", "--seed", 7)
        runs["b"] = _cli(cfg, "--work_dir", tmp / "b", "--seed", 7,
                         "--resume_from", tmp / "a" / "epoch_1.pth")
        runs["c"] = _cli(cfg, "--work_dir", tmp / "c", "--resume_from",
                         tmp / "a" / "epoch_2.pth")
        runs["pre"] = _cli(pre, "--work_dir", tmp / "pre", "--seed", 4)
    finally:
        torch.set_num_threads(before)
    return runs


def test_cli_trains_writes_its_artifacts_and_resumes(cli_runs):
    """Two epochs of the demo config with its augmentations: the artifacts
    of the JAX package's recipe (config snapshot, train.log, log.json with
    finite losses, a checkpoint an epoch, `latest`); the run resumed from
    epoch 1 ends with epoch 2's weights and optimizer state of the
    uninterrupted run; resuming the last epoch runs nothing."""
    a, b, c = cli_runs["a"], cli_runs["b"], cli_runs["c"]
    work = cli_runs["tmp"] / "a"
    assert sorted(os.listdir(work)) == ["config.py", "epoch_1.pth",
                                        "epoch_2.pth", "latest", "log.json",
                                        "train.log"]
    assert (work / "config.py").read_text() == open(cli_runs["cfg"]).read()
    assert (work / "latest").read_text() == "epoch_2.pth"
    log = (work / "train.log").read_text()
    assert "model parameters" in log and "Epoch [2/2][1/1]" in log
    records = [eval(line) for line in  # noqa: S307 (our own json lines)
               (work / "log.json").read_text().splitlines()]
    assert len(records) == 2
    assert all(math.isfinite(r["loss"]) for r in records)

    assert (a.epoch, a.iter, b.epoch, b.iter) == (2, 2, 2, 2)
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in sa["state"].items():
        for k in st:
            assert torch.equal(st[k], sb["state"][i][k])
    assert (c.epoch, c.iter) == (2, 2)
    assert not os.path.exists(cli_runs["tmp"] / "c" / "epoch_3.pth")


def test_cli_takes_the_config_pretrained_weights(cli_runs):
    """`model.pretrained` naming a checkpoint of the trainer loads every
    tensor of it before the first step."""
    log = (cli_runs["tmp"] / "pre" / "train.log").read_text()
    n = len(cli_runs["a"].model.state_dict())
    assert f"loaded {n} tensors into /" in log and "init weight from" in log


def test_cli_without_a_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main([DEMO, "--work_dir", str(tmp_path)])


def test_two_epochs_leave_the_raw_frames_untouched(tmp_path, monkeypatch):
    """Two epochs of the demo config with its augmentations: each frame
    enters `Preprocess` in epoch 2 as it did in epoch 1 (nothing the
    dataset holds was changed in place), the ground truth the dataset
    hands over (`info`) is untouched, and the augmented clouds differ
    between the epochs (each epoch draws anew)."""
    raw, out, infos = {}, {}, {}
    call = tpre.Preprocess.__call__

    def recording(self, res, info):
        key = res["metadata"]["token"]
        raw.setdefault(key, []).append(
            (res["lidar"]["combined"].copy(),
             res["lidar"]["annotations"]["boxes"].copy()))
        infos.setdefault(key, []).append((info["gt_boxes"],
                                          info["gt_boxes"].copy()))
        res, info = call(self, res, info)
        out.setdefault(key, []).append(res["lidar"]["points"].copy())
        return res, info

    monkeypatch.setattr(tpre.Preprocess, "__call__", recording)
    cfg = load_config(DEMO)
    cfg["total_epochs"] = 2
    cfg["data"] = dict(cfg["data"], samples_per_gpu=2, workers_per_gpu=1,
                       max_points=2048)
    cfg["data"]["train"] = dict(cfg["data"]["train"], num_frames=4,
                                num_points=1024)
    from pillarnet_lts_torch.datasets import build_dataset
    ds = build_dataset(cfg["data"]["train"])
    train_detector(build_model_from_cfg(cfg, "cpu"), ds, cfg,
                   work_dir=str(tmp_path), seed=5)
    assert len(raw) == 4
    for key, frames in raw.items():
        assert len(frames) == 2, key
        for a, b in zip(frames[0], frames[1]):
            np.testing.assert_array_equal(a, b)
        for kept, copied in infos[key]:
            np.testing.assert_array_equal(kept, copied)
        assert not np.array_equal(out[key][0], out[key][1])


def test_training_cli_imports_no_jax(tmp_path):
    """The CLI on the demo config as written (its artifacts, then the
    resume probe, which restores epoch 1 and runs nothing), the GT
    database of a small Waymo set,
    a GT-AUG sample of pillarrcnn18_waymo's train pipeline, precise BN,
    the TensorBoard hook and a pretrained load, in a process that loads
    no JAX module."""
    code = (
        "import copy, os, sys\n"
        "from pillarnet_lts_torch.apis import apply_pretrained, load_config\n"
        "from pillarnet_lts_torch.datasets import (DemoDataset, "
        "WaymoDataset, collate_batch)\n"
        "from pillarnet_lts_torch.datasets.synth import write_waymo_set\n"
        "from pillarnet_lts_torch.datasets.utils import "
        "create_groundtruth_database\n"
        "from pillarnet_lts_torch.runtime.hooks import "
        "TensorboardLoggerHook\n"
        "from pillarnet_lts_torch.runtime.precise_bn import "
        "recompute_batch_stats\n"
        "from pillarnet_lts_torch.runtime.train_step import "
        "batch_to_device\n"
        "from pillarnet_lts_torch.tools import train\n"
        "work = sys.argv[1]\n"
        "demo = 'configs/demo/pillarnet18_demo.py'\n"
        "run = os.path.join(work, 'run')\n"
        "tr = train.main([demo, '--work_dir', run, '--device', 'cpu'])\n"
        "assert tr.iter == 1\n"
        "assert sorted(os.listdir(run)) == ['config.py', 'epoch_1.pth',\n"
        "    'latest', 'log.json', 'train.log'], os.listdir(run)\n"
        "again = train.main([demo, '--work_dir', run, '--device', 'cpu',\n"
        "                    '--resume_from', os.path.join(run,\n"
        "                                                  'epoch_1.pth')])\n"
        "assert (again.epoch, again.iter) == (1, 1)\n"
        "cfg = load_config(demo)\n"
        "apply_pretrained(tr.model, dict(cfg['model'], pretrained=\n"
        "    os.path.join(work, 'run', 'epoch_1.pth')))\n"
        "ds = DemoDataset(num_frames=2, num_points=2048, test_mode=True,\n"
        "    pc_range=cfg['point_cloud_range'],\n"
        "    pipeline=[dict(type='Reformat')])\n"
        "recompute_batch_stats(tr.model, [batch_to_device(\n"
        "    collate_batch([ds[0], ds[1]], 4096), 'cpu')])\n"
        "TensorboardLoggerHook()\n"
        "rc = load_config('configs/pillarrcnn/pillarrcnn18_waymo.py')\n"
        "root = os.path.join(work, 'waymo')\n"
        "info = write_waymo_set(root, 2, 3000, rc['class_names'],\n"
        "    rc['point_cloud_range'], split='train', class_counts=(4, 2, 1))\n"
        "db = os.path.join(root, 'db.pkl')\n"
        "create_groundtruth_database('WaymoDataset', root, info,\n"
        "    used_classes=rc['class_names'], dbinfo_path=db)\n"
        "pipe = copy.deepcopy(rc['train_pipeline'])\n"
        "pipe[2]['cfg']['db_sampler']['db_info_path'] = db\n"
        "ws = WaymoDataset(info, root, pipeline=pipe,\n"
        "                  class_names=rc['class_names'])\n"
        "batch = collate_batch([ws[0], ws[1]], 8192)\n"
        "assert (batch['gt_boxes_and_cls'][:, :, 3] > 0).sum() > 14\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'pillarnet_lts_tpu')]\n"
        "assert not bad, bad\n"
        "print('no-jax ok')\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ,
                                               OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "no-jax ok" in out.stdout
