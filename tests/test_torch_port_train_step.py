"""PyTorch port, whole training steps: the first step's gradients leaf by
leaf and three steps of the demo config in both packages from one JAX
variables tree, remat on against off, and a trainer's checkpoint round
trip.

Both packages start from one JAX variables tree (the JAX package's
initialisers, BN affines and running statistics redrawn so that a wrong
one shows), carried to the port by `load_jax_variables`, with fresh
optimizer states; each takes three steps on the same three collated
batches of the port's synthetic scenes (batch 2). The JAX package runs
its own jitted train step (`parallel/train_step.py`) with the scatter's
TPU gradient (`test_torch_port_train.py::tpu_vjp_scatter`, patched into
its reader for the module). Its updated variables come back through
`load_jax_variables` for the comparison.

Tolerances. The first step's gradients: every parameter leaf within
1e-3 of JAX's in norm, the JAX package's ReLUs taking the port's
decisions (`test_first_step_gradients_match_jax_leaf_by_leaf`). The first
step starts from one state in both packages: every loss within rtol 1e-4
and `grad_norm` within 1e-3; the running statistics within rtol = atol =
1e-4; at least 99.5% of the updated parameters within
rtol = atol = 1e-4, and every one within two first Adam steps (2 lr) of
JAX's (`chip_smoke.py::params_within_first_adam_step`, which phase 13
holds the card to against the CPU). Adam's first step is lr * g / (|g| +
eps), about lr * sign(g): a parameter whose gradient lies within the two
packages' rounding of 0 (0.05% of the demo model's) steps the other way.
The conv biases that a training-mode BN follows
(`runtime.train_step.bn_shifted_biases`) are all such: their gradient is
0 in exact arithmetic.

From there the trajectories part as the JAX package's own do when XLA
compiles its train step another way (`xla_disable_hlo_passes=fusion`,
which rounds each f32 operation alone): the two JAX builds differ by
1.5e-3 in the first `grad_norm` and 3.6e-2 in the third, and after three
steps 23% of the parameters by more than 1e-4. So over the three steps
the port is held to that spread, measured in the same run: per step, the
largest relative difference of any metric from JAX at most twice the
largest between the two JAX builds (or 1e-4), and the share of parameters
(and of running statistics) beyond rtol = atol = 1e-4 at most twice
theirs (or 0.5%).
"""

import copy
import os
import types

import numpy as np
import pytest
import torch

import flax.linen
import jax

from pillarnet_lts_tpu.models import build_detector as build_jax_detector
from pillarnet_lts_tpu.models.readers import dynamic_pillar_encoder as jdpe
from pillarnet_lts_tpu.parallel.collate import collate_batch as jax_collate
from pillarnet_lts_tpu.parallel.train_state import TrainState
from pillarnet_lts_tpu.parallel.train_step import make_train_step
from pillarnet_lts_tpu.solver import build_optimizer as jax_build_optimizer
from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                      optimizer_from_cfg, train_detector)
from pillarnet_lts_torch.datasets import SynthDataset, collate_batch
from pillarnet_lts_torch.models.backbones import base as tbase
from pillarnet_lts_torch.models.bbox_heads import center_head as thead
from pillarnet_lts_torch.models.necks import rpn as trpn
from pillarnet_lts_torch.models.readers import dynamic_pillar_encoder as tdpe
from pillarnet_lts_torch.runtime.convert import load_jax_variables
from pillarnet_lts_torch.runtime.train_step import (batch_to_device,
                                                    bn_shifted_biases,
                                                    step_losses, train_step)
from chip_smoke import params_within_first_adam_step
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_torch_port_train import DEMO, tpu_vjp_scatter

STEPS = 3
TOTAL_STEPS = 10  # the schedule's length: the steps stay in the warm-up
BATCH = 2
N_POINTS = 4096
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(remat=False):
    cfg = load_config(DEMO)
    cfg["model"]["backbone"] = dict(cfg["model"]["backbone"], remat=remat)
    return cfg


def _batches(cfg):
    ds = SynthDataset(cfg, STEPS * BATCH, N_POINTS, seed=21)
    examples = [ds[i] for i in range(len(ds))]
    return [examples[i * BATCH:(i + 1) * BATCH] for i in range(STEPS)]


def _jax_variables(jmodel, batch):
    variables = jax.jit(lambda p, m: jmodel.init(
        jax.random.PRNGKey(3), p, m, train=False))(batch["points"],
                                                   batch["points_mask"])
    variables = jax.tree_util.tree_map(np.array, variables)
    rng = np.random.RandomState(8)

    def redraw(path, v):
        name = path[-1].key
        if path[0].key == "batch_stats":
            return (rng.normal(0, 0.2, v.shape) if name == "mean"
                    else rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return v

    return jax.tree_util.tree_map_with_path(redraw, variables)


def _jax_state(state):
    return {"params": jax.tree_util.tree_map(np.array, state.params),
            "batch_stats": jax.tree_util.tree_map(np.array,
                                                  state.batch_stats)}


def run_both_packages():
    """STEPS steps of the demo config in both packages from one state, and
    in the JAX package compiled without XLA's fusion pass."""
    cfg = _cfg()
    batches = _batches(cfg)
    jbatches = []
    for examples in batches:
        b = jax_collate(examples, max_points=cfg["data"]["max_points"])
        b.pop("metadata")
        jbatches.append(b)
    jmodel = build_jax_detector(copy.deepcopy(cfg["model"]),
                                train_cfg=cfg["train_cfg"],
                                test_cfg=cfg["test_cfg"])
    variables = _jax_variables(jmodel, jbatches[0])

    jax_runs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdpe, "pillar_scatter_max", tpu_vjp_scatter)
        tx = jax_build_optimizer(cfg["optimizer"], cfg["lr_config"],
                                 TOTAL_STEPS, grad_clip_norm=35.0)
        fn = make_train_step(jmodel, tx, cfg["train_cfg"])
        for options in (None, {"xla_disable_hlo_passes": "fusion"}):
            state = TrainState.create(variables, tx)
            step = jax.jit(fn).lower(state, jbatches[0]).compile(
                compiler_options=options)
            metrics, states = [], []
            for b in jbatches:
                state, m = step(state, b)
                metrics.append(jax.tree_util.tree_map(np.asarray, m))
                states.append(_jax_state(state))
            jax_runs.append((metrics, states))

    model = build_model_from_cfg(cfg, device="cpu")
    load_jax_variables(model, variables)
    opt = optimizer_from_cfg(model, cfg, TOTAL_STEPS)
    tmetrics, tstates = [], []
    for examples in batches:
        batch = collate_batch(examples, cfg["data"]["max_points"])
        m = train_step(model, opt, batch_to_device(batch, "cpu"),
                       cfg["train_cfg"])
        tmetrics.append({k: v.numpy() for k, v in m.items()})
        tstates.append({k: v.clone() for k, v in model.state_dict().items()})
    return dict(cfg=cfg, jax=jax_runs[0], jax_nofusion=jax_runs[1],
                port=(tmetrics, tstates), model=model, lr0=opt.lr_fn(0))


@pytest.fixture(scope="module")
def both_packages():
    return run_both_packages()


def _as_port(cfg, jstate):
    """A JAX variables tree as the port's state dict, in numpy."""
    m = build_model_from_cfg(cfg, device="cpu")
    load_jax_variables(m, jstate)
    return {k: v.numpy() for k, v in m.state_dict().items()}


def _share_beyond(got, ref, keys):
    """Share of the elements of `keys` beyond rtol = atol = 1e-4."""
    bad = sum(int((np.abs(got[k] - ref[k]) > 1e-4 + 1e-4 * np.abs(ref[k]))
                  .sum()) for k in keys)
    return bad / sum(ref[k].size for k in keys)


def test_first_step_matches_jax(both_packages):
    bp = both_packages
    cfg, model = bp["cfg"], bp["model"]
    jm, tm = bp["jax"][0][0], bp["port"][0][0]
    assert set(tm) == set(jm)
    assert {"loss", "grad_norm", "hm_loss_task1", "iou_loss_task0",
            "reg_iou_loss_task1", "num_positive_task0"} <= set(tm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], err_msg=k, atol=0,
                                   rtol=1e-3 if k == "grad_norm" else 1e-4)

    want = {k: torch.from_numpy(v)
            for k, v in _as_port(cfg, bp["jax"][1][0]).items()}
    got = bp["port"][1][0]
    params = [n for n, _ in model.named_parameters()]
    shifted = set(bn_shifted_biases(model))
    assert shifted and shifted <= set(params)
    params_within_first_adam_step(torch, got, want, params, shifted,
                                  bp["lr0"])
    for k in set(want) - set(params):
        torch.testing.assert_close(got[k], want[k], **TOL)


class _RecordingF(types.ModuleType):
    """torch.nn.functional whose relu records its decisions (x > 0)."""

    def __init__(self, decisions):
        super().__init__("F")
        self.decisions = decisions

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    def relu(self, x):
        self.decisions.append((x > 0).detach().numpy())
        return torch.nn.functional.relu(x)


def _as_jax_layout(decision, shape):
    """A port ReLU decision (NCHW maps, (B, N, C) point rows) in the JAX
    package's layout: NHWC, space-to-depth packed where its stage 1 is."""
    if decision.ndim == 4:
        decision = decision.transpose(0, 2, 3, 1)
        if decision.shape != tuple(shape):
            b, h, w, c = decision.shape
            decision = decision.reshape(b, h // 2, 2, w // 2, 2, c).transpose(
                0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    assert decision.shape == tuple(shape), (decision.shape, shape)
    return decision


def first_step_gradients():
    """The first step's gradients of both packages from one JAX variables
    tree on one batch, as port-named numpy dicts: the port's `.grad` after
    its training forward and backward, and jax.grad of the JAX package's
    training loss (`parallel/train_step.py::loss_fn`) with every ReLU
    taking the port's decision (`test_first_step_gradients_match_jax_leaf_
    by_leaf`)."""
    cfg = _cfg()
    examples = _batches(cfg)[0]
    jb = jax_collate(examples, max_points=cfg["data"]["max_points"])
    jb.pop("metadata")
    jmodel = build_jax_detector(copy.deepcopy(cfg["model"]),
                                train_cfg=cfg["train_cfg"],
                                test_cfg=cfg["test_cfg"])
    variables = _jax_variables(jmodel, jb)

    decisions = []
    model = load_jax_variables(build_model_from_cfg(cfg, device="cpu"),
                               variables)
    batch = batch_to_device(collate_batch(examples, cfg["data"]["max_points"]),
                            "cpu")
    with pytest.MonkeyPatch.context() as mp:
        for mod in (tbase, tdpe, trpn, thead):
            mp.setattr(mod, "F", _RecordingF(decisions))
        total, _ = step_losses(model, batch, cfg["train_cfg"])
        total.backward()
    port = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}

    taken = []

    def relu_as_the_port(x):
        decision = _as_jax_layout(decisions[len(taken)], x.shape)
        taken.append(decision)
        return jax.numpy.where(decision, x, 0)

    def loss_fn(params):
        preds, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jb["points"], jb["points_mask"], train=True,
            mutable=["batch_stats"])
        total = jax.numpy.asarray(0.0, jax.numpy.float32)
        for task_loss in jmodel.loss(jb, preds, cfg["train_cfg"])["loss"]:
            total = total + task_loss
        return total

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdpe, "pillar_scatter_max", tpu_vjp_scatter)
        mp.setattr(flax.linen, "relu", relu_as_the_port)
        grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    assert len(taken) == len(decisions) > 0
    want = _as_port(cfg, {"params": jax.tree_util.tree_map(np.asarray, grads),
                          "batch_stats": variables["batch_stats"]})
    return want, port, set(bn_shifted_biases(model))


@pytest.fixture(scope="module")
def first_grads():
    return first_step_gradients()


@pytest.mark.parametrize("part", ["reader_net", "backbone_net", "neck_net",
                                  "head_net"])
def test_first_step_gradients_match_jax_leaf_by_leaf(first_grads, part):
    """Every parameter leaf's first-step gradient against jax.grad:
    ||g_port - g_jax|| <= 1e-3 ||g_jax|| per leaf, and no leaf's gradient
    zero. (Measured: at most 1.6e-4, where the JAX package's own builds,
    with and without XLA's fusion pass, differ by up to 2e-4.) The
    BN-shifted biases are left out: their gradient is 0 in exact
    arithmetic and rounding noise in both packages.

    The JAX package's ReLUs take the port's decisions (x > 0, recorded in
    the port's forward, in call order). Without that, the packages'
    forwards, ~1e-5 apart, put a few pre-ReLU values on opposite sides of
    0 (on this batch -6e-7 in the port's conv4 and -1.4e-5 in its neck's
    deconv branch); each such site sends its gradient (0.55, 0.076) down
    one package only and moves every leaf upstream of it by 1-4%. With the
    same decisions the JAX forward differs only by those ~1e-6 values."""
    want, got, shifted = first_grads
    names = [k for k in got if k.split(".")[0] == part and k not in shifted]
    assert names
    for k in names:
        ref = np.linalg.norm(want[k])
        assert ref > 0, k
        rel = np.linalg.norm(got[k] - want[k]) / ref
        assert rel <= 1e-3, (k, rel)


def _max_rel(a, b):
    return max(float(abs(a[k] - b[k]) / abs(b[k])) for k in b if b[k] != 0)


def test_three_steps_stay_within_the_jax_packages_own_spread(
        both_packages):
    bp = both_packages
    for step in range(STEPS):
        ref = bp["jax"][0][step]
        port = _max_rel(bp["port"][0][step], ref)
        spread = _max_rel(bp["jax_nofusion"][0][step], ref)
        assert port <= max(2 * spread, 1e-4), (step, port, spread)

    ref = _as_port(bp["cfg"], bp["jax"][1][-1])
    other = _as_port(bp["cfg"], bp["jax_nofusion"][1][-1])
    got = {k: v.numpy() for k, v in bp["port"][1][-1].items()}
    params = [n for n, _ in bp["model"].named_parameters()]
    buffers = [k for k in ref if k not in params]
    for keys in (params, buffers):
        port = _share_beyond(got, ref, keys)
        spread = _share_beyond(other, ref, keys)
        assert port <= max(2 * spread, 5e-3), (port, spread)


def test_remat_on_equals_remat_off():
    """One step of each from the same weights on the same batch: equal
    metrics, gradients, weights and running statistics, the latter moved
    once (the replay in the backward leaves them alone)."""
    results = []
    for remat in (False, True):
        cfg = _cfg(remat)
        model = build_model_from_cfg(cfg, device="cpu", seed=5)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        opt = optimizer_from_cfg(model, cfg, TOTAL_STEPS)
        batch = collate_batch(_batches(cfg)[0], cfg["data"]["max_points"])
        m = train_step(model, opt, batch_to_device(batch, "cpu"),
                       cfg["train_cfg"])
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        results.append((m, grads, model.state_dict(), before))
    (m0, g0, s0, b0), (m1, g1, s1, _) = results
    assert model.backbone_net.remat
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    bn = "backbone_net.conv1_block0.bn0."
    assert not torch.equal(s1[bn + "running_mean"], b0[bn + "running_mean"])


def test_trainer_resume_takes_the_same_next_steps(tmp_path):
    """Trainer A runs two epochs (checkpoint after each); trainer B, built
    from another seed, resumes A's first checkpoint and runs the second:
    its model, optimizer state and logged metrics equal A's."""
    cfg = _cfg()
    cfg["data"] = dict(cfg["data"], samples_per_gpu=BATCH)
    cfg["total_epochs"] = 2
    ds = SynthDataset(cfg, 2 * BATCH, N_POINTS, seed=4)
    a = train_detector(build_model_from_cfg(cfg, device="cpu", seed=1), ds,
                       cfg, work_dir=str(tmp_path / "a"), cfg_text="demo")
    first = os.path.join(str(tmp_path / "a"), "epoch_1.pth")
    b = train_detector(build_model_from_cfg(cfg, device="cpu", seed=2), ds,
                       cfg, work_dir=str(tmp_path / "b"), resume_from=first)
    assert (a.epoch, a.iter, b.epoch, b.iter) == (2, 4, 2, 4)
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["count"] == sb["count"] == 4
    for i, st in sa["state"].items():
        for k in st:
            assert torch.equal(st[k], sb["state"][i][k])
    for k, hist in b.log_buffer.val_history.items():
        if k not in ("time", "data_time"):
            assert hist == a.log_buffer.val_history[k][2:], k
    meta = torch.load(first, weights_only=True)["meta"]
    assert meta["config"] == "demo" and meta["CLASSES"] == cfg["class_names"]
    assert meta["epoch"] == 1 and meta["iter"] == 2
    with open(tmp_path / "a" / "latest") as f:
        assert f.read() == "epoch_2.pth"
