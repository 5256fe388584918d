"""PyTorch port, data-parallel training and sharded evaluation over
`torch.distributed` (`pillarnet_lts_torch/parallel/`), on the CPU: the
ranks are gloo processes on localhost with torchrun's environment
(`chip_smoke.spawn_ranks`, which kills every rank when one fails or the
join timeout, JOIN_TIMEOUT, passes; the training ranks' group start and
collectives time out on their own, `chip_smoke.DP_INIT_TIMEOUT`), on one
intra-op thread each.

- Two ranks x 2 frames of `pillarnet18_demo` and of `pillarrcnn18_demo`
  (`chip_smoke.dp_rank`, through `apis.train_detector`) against the
  port's one-process step on the same 4 frames (the ranks' rows in rank
  order), computed in the ranks' order (`chip_smoke.in_rank_order`:
  convs, matmuls and BN sums on each rank's rows apart), each of 2 steps
  from the state the ranks started it from (`chip_smoke.dp_reference`),
  held by `chip_smoke.check_dp_training`: the ranks bit-identical to one
  another; every loss within 1e-6 here (the check's 1e-5), and the plain
  one-process step's within 1e-4 (its total loss within 1e-5 here); the
  parameters, running statistics and gradients by module group within
  the stated tolerances or twice the one process's own spread under a
  1e-6 weight nudge (the phase-15c measure; the two-stage step moves its
  gradients by up to ~17% under such a nudge), a group's gradients never
  beyond 10%; dropout's draws and the sampled RoI labels and masks
  bit-equal to the one-process rows, the sampled RoIs within 1e-3 m (the
  proposing first stage normalizes with statistics summed over the
  ranks, in another order than one process sums them).
- The demo ranks' first step against one step of the JAX package's
  `make_train_step` jitted over a 2-device `make_mesh` with
  `shard_batch`, fed the JAX loader's first batch in its own order (the
  ranks' rows in rank order are that batch: a node's ranks take
  contiguous blocks of its batch), from the port's seeded weights
  (`variables_of`), with the tolerances `tests/test_torch_port_train_step.
  py` holds the port's one-process step to JAX; likewise the two-stage
  demo's ranks (dropout off, the sampler given the JAX package's draws
  from one key and boxes about the GT as proposals in both packages):
  their losses within the same tolerances and their sampled RoI targets
  equal to the JAX sampler's.
- Two ranks of the demo with the compact reader (`reader.compact_kmax`)
  against one process's step, as the dense demo.
- The loader's shards against the JAX `DataLoader`'s, and the ranks'
  blocks in rank order against the JAX loader's batches over 2 nodes of
  2 ranks; a plain process starts no group; the node's ranks split
  `samples_per_gpu`.
- `Trainer.val` over sharded val frames (3 frames: one rank's shard is
  wrap-padded) and `tools/dist_test` over 2 ranks: the merged detections
  equal the one-process run's, token for token; the training CLI over 2
  ranks writes its files once.
- Those checks reject a data-parallel step with a fault planted in its
  ranks: gradients averaged instead of summed, a BN whose sum over the
  ranks passes no gradient back to the other ranks, a loss normalized by
  the rank's own count.
"""

import contextlib
import copy
import importlib
import json
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

import jax

from pillarnet_lts_tpu.datasets.loader.build_loader import (
    DataLoader as JaxLoader)
from pillarnet_lts_tpu.datasets.waymo import waymo_eval as jwaymo
from pillarnet_lts_tpu.models import build_detector as build_jax_detector
from pillarnet_lts_tpu.models.detectors import pillar_rcnn as jrcnn
from pillarnet_lts_tpu.models.readers import dynamic_pillar_encoder as jdpe
from pillarnet_lts_tpu.parallel.collate import collate_batch as jax_collate
from pillarnet_lts_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from pillarnet_lts_tpu.parallel.train_state import TrainState
from pillarnet_lts_tpu.parallel.train_step import make_train_step
from pillarnet_lts_tpu.solver import build_optimizer as jax_build_optimizer
from pillarnet_lts_torch.apis import build_model_from_cfg, load_config
from pillarnet_lts_torch.datasets import DataLoader, build_dataset
from pillarnet_lts_torch.datasets.waymo import waymo_eval as twaymo
from pillarnet_lts_torch.parallel import dist, mesh
from pillarnet_lts_torch.runtime.checkpoint import load_checkpoint
from pillarnet_lts_torch.runtime.convert import (load_jax_variables,
                                                 variables_of)
from pillarnet_lts_torch.runtime.train_step import bn_shifted_biases
from pillarnet_lts_torch.runtime.trainer import Trainer
from pillarnet_lts_torch.tools import dist_test

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_torch_port_rcnn_train import jax_draws  # noqa: E402
from test_torch_port_train import tpu_vjp_scatter  # noqa: E402

POINTS = 4096
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
JOIN_TIMEOUT = 180  # s: the ranks still running then are killed
VAL_FRAMES = 3  # two ranks: rank 1's shard is wrap-padded with frame 0


@contextlib.contextmanager
def one_thread():
    """One intra-op thread, as the ranks run: a CPU conv's result may
    depend on how many threads split it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _spec(config, out, **kw):
    return cs.dp_spec(config, "cpu", str(out), points=POINTS, workers=1,
                      threads=1, **kw)


def _dp_run(tmp_path_factory, name, config, **kw):
    spec = _spec(config, tmp_path_factory.mktemp(name), **kw)
    ranks, _ = cs.run_dp_training(torch, spec, name, timeout=JOIN_TIMEOUT)
    with one_thread():
        ref = cs.dp_reference(torch, spec, torch.device("cpu"), ranks)
    return spec, ranks, ref, cs.check_dp_training(torch, name, ref, ranks)


@pytest.fixture(scope="module")
def demo_run(tmp_path_factory):
    return _dp_run(tmp_path_factory, "demo", cs.DEMO, val_frames=VAL_FRAMES,
                   spread=True)


@pytest.fixture(scope="module")
def rcnn_run(tmp_path_factory):
    return _dp_run(tmp_path_factory, "rcnn", cs.RCNN_DEMO, spread=True,
                   at_gt=True)


@pytest.fixture(scope="module")
def ffn_bf16_run(tmp_path_factory):
    return _dp_run(tmp_path_factory, "ffn_bf16", cs.RCNN_DEMO, spread=True,
                   at_gt=True, variant="RoIFFNHead", dtype="bfloat16")


@pytest.fixture(scope="module")
def compact_run(tmp_path_factory):
    return _dp_run(tmp_path_factory, "compact", cs.DEMO, spread=True,
                   compact_kmax=POINTS)


# ---- the loader's shards, the node's split, a plain process ---------------


@pytest.mark.parametrize("n", [7, 8])
@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_shards_equal_the_jax_loaders(n, shuffle):
    """Each rank's indices equal the JAX `DataLoader(num_shards=2,
    shard_index=r)`'s, and the shards together are the one-rank epoch
    (with a wrap-around duplicate where 2 does not divide it)."""
    data = list(range(n))
    one = DataLoader(data, 2, shuffle=shuffle, seed=5)._indices()
    shards = []
    for r in range(2):
        got = DataLoader(data, 1, shuffle=shuffle, seed=5, num_shards=2,
                         shard_index=r)._indices()
        want = JaxLoader(data, 1, shuffle=shuffle, seed=5, num_shards=2,
                         shard_index=r)._indices()
        np.testing.assert_array_equal(got, want)
        shards.append(got)
    union = np.concatenate(shards)
    assert set(union.tolist()) == set(one.tolist()) == set(range(n))
    assert len(union) == n + n % 2


@pytest.mark.parametrize("shuffle", [False, True])
def test_rank_blocks_in_rank_order_are_the_jax_batches(monkeypatch,
                                                        shuffle):
    """2 nodes of 2 ranks, `samples_per_gpu` 4, 19 frames: each rank's
    training loader (`mesh.train_shards`) loads 2 frames a step, and the
    4 ranks' rows in rank order are, step by step, the JAX loaders' batches
    of the 2 hosts (`num_shards=2`, batch 4) in host order: a node's
    ranks split its batch contiguously, as the JAX mesh splits a
    host's."""
    data = list(range(19))
    monkeypatch.setattr(dist, "process_count", lambda: 4)
    monkeypatch.setattr(dist, "local_process_count", lambda: 2)
    per = mesh.rank_batch_size(4)
    ranks = []
    for r in range(4):
        monkeypatch.setattr(dist, "rank", lambda r=r: r)
        ranks.append(DataLoader(data, per, shuffle=shuffle, seed=5,
                                **mesh.train_shards()).batches())
    hosts = []
    for h in range(2):
        idx = JaxLoader(data, 4, shuffle=shuffle, seed=5, num_shards=2,
                        shard_index=h)._indices()
        hosts.append([idx[b * 4:(b + 1) * 4] for b in range(len(idx) // 4)])
    assert len(ranks[0]) == len(hosts[0]) == 2
    for step in range(2):
        got = np.concatenate([rows[step] for rows in ranks])
        np.testing.assert_array_equal(
            got, np.concatenate([h[step] for h in hosts]))


def test_samples_per_gpu_splits_over_the_nodes_ranks(monkeypatch):
    assert mesh.rank_batch_size(4) == 4
    monkeypatch.setattr(dist, "local_process_count", lambda: 2)
    assert mesh.rank_batch_size(4) == 2
    with pytest.raises(ValueError, match="does not split"):
        mesh.rank_batch_size(3)


def test_a_plain_process_starts_no_group(monkeypatch):
    """Without torchrun's environment `init_from_env` starts nothing and
    every helper is the identity."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert dist.init_from_env("cpu") == torch.device("cpu")
    assert not dist.is_initialized() and not dist.launched()
    assert (dist.process_count(), dist.rank(),
            dist.local_process_count()) == (1, 0, 1)
    t = torch.arange(3.0, requires_grad=True)
    assert dist.sum_over_ranks(t) is t and dist.sum_with_grad(t) is t
    assert dist.all_gather_objects({"a": 1}) == [{"a": 1}]
    dist.barrier()
    t.grad = torch.ones(3)
    dist.sum_gradients_over_ranks([t])
    assert torch.equal(t.grad, torch.ones(3))
    g = torch.Generator().manual_seed(0)
    u = mesh.rank_rows(lambda size: torch.rand(size, generator=g), 2, 3)
    assert torch.equal(u, torch.rand(2, 3, generator=torch.Generator()
                                     .manual_seed(0)))
    assert mesh.rank_slice(4) == slice(0, 4)
    model = torch.nn.Linear(2, 2)
    before = copy.deepcopy(model.state_dict())
    assert mesh.replicate(model) is model
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())
    assert dist.merge_detection_dicts([{"a": 1}, {"a": 1, "b": 2}]) == {
        "a": 1, "b": 2}


# ---- two ranks against one process ----------------------------------------


@pytest.mark.parametrize("step", [0, 1])
def test_demo_ranks_step_as_one_process(demo_run, step):
    spec, ranks, ref, out = demo_run
    rec = out["steps"][step]
    assert rec["metrics_rel_plain"]["loss"] <= 1e-5
    assert max(v for k, v in rec["metrics_rel"].items()
               if "loss" in k) <= 1e-6
    assert {"hm_loss_task1", "iou_loss_task0", "reg_iou_loss_task1",
            "num_positive_task0"} <= set(ranks[0]["metrics"][step])
    assert [rk["rank"] for rk in ranks] == [0, 1]
    assert all(rk["world"] == 2 for rk in ranks)


@pytest.mark.parametrize("step", [0, 1])
def test_compact_ranks_step_as_one_process(compact_run, step):
    """The demo with the compact reader (`reader.compact_kmax` = the
    cloud's 4096 points: conv1 and conv2 as gather convs over each rank's
    active sites, the masked BN's sums over the ranks' compact rows)
    against one process on the same batch, as the dense demo."""
    spec, ranks, ref, out = compact_run
    cfg, _, model = cs.dp_setup(torch, spec, "cpu")
    assert model.reader_net.compact_kmax == POINTS
    rec = out["steps"][step]
    assert rec["metrics_rel_plain"]["loss"] <= 1e-5
    assert max(v for k, v in rec["metrics_rel"].items()
               if "loss" in k) <= 1e-6
    assert max(rec["grad_bound_by_group"].values()) <= 0.1


def test_demo_ranks_train_their_shards(demo_run):
    """Each rank loads 2 frames a step, its shard of each global batch,
    and the checkpoint rank 0 wrote holds the ranks' last state."""
    spec, ranks, ref, _ = demo_run
    cfg = load_config(cs.DEMO)
    ckpt = os.path.join(spec["out"], "work", "epoch_1.pth")
    model = build_model_from_cfg(cfg, device="cpu")
    meta = load_checkpoint(ckpt, model)
    assert meta["iter"] == spec["steps"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, ranks[1]["states"][-1][k]), k
    rows = cs.dp_rows(range(spec["batch"] * spec["steps"]), spec)
    assert sorted(sum(rows, [])) == list(range(8))
    with open(os.path.join(spec["out"], "work", "log.json")) as f:
        logged = [json.loads(line) for line in f]
    assert [r["iter"] for r in logged] == [0, 1]
    assert [r["loss"] for r in logged] == [
        m["loss"] for m in ranks[0]["metrics"]]


def test_val_over_ranks_gathers_every_frame_once(demo_run):
    """`Trainer.val` on each rank's shard of 3 val frames (batches of 2):
    rank 0 returns the merged detections (frame 0 once, though both ranks
    served it) and the result, rank 1 the merged detections and None.
    Equal to one process serving the same batches (a CPU conv's result
    moves with the batch size, ~1e-5 m between 1 and 2 frames) on the
    same checkpoint, and so is the score."""
    spec, ranks, _, _ = demo_run
    (dets0, result0), (dets1, result1) = ranks[0]["val"][0], \
        ranks[1]["val"][0]
    assert result1 is None and result0 is not None
    assert sorted(dets0) == sorted(dets1) == [
        f"demo_{i}" for i in range(VAL_FRAMES)]
    cfg, _, model = cs.dp_setup(torch, spec, "cpu")
    load_checkpoint(os.path.join(spec["out"], "work", "epoch_1.pth"), model)
    val_ds = build_dataset(cfg["data"]["val"])
    trainer = Trainer(model, None, cfg["train_cfg"],
                      os.path.join(spec["out"], "one"))
    want = {}
    with one_thread():
        for r in range(2):
            want.update(trainer.val(DataLoader(
                val_ds, 2, max_points=POINTS, drop_last=False, num_shards=2,
                shard_index=r), val_ds)[0])
    assert sorted(want) == sorted(dets0)
    for token, d in want.items():
        for k in ("box3d_lidar", "scores", "label_preds"):
            np.testing.assert_array_equal(dets0[token][k], d[k])
            np.testing.assert_array_equal(dets1[token][k], d[k])
    assert sum(len(d["scores"]) for d in want.values()) > 0
    assert val_ds.evaluation(want, output_dir=os.path.join(
        spec["out"], "one"))[0] == result0


@pytest.mark.parametrize("step", [0, 1])
def test_two_stage_ranks_step_as_one_process(rcnn_run, step):
    spec, ranks, ref, out = rcnn_run
    assert {"roi_cls_loss_task0", "roi_reg_loss_task0",
            "point_loss_task0"} <= set(out["steps"][step]["metrics_rel"])
    assert out["steps"][step]["metrics_rel_plain"]["loss"] <= 1e-5
    assert max(v for k, v in out["steps"][step]["metrics_rel"].items()
               if "loss" in k) <= 1e-6
    assert max(out["steps"][step]["grad_bound_by_group"].values()) <= 0.1


@pytest.mark.parametrize("step", [0, 1])
def test_ffn_bf16_ranks_step_as_one_process(ffn_bf16_run, step):
    """The two-stage demo in bf16 with `RoIFFNHead` and its IoU branch:
    two ranks against one process on the same global batch, as the f32
    two-stage demo. The IoU loss divides by the foreground count summed
    over the ranks, and the bf16 model's masked BN sums its f32
    statistics over the ranks."""
    spec, ranks, ref, out = ffn_bf16_run
    cfg, _, model = cs.dp_setup(torch, spec, "cpu")
    assert model.dtype == torch.bfloat16
    assert type(model.roi_head_net).__name__ == "RoIFFNHead"
    rec = out["steps"][step]
    assert {"roi_iou_loss_task0", "roi_reg_loss_task0"} <= set(
        rec["metrics_rel"])
    assert ranks[0]["metrics"][step]["roi_iou_loss_task0"] > 0
    assert max(v for k, v in rec["metrics_rel"].items()
               if "loss" in k) <= 1e-6
    assert max(rec["grad_bound_by_group"].values()) <= 0.1


def test_two_stage_ranks_draw_the_one_process_rows(rcnn_run):
    """Dropout's and the RoI sampler's draws of each rank are the
    one-process rows of each step, and so are the sampler's targets, bit
    for bit, given the same proposals (`chip_smoke.proposals_at_gt`:
    boxes about the GT drawn for the global batch; the first stage's own
    proposals can differ where a rounding tips its NMS at a near tie, as
    in 1 of these 8 samples without them), `check_dp_draws`; every step
    sampled real and fg RoIs, and the two ranks' draws differ (their own
    rows)."""
    spec, ranks, ref, out = rcnn_run
    assert len(ref["targets"]) == len(ref["sampler"]) == spec["steps"]
    assert len(ref["dropout"]) > spec["steps"]
    assert out["targets"]["sampled_slots"] == 2 * 2 * spec["steps"] * 32
    assert all(int((t.roi_labels > 0).sum()) > 0
               and int(t.reg_valid_mask.sum()) > 0 for _, t in ref["targets"])
    for a, b in zip(ranks[0]["dropout"], ranks[1]["dropout"]):
        assert a.shape == b.shape and not torch.equal(a, b)


# the ranks of a faulty data-parallel step (`python -c FAULTY_RANK FAULT
# SPEC`): `chip_smoke.dp_rank` with one fault planted
FAULTY_RANK = f"""
import sys
sys.path.insert(0, {ROOT!r})
import chip_smoke
from pillarnet_lts_torch.models.point_heads import point_head
from pillarnet_lts_torch.parallel import dist
from pillarnet_lts_torch.runtime import train_step

fault, spec = sys.argv[1:]
if fault == "average":
    summed = train_step.sum_gradients_over_ranks

    def averaged(params):
        params = list(params)
        summed(params)
        for p in params:
            if p.grad is not None:
                p.grad /= dist.process_count()
    train_step.sum_gradients_over_ranks = averaged
elif fault == "bn_backward":
    dist._SumOverRanks.backward = staticmethod(lambda ctx, grad: grad)
elif fault == "normalizer":
    point_head.sum_over_ranks = lambda t: t
else:
    raise ValueError(fault)
sys.exit(chip_smoke.dp_rank(spec))
"""


@pytest.mark.parametrize("fault, caught_by", [
    ("average", "grad_norm: ranks"), ("bn_backward", "parameters beyond"),
    ("normalizer", "loss: ranks")])
def test_the_checks_reject_a_planted_data_parallel_fault(rcnn_run, tmp_path,
                                                         fault, caught_by):
    """The ranks of `pillarrcnn18_demo` with one fault planted, each: the
    gradients averaged over the ranks instead of summed (every gradient
    halved; Adam's scale invariance hides it from the parameters), the
    BN's differentiable sum over the ranks with an identity backward (each
    rank's statistics' gradient misses the other rank's part), the point
    head's loss normalized by the rank's own foreground count. Their first
    step against the one-process step of `rcnn_run`: `check_dp_training`
    rejects each, and where the fault is in the gradients, the capped
    bounds of the gradients by module group alone reject it too."""
    spec, _, ref, _ = rcnn_run
    ranks, _ = cs.run_dp_training(
        torch, dict(spec, out=str(tmp_path)), fault, timeout=JOIN_TIMEOUT,
        rank_argv=[sys.executable, "-c", FAULTY_RANK, fault])
    shutil.rmtree(tmp_path)  # the ranks' records, ~0.4 GB each
    first = dict(ref, targets=[], **{k: ref[k][:1] for k in (
        "metrics", "metrics_plain", "metrics_convs_matmuls", "states",
        "grads", "spread")})
    with pytest.raises(AssertionError, match=caught_by):
        cs.check_dp_training(torch, fault, first, ranks)
    if fault != "normalizer":
        with pytest.raises(AssertionError, match="gradients"):
            cs.check_grad_groups(torch, fault, 0, ranks[0]["grads"][0],
                                 ref["grads"][0],
                                 ref["spread"][0]["grad_groups"])


# ---- two ranks against the JAX package's mesh step --------------------------


def jax_loader_rows(ds, spec):
    """The JAX loader's first batch on one host (the global batch of a
    step) as frame indices; the port's ranks' rows in rank order equal
    it."""
    rows = [int(i) for i in JaxLoader(ds, spec["batch"], shuffle=True,
                                      seed=spec["seed"])._indices()[
        :spec["batch"]]]
    assert cs.dp_rows(ds, spec)[0] == rows
    return rows


def jax_mesh_step(cfg, ds, model, spec, rows, patch=None):
    """One step of the JAX package's `make_train_step` jitted over a
    2-device mesh (`make_mesh`, `shard_batch`, `replicate`) on `rows`, from
    the port model's seeded weights; returns the metrics and the state."""
    jb = jax_collate([ds[i] for i in rows], max_points=spec["points"])
    jb.pop("metadata")
    jmodel = build_jax_detector(copy.deepcopy(cfg["model"]),
                                train_cfg=cfg["train_cfg"],
                                test_cfg=cfg["test_cfg"])
    tx = jax_build_optimizer(cfg["optimizer"], cfg["lr_config"],
                             spec["steps"], grad_clip_norm=35.0)
    jmesh = make_mesh(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdpe, "pillar_scatter_max", tpu_vjp_scatter)
        if patch is not None:
            patch(mp, jb)
        state, metrics = jax.jit(make_train_step(
            jmodel, tx, cfg["train_cfg"]))(
                replicate(TrainState.create(variables_of(model), tx), jmesh),
                shard_batch(jb, jmesh))
    return {k: float(v) for k, v in metrics.items()}, state


def assert_metrics_match(got, want, keys=None):
    """Every metric within rtol 1e-4 (`grad_norm` 1e-3), as the port's
    one-process step is held to JAX."""
    keys = set(want) if keys is None else keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], atol=0, err_msg=k,
                                   rtol=1e-3 if k == "grad_norm" else 1e-4)


def test_two_ranks_match_the_jax_mesh_step(demo_run):
    """The demo ranks' first step against one step of the JAX package's
    train step jitted over a 2-device mesh with the global batch sharded
    on it (`make_mesh`, `shard_batch`, `replicate`), fed the JAX loader's
    first batch in its own order, from the port's seeded weights: every
    metric within rtol 1e-4 (`grad_norm` 1e-3), the running statistics
    within rtol = atol = 1e-4, the parameters as
    `params_within_first_adam_step`, as the port's one-process step is
    held to JAX (`tests/test_torch_port_train_step.py`)."""
    spec, ranks, ref, _ = demo_run
    cfg, ds, model = cs.dp_setup(torch, spec, "cpu")
    want, state = jax_mesh_step(cfg, ds, model, spec,
                                jax_loader_rows(ds, spec))
    got = ranks[0]["metrics"][0]
    assert set(got) == set(want)
    assert_metrics_match(got, want)
    load_jax_variables(model, {
        "params": jax.tree_util.tree_map(np.asarray, state.params),
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              state.batch_stats)})
    jstate = model.state_dict()
    params = [n for n, _ in model.named_parameters()]
    cs.params_within_first_adam_step(
        torch, ranks[0]["states"][0], jstate, params,
        set(bn_shifted_biases(model)), ref["lr"][0])
    for k in set(jstate) - set(params):
        torch.testing.assert_close(ranks[0]["states"][0][k], jstate[k],
                                   rtol=1e-4, atol=1e-4)


JAX_SAMPLER_KEY = 48
# the module (the package exports its function under the module's name)
jptl = importlib.import_module(
    "pillarnet_lts_tpu.models.roi_heads.proposal_target_layer")


@pytest.fixture(scope="module")
def rcnn_jax_run(tmp_path_factory, rcnn_run):
    """Two ranks x 2 frames of `pillarrcnn18_demo`, one step, dropout off,
    the sampler given boxes about the GT (`proposals_at_gt`) and the JAX
    package's draws from one key for the global batch (`jax_draws`,
    `chip_smoke.given_draws`)."""
    out = tmp_path_factory.mktemp("rcnn_jax")
    num_rois = rcnn_run[1][0]["sampler"][0].uniforms.shape[-1]
    spec = _spec(cs.RCNN_DEMO, out, spread=True, at_gt=True, dp_ratio=0.0,
                 steps=1, draws=str(out / "draws.pt"))
    cfg, _, _ = cs.dp_setup(torch, spec, "cpu")
    per_image = cfg["model"]["roi_head"]["model_cfg"]["TARGET_CONFIG"][
        "ROI_PER_IMAGE"]
    draws = jax_draws(jax.random.PRNGKey(JAX_SAMPLER_KEY), spec["batch"],
                      num_rois, per_image)
    torch.save([(draws.uniforms, draws.ints)], spec["draws"])
    ranks, _ = cs.run_dp_training(torch, spec, "rcnn_jax",
                                  timeout=JOIN_TIMEOUT)
    return spec, ranks, num_rois


def test_two_stage_ranks_match_the_jax_mesh_step(rcnn_jax_run):
    """The two-stage demo ranks' step against the JAX package's mesh step
    on the JAX loader's first batch, both samplers given the same boxes
    about the GT and the same `jax.random` draws (the JAX sampler its
    key), dropout off: every loss within rtol 1e-4, as the single-stage
    demo's; the sampled RoI labels and regression masks equal to the JAX
    sampler's, the sampled RoIs, their GT and scores within 1e-4."""
    spec, ranks, num_rois = rcnn_jax_run
    cfg, ds, model = cs.dp_setup(torch, spec, "cpu")
    rows = jax_loader_rows(ds, spec)
    key = jax.random.PRNGKey(JAX_SAMPLER_KEY)
    target_cfg = dict(cfg["model"]["roi_head"]["model_cfg"][
        "TARGET_CONFIG"])
    gt = jax_collate([ds[i] for i in rows],
                     max_points=spec["points"])["gt_boxes_and_cls"]
    if gt.shape[-1] == 10:
        gt = gt[..., [0, 1, 2, 3, 4, 5, 6, 9]]
    # the boxes `proposals_at_gt` hands each rank's first call, global rows
    gen = torch.Generator().manual_seed(spec["seed"] * 1000)
    box, cls, score, _ = cs.near_gt(torch.from_numpy(np.asarray(gt)),
                                    torch.rand(len(rows), num_rois, 8,
                                               generator=gen))
    box, cls, score = (t.numpy() for t in (box, cls, score))

    def at_gt(rng, rois, scores, labels, gt_, cfg_):
        return jptl.proposal_target_layer(key, box, score,
                                          cls.astype(labels.dtype), gt_,
                                          cfg_)

    want, _ = jax_mesh_step(
        cfg, ds, model, spec, rows,
        patch=lambda mp, jb: mp.setattr(jrcnn, "proposal_target_layer",
                                        at_gt))
    got = ranks[0]["metrics"][0]
    assert got == ranks[1]["metrics"][0]
    losses = {k for k in want if "loss" in k}
    assert {"roi_cls_loss_task0", "roi_reg_loss_task0",
            "point_loss_task0"} <= losses <= set(got)
    assert_metrics_match(got, want, losses)

    jt = jax.jit(lambda g: jptl.proposal_target_layer(
        key, box, score, cls.astype(np.int32), g, target_cfg))(gt)
    for k in ("roi_labels", "reg_valid_mask", "rois", "gt_of_rois",
              "roi_scores"):
        port = torch.cat([getattr(rk["targets"][0][1], k)
                          for rk in ranks]).numpy()
        if k in ("roi_labels", "reg_valid_mask"):
            np.testing.assert_array_equal(port, getattr(jt, k), k)
        else:
            np.testing.assert_allclose(port, getattr(jt, k), atol=1e-4,
                                       rtol=0, err_msg=k)
    assert int((np.asarray(jt.roi_labels) > 0).sum()) > 0


# ---- the CLIs over two ranks ----------------------------------------------


def test_dist_test_over_two_ranks_equals_one_process(tmp_path):
    """`tools/dist_test` over 2 gloo ranks on 3 demo val frames (rank 1's
    shard wrap-padded), a frame a batch in both runs: rank 0's
    `prediction.pkl` holds every frame once, equal token for token to the
    one-process run's, and so is the score."""
    path = cs.config_file(str(tmp_path), "demo3", cs.DEMO,
                          "data['samples_per_gpu'] = 1\n"
                          f"data['val'] = dict(data['val'], num_frames="
                          f"{VAL_FRAMES})\n")
    ckpt = cs.spread_checkpoint(torch, path, "cpu", str(tmp_path / "ckpt"),
                                seed=1)
    args = [path, "--device", "cpu", "--seed", "1", "--checkpoint", ckpt]
    with one_thread():
        one = dist_test.main(args + ["--work_dir", str(tmp_path / "one")])
    cs.run_ranks("dist_test", [sys.executable, "-m",
                               "pillarnet_lts_torch.tools.dist_test"]
                 + args + ["--work_dir", str(tmp_path / "two")],
                 env=ONE_THREAD, timeout=JOIN_TIMEOUT)
    with open(tmp_path / "two" / "prediction.pkl", "rb") as f:
        two = pickle.load(f)
    assert sorted(two) == sorted(one["detections"]) == [
        f"demo_{i}" for i in range(VAL_FRAMES)]
    for token, d in one["detections"].items():
        for k in ("box3d_lidar", "scores", "label_preds"):
            np.testing.assert_array_equal(two[token][k], d[k])
    assert sum(len(d["scores"]) for d in two.values()) > 0
    want, _ = build_dataset(load_config(path)["data"]["val"]).evaluation(
        two, output_dir=str(tmp_path))
    assert want == one["result"]


def test_train_cli_over_two_ranks_writes_once(tmp_path):
    """`tools/train` over 2 gloo ranks with `--validate`: one epoch of one
    step (4 frames a rank), the work dir written once (rank 0's config
    snapshot, log, checkpoint and validation)."""
    work = tmp_path / "work"
    cs.run_ranks("train", [sys.executable, "-m",
                           "pillarnet_lts_torch.tools.train", cs.DEMO,
                           "--device", "cpu", "--work_dir", str(work),
                           "--validate", "--seed", "2"], env=ONE_THREAD,
                 timeout=JOIN_TIMEOUT)
    with open(work / "log.json") as f:
        logged = [json.loads(line) for line in f]
    assert len(logged) == 1 and np.isfinite(logged[0]["loss"])
    with open(work / "train.log") as f:
        text = f.read()
    assert text.count("Epoch [1/1][1/1]") == 1
    assert text.count("Evaluation demo") == 1
    assert sorted(os.listdir(work)) == ["config.py", "epoch_1.pth", "eval",
                                        "latest", "log.json", "train.log"]


# ---- a fault the sharded eval found ----------------------------------------


def test_waymo_evaluator_takes_a_frame_without_detections():
    """A frame with no detection (a shard's frame after a short training,
    phase 19c) reached the Waymo evaluator's `_to7` as a (0, 9) array,
    whose `reshape(0, -1)` raises: the JAX package's `preds_from_detections`
    still does (its fault, left as it is). The port's takes it as no
    boxes, and scores it as the JAX package scores the frame left out of
    the detections (no predictions there)."""
    rng = np.random.RandomState(3)
    infos, dets = [], {}
    for k in range(2):
        gt = np.zeros((3, 9), np.float32)
        gt[:, :2] = rng.uniform(-30, 30, (3, 2))
        gt[:, 3:6] = (4.5, 2.0, 1.6)
        gt[:, 8] = rng.uniform(-np.pi, np.pi, 3)
        infos.append({"token": f"f{k}", "gt_boxes": gt,
                      "gt_names": np.array(["VEHICLE"] * 3)})
        dets[f"f{k}"] = {"box3d_lidar": gt[:2] if k == 0
                         else np.zeros((0, 9), np.float32),
                         "scores": np.array([0.9, 0.6][:2 - 2 * k],
                                            np.float32),
                         "label_preds": np.zeros(2 - 2 * k, np.int64)}
    names = ["VEHICLE", "PEDESTRIAN", "CYCLIST"]
    with pytest.raises(ValueError, match="reshape"):
        jwaymo.preds_from_detections(dets, names)
    preds = twaymo.preds_from_detections(dets, names)
    assert preds["f1"]["boxes"].shape == (0, 7)
    got = twaymo.evaluate_waymo(twaymo.gt_from_infos(infos), preds,
                                device="cpu")
    want = jwaymo.evaluate_waymo(
        jwaymo.gt_from_infos(infos),
        jwaymo.preds_from_detections({"f0": dets["f0"]}, names))
    assert got["LEVEL_1"]["VEHICLE"] == pytest.approx(
        want["LEVEL_1"]["VEHICLE"], abs=1e-9)
    assert 0 < got["mAP_L1"] < 1
