"""PyTorch port, bf16 training: the first training step of the bf16
`pillarnet18_demo` and `pillarrcnn18_demo` (`dtype="bfloat16"`) against
the JAX package's own jitted bf16 train step (`parallel/train_step.py`),
from one JAX variables tree on one collated batch, as
`tests/test_torch_port_train_step.py` holds the f32 step.

Both packages keep the parameters and the optimizer's state in f32 and
compute in bf16; the masked BN takes its statistics in f32. The JAX
package runs with the scatter's TPU gradient (`test_torch_port_train.py::
tpu_vjp_scatter`); the two-stage model samples its RoIs from one key in
both (the JAX package's `proposal_target_layer` given that key, the
port's `sampler_draws` replaced by `jax_draws` of it), dropout off.

Tolerance: the JAX package's own bf16 compile-to-compile spread, measured
in the same run over four builds of its step: as jitted, without XLA's
fusion pass, without XLA's excess precision (`xla_allow_excess_precision`
off: every bf16 operation rounds where the program says, as eager torch
rounds; as jitted, XLA keeps f32 through a fused chain and drops the
round trips of a convert pair), and without both. On random weights
with redrawn BN statistics a step is chaotic in bf16: a one-ulp flip in
stage 1 grows about twofold a stage, and the builds' losses and
`grad_norm` part by up to 8% (`pillarnet18_demo`) and 68%
(`pillarrcnn18_demo`, whose point and RoI losses sum over few
foreground sites). So, as `tests/test_torch_port_train_step.py` holds
the f32 steps: the port's largest relative difference of any metric
(each loss, `grad_norm`) from the jitted build at most twice the largest
between any two JAX builds; the share of updated parameters (and of
running statistics) beyond rtol = atol = 1e-4 at most twice the largest
share between the jitted build and another, or 0.5%. The updated
parameters stay f32, and every metric is finite. The two-stage case is
marked slow (its four compiles take ~3 min); `pillarnet18_demo` runs in
the tier-1 suite. The bf16 second stage is held to the JAX package in the
tier-1 suite where it is not chaotic, on fixed first-stage outputs and
shared draws (`test_torch_port_rcnn_heads.py::
test_variant_second_stage_*[bf16-*]`: losses within 2e-2, gradients
within 5e-2 in norm); the whole two-stage bf16 step runs there through
`test_torch_port_rcnn.py::test_two_stage_training_raises` and the
data-parallel test.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax

from pillarnet_lts_tpu.models import build_detector as build_jax_detector
from pillarnet_lts_tpu.models.detectors import pillar_rcnn as jrcnn
from pillarnet_lts_tpu.models.readers import dynamic_pillar_encoder as jdpe
from pillarnet_lts_tpu.parallel.collate import collate_batch as jax_collate
from pillarnet_lts_tpu.parallel.train_state import TrainState
from pillarnet_lts_tpu.parallel.train_step import make_train_step
from pillarnet_lts_tpu.solver import build_optimizer as jax_build_optimizer
from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                      optimizer_from_cfg)
from pillarnet_lts_torch.datasets import SynthDataset, collate_batch
from pillarnet_lts_torch.models.detectors import pillar_rcnn as trcnn
from pillarnet_lts_torch.runtime.convert import load_jax_variables
from pillarnet_lts_torch.runtime.train_step import (batch_to_device,
                                                    train_step)
import test_torch_port_threads  # noqa: F401  (one torch thread)
from test_torch_port_rcnn_train import jax_draws, jptl
from test_torch_port_train import tpu_vjp_scatter
from test_torch_port_train_step import _as_port, _jax_variables, _share_beyond

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CONFIGS = {"pillarnet18_demo": "pillarnet18_demo.py",
           "pillarrcnn18_demo": "pillarrcnn18_demo.py"}
TOTAL_STEPS = 10
BATCH = 2
N_POINTS = 4096
# the JAX package's builds of its step: as jitted first, then the others
JAX_BUILDS = (None, {"xla_disable_hlo_passes": "fusion"},
              {"xla_allow_excess_precision": False},
              {"xla_allow_excess_precision": False,
               "xla_disable_hlo_passes": "fusion"})


def bf16_cfg(name):
    """The bf16 demo in the plain layout in both packages (the port drops
    the TPU layout keys; in bf16 the JAX package's space-to-depth,
    H-packed and W-chunked convs round their sums otherwise), dropout
    off."""
    cfg = load_config(os.path.join(ROOT, "configs", "demo", CONFIGS[name]))
    cfg["model"]["dtype"] = "bfloat16"
    first = cfg["model"].get("first_stage_cfg", cfg["model"])
    first["backbone"] = dict(first["backbone"], s2d_stage1=False,
                             hpack=False, chunk_nc=0)
    if "roi_head" in cfg["model"]:
        head = cfg["model"]["roi_head"]
        cfg["model"]["roi_head"] = dict(head, model_cfg=dict(
            head["model_cfg"], DP_RATIO=0.0))
    return cfg


def first_steps(name):
    """The first step of the bf16 demo `name` in both packages from one
    state, the JAX package's in each of `JAX_BUILDS`."""
    cfg = bf16_cfg(name)
    examples = [SynthDataset(cfg, BATCH, N_POINTS, seed=23)[i]
                for i in range(BATCH)]
    jb = jax_collate(examples, max_points=cfg["data"]["max_points"])
    jb.pop("metadata")
    jmodel = build_jax_detector(copy.deepcopy(cfg["model"]),
                                train_cfg=cfg["train_cfg"],
                                test_cfg=cfg["test_cfg"])
    variables = _jax_variables(jmodel, jb)
    key = jax.random.PRNGKey(24)
    two_stage = "roi_head" in cfg["model"]

    runs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdpe, "pillar_scatter_max", tpu_vjp_scatter)
        if two_stage:
            mp.setattr(jrcnn, "proposal_target_layer",
                       lambda rng, *a: jptl.proposal_target_layer(key, *a))
        tx = jax_build_optimizer(cfg["optimizer"], cfg["lr_config"],
                                 TOTAL_STEPS, grad_clip_norm=35.0)
        fn = make_train_step(jmodel, tx, cfg["train_cfg"])
        for options in JAX_BUILDS:
            state = TrainState.create(variables, tx)
            step = jax.jit(fn).lower(state, jb).compile(
                compiler_options=options)
            state, m = step(state, jb)
            runs.append((jax.tree_util.tree_map(np.asarray, m),
                         {"params": jax.tree_util.tree_map(np.array,
                                                           state.params),
                          "batch_stats": jax.tree_util.tree_map(
                              np.array, state.batch_stats)}))

    model = build_model_from_cfg(cfg, device="cpu")
    assert model.dtype == torch.bfloat16
    load_jax_variables(model, variables)
    opt = optimizer_from_cfg(model, cfg, TOTAL_STEPS)
    batch = batch_to_device(collate_batch(examples,
                                          cfg["data"]["max_points"]), "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trcnn, "sampler_draws",
                   lambda g, B, R, M, d: jax_draws(key, B, R, M))
        m = train_step(model, opt, batch, cfg["train_cfg"],
                       torch.Generator().manual_seed(0))
    port = ({k: v.numpy() for k, v in m.items()},
            {k: v.clone() for k, v in model.state_dict().items()})
    return dict(cfg=cfg, model=model, jax=runs, port=port)


@pytest.fixture(scope="module", params=[
    "pillarnet18_demo",
    # slow: four compiles of the two-stage training step take ~3 min
    pytest.param("pillarrcnn18_demo", marks=pytest.mark.slow)])
def bf16_step(request):
    return first_steps(request.param)


def _max_rel(a, b, keys):
    return max(abs(float(a[k]) - float(b[k])) / abs(float(b[k]))
               for k in keys)


def test_bf16_first_step_metrics_within_the_jax_spread(bf16_step):
    s = bf16_step
    builds = [m for m, _ in s["jax"]]
    want, got = builds[0], s["port"][0]
    assert set(got) == set(want)
    assert "grad_norm" in got and "hm_loss_task0" in got
    if "roi_head" in s["cfg"]["model"]:
        assert {"roi_cls_loss_task0", "point_loss_task0"} <= set(got)
    assert all(np.isfinite(v) for v in got.values())
    zero = [k for k in want if want[k] == 0]
    for k in zero:
        assert got[k] == 0 and all(b[k] == 0 for b in builds), k
    keys = [k for k in want if k not in zero]
    own = max(_max_rel(a, b, keys) for i, a in enumerate(builds)
              for b in builds[i + 1:])
    port = _max_rel(got, want, keys)
    assert port <= 2 * own, (port, own)


def test_bf16_first_step_state_within_the_jax_spread(bf16_step):
    s = bf16_step
    cfg, model = s["cfg"], s["model"]
    want, *others = [_as_port(cfg, state) for _, state in s["jax"]]
    got = {k: v.numpy() for k, v in s["port"][1].items()}
    params = [n for n, _ in model.named_parameters()]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    stats = [k for k in got if "running_" in k]
    for keys in (params, stats):
        port_share = _share_beyond(got, want, keys)
        own_share = max(_share_beyond(o, want, keys) for o in others)
        assert port_share <= max(2 * own_share, 5e-3), (port_share,
                                                        own_share)
