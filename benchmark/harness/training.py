"""A training cell's run: set-up drives the system's training step from the
seed through its first steps, hands the same model and optimizer to the
window, and the reference follows those first steps once the window has
closed.

Traffic of kind "train": `pool` batches of `batch` scenes (`inputs.scene`)
whose targets the system's own pipeline makes in set-up (no
augmentation; the loader stays out of the window). Steps 1 to
`checked_steps` run in set-up on distinct batches through the window's
own call and feed; the window runs step after step, cycling the pool,
until the run's seconds have passed, and closes when its last step has
finished: the rate is the samples of all its steps over all its time.

The comparison: each checked step's loss; the first gradient as the
optimizer got it, read back from its first moment after step 1; the
parameters' change over the checked steps. Both by the worst leaf: the gap
between the system's norm and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's (biases that
a training-mode BatchNorm follows: nought but round-off) are left out.
"""

import gc
import time
import types

import numpy as np
import torch

from .. import counts
from ..reference.model import Reference, param_spec, spread_head
from ..reference.train import ReferenceTrainer, collate, targets
from . import program, spans
from .inputs import make_weights, pad_points, scene, sub_seed
from .session import (_rf, _sync, assemble, device_info, f32_model_cfg,
                      report_phases)

_KEYS = ("points", "points_mask", "gt_boxes_and_cls", "hm", "anno_box",
         "ind", "mask", "cat", "gt_box")
STRETCH_STEPS = 2


def _pinned(batch, cuda):
    def t(a):
        x = torch.from_numpy(np.ascontiguousarray(a))
        return x.pin_memory() if cuda else x

    return {k: [t(a) for a in v] if isinstance(v, list) else t(v)
            for k, v in batch.items() if k in _KEYS}


class TrainSetup:
    def __init__(self, cell, seed, device):
        self.phases = [("start", time.perf_counter())]
        cfg, tr = cell["config"], cell["traffic"]
        mc = cfg["model"]
        self.cell, self.seed, self.device = cell, seed, device
        self.batch = tr["batch"]
        self.spec = param_spec(mc)
        self.weights = make_weights(self.spec, seed, device)
        pc = mc["reader"]["pc_range"]
        self.scenes = [scene(sub_seed(seed, 4, i), tr["scene_points"], pc,
                             cfg["class_names"], tuple(tr["num_boxes"]))
                       for i in range(tr["pool"] * self.batch)]
        self._phase("weights, scenes")
        pts, msk = self.points(0, 1)
        ref = Reference(f32_model_cfg(mc), cfg["test_cfg"], self.weights)
        with torch.no_grad():
            spread_head(self.weights, ref.forward(pts, msk))
        del ref
        self._phase("head spread (reference forward)")
        cuda = device.type == "cuda"
        self.batches = [_pinned(program.train_targets(
            cfg, self.scenes[b * self.batch:(b + 1) * self.batch],
            cfg["max_points"]), cuda) for b in range(tr["pool"])]
        self._phase("the system's targets")
        self.model, self.opt, self.step = program.build_train(
            cfg, self.weights, device, cfg["total_steps"])
        self._phase("system built")

    def _phase(self, name):
        _sync(self.device)
        self.phases.append((name, time.perf_counter()))

    def points(self, first, count):
        """Scenes first .. first + count - 1 padded, on the device."""
        pts, msk = pad_points([s[0] for s in
                               self.scenes[first:first + count]],
                              self.cell["config"]["max_points"])
        return (torch.from_numpy(pts).to(self.device),
                torch.from_numpy(msk).to(self.device))

    def feed(self, k):
        """Batch k of the pool on the device."""
        nb = self.device.type == "cuda"
        b = self.batches[k % len(self.batches)]
        return {key: [t.to(self.device, non_blocking=nb) for t in v]
                if isinstance(v, list) else v.to(self.device,
                                                 non_blocking=nb)
                for key, v in b.items()}


def first_moment_grads(opt, model):
    """The first gradient as the optimizer got it (clipped), from its
    state after one step: mu = (1 - b1) g."""
    b1 = opt.mom_fn(0)
    out = {}
    for name, p in model.named_parameters():
        st = opt.state.get(p, {})
        out[name] = (st["mu"] / (1.0 - b1) if "mu" in st
                     else torch.zeros_like(p))
    return out


def leaf_gap(got, want, leaves):
    """The worst leaf's gap of norms, over the larger of the reference's
    norm of the leaf and of the median leaf."""
    norms = {n: float(want[n].double().norm()) for n in leaves}
    med = float(np.median(list(norms.values())))
    return max(abs(float(got[n].double().norm()) - norms[n])
               / max(norms[n], med, 1e-30) for n in leaves)


def run_train(cell, seed, seconds, trace, device, t_start, fault=None):
    tr, cfg = cell["traffic"], cell["config"]
    cuda = device.type == "cuda"
    s = TrainSetup(cell, seed, device)
    if fault is not None:
        fault(s)
    checked = tr["checked_steps"]
    losses = []
    for k in range(checked):
        m = s.step(s.feed(k))
        losses.append(float(m["loss"]))
        if k == 0:
            g1 = {n: g.detach().clone() for n, g in
                  first_moment_grads(s.opt, s.model).items()}
    p_after = {n: p.detach().clone() for n, p in s.model.named_parameters()}
    s._phase(f"{checked} checked steps (the warm-up)")
    setup_s = time.perf_counter() - t_start
    report_phases(s.phases, t_start)
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    ctx = types.SimpleNamespace(tag=tr["tag"], layer_ms={}, trace=None)
    hooks = _TrainSpans(s, device) if trace else None
    # steps until `seconds` have passed; the window closes when the last
    # of them has finished, so the rate counts whole steps over their
    # whole time
    t0 = time.perf_counter()
    k, done = checked, 0
    while time.perf_counter() - t0 < seconds:
        m = s.step(s.feed(k))
        float(m["loss"])  # the step's loss on the host, as a log reads it
        done += 1
        k += 1
    window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx.peak_window_bytes = window_peak
    ctx.service_s = window_s
    e2e = {"train_samples_per_s": (done * s.batch / window_s,
                                   "samples/s")}
    result = {"correct": False, "attempted": done * s.batch, "failed": 0}
    dev_info = device_info(device, max(peak_setup, window_peak))
    if trace:
        _sync(device)
        for name in hooks.marks:
            ctx.layer_ms[name] = hooks.ms(name)
        ctx.min_s_done = _min_seconds(s, checked, done)
        if cuda:
            ctx.trace = _traced_steps(s, k)
            dev_info["busy_s"] = ctx.trace["busy_s"]
            dev_info["window_s"] = ctx.trace["window_s"]
        hooks.detach()
    del s.model, s.opt, s.step, hooks
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    values = compare(s, losses, g1, p_after)
    return assemble(cell, values, checked, "steps_compared", result, ctx,
                    trace, e2e, setup_s, dev_info)


def reference_run(s, tf32=False, rows=None):
    """The reference's checked steps from the run's weights and scenes:
    (losses, first clipped gradients, parameters after). `rows`: the
    samples of each batch it trains on (all by default)."""
    cfg = s.cell["config"]
    mc = cfg["model"]
    index = {n: i for i, n in enumerate(cfg["class_names"])}
    program.set_tf32(tf32)
    try:
        ref = ReferenceTrainer(cfg, s.weights, s.spec, cfg["total_steps"])
        losses = []
        for k in range(s.cell["traffic"]["checked_steps"]):
            first = (k % len(s.batches)) * s.batch
            pick = list(range(s.batch)) if rows is None else rows
            pts, msk = s.points(first, s.batch)
            tg = [targets(b, np.array([index[n] for n in names]), mc,
                          cfg["train_cfg"]["assigner"])
                  for _, b, names in s.scenes[first:first + s.batch]]
            tg = collate([tg[i] for i in pick], s.device)
            losses.append(ref.step(pts[pick], msk[pick], tg))
    finally:
        program.set_tf32(False)
    return losses, ref.first_grads, {n: p.detach() for n, p in
                                     ref.params.items()}


def readings(s, losses, g1, p_after, ref):
    """The compared numbers of one side's checked steps against the
    reference's (`reference_run`)."""
    r_losses, r_g1, r_after = ref
    norms = {n: float(g.double().norm()) for n, g in r_g1.items()}
    med = float(np.median(list(norms.values())))
    leaves = [n for n, v in norms.items() if v >= 1e-3 * med]
    start = {n: s.weights[n] for n in r_after}
    d_got = {n: p_after[n] - start[n] for n in leaves}
    d_ref = {n: r_after[n] - start[n] for n in leaves}
    return {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, r_losses)),
            "grad_gap": leaf_gap(g1, r_g1, leaves),
            "change_gap": leaf_gap(d_got, d_ref, leaves)}


def compare(s, losses, g1, p_after):
    t = time.perf_counter()
    values = readings(s, losses, g1, p_after, reference_run(s))
    import sys

    print(f"reference: {len(losses)} steps in "
          f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    return values


def _min_seconds(s, first_step, steps):
    """The least time of the window's steps: 3x each sample's forward
    operations (the backward counted as two forwards)."""
    mc = s.cell["config"]["model"]
    per_batch = {}
    total = 0.0
    for k in range(first_step, first_step + steps):
        b = k % len(s.batches)
        if b not in per_batch:
            pts, msk = s.points(b * s.batch, s.batch)
            per_batch[b] = 3 * float(counts.min_seconds(
                counts.frame_ops(mc, pts, msk)).sum())
        total += per_batch[b]
    return total


class _TrainSpans:
    """CUDA events around a step's forward with its losses (to the end of
    `model.loss`), its backward (to the optimizer's step) and the
    optimizer's step."""

    def __init__(self, s, device):
        self.timer = spans.Timer(device)
        self.s = s
        self.marks = {"forward": [], "backward": [], "optimizer": []}
        self._t = {}
        model, opt = s.model, s.opt
        loss, step = model.loss, opt.step

        def timed_loss(*a, **kw):
            out = loss(*a, **kw)
            self._t["loss_end"] = self.timer.mark()
            self.marks["forward"].append((self._t.pop("start"),
                                          self._t["loss_end"]))
            return out

        def timed_step(*a, **kw):
            t = self.timer.mark()
            self.marks["backward"].append((self._t.pop("loss_end"), t))
            with _rf("optimizer"):
                out = step(*a, **kw)
            self.marks["optimizer"].append((t, self.timer.mark()))
            return out

        def pre(module, args, kwargs):
            if module.training and "start" not in self._t:
                self._t["start"] = self.timer.mark()

        model.loss = timed_loss
        opt.step = timed_step
        self.handle = model.register_forward_pre_hook(pre, with_kwargs=True)

    def detach(self):
        self.handle.remove()
        del self.s.model.loss
        del self.s.opt.step

    def ms(self, name):
        return [self.timer.ms(a, b) for a, b in self.marks[name]]


def _traced_steps(s, k):
    """`STRETCH_STEPS` steps under the profiler."""
    def stretch():
        with _rf("stretch"):
            for i in range(STRETCH_STEPS):
                with _rf("step"):
                    m = s.step(s.feed(k + i))
                float(m["loss"])

    kernels, ranges, lost = spans.profiled(stretch)
    out = spans.reduce_trace(kernels, ranges,
                             [(a, b) for n, a, b in ranges
                              if n == "stretch"])
    out["lost"] = lost
    return out
