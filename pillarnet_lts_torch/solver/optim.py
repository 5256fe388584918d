"""One-cycle AdamW with clipping by global norm, as the JAX package's optax
chain computes it.

Port of `pillarnet_lts_tpu/solver/optim.py`: `optimizer.type="adam"` with
the lr schedules `one_cycle` (every config's), `exp_decay` and
`manual_stepping` (b1 0.9 with the last two):

  optax.chain(clip_by_global_norm(max_norm),
              inject_hyperparams(adamw)(lr_fn, b1=mom_fn, b2=0.99,
                                        weight_decay=wd))

- lr and b1 are the schedules' values at the step count before the update
  (`inject_hyperparams`), in f32; the bias correction uses that b1;
- Adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu,
  u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps), eps = 1e-8 outside
  the root, t the count after the increment;
- decoupled decay: p += -lr (u + wd p), on every parameter;
- the clip, before Adam: g * max_norm / norm where norm >= max_norm,
  written as optax does, (g / norm) * max_norm (not `clip_grad_norm_`'s
  max_norm / (norm + 1e-6)).

The schedules' divisions by a step count constant are multiplies by its
f32 reciprocal, as XLA compiles them.
"""

import numpy as np
import torch

_F32 = np.float32
B2, EPS = 0.99, 1e-8  # the JAX package's adamw (`solver/optim.py:144`)


def _annealing_cos(start, end, pct):
    """Cosine anneal from start to end as pct goes 0 -> 1, in f32."""
    cos_out = np.cos(_F32(np.pi) * pct) + _F32(1.0)
    return _F32(end) + _F32((start - end) / 2.0) * cos_out


def one_cycle_schedules(total_steps, lr_max, moms, div_factor, pct_start):
    """(lr_fn, mom_fn) of the global step (python int -> python float, an
    f32 value): lr from lr_max / div_factor up to lr_max over the first
    pct_start of the steps, then down to lr_max / div_factor / 1e4 (cosine
    both ways); the momentum from moms[0] down to moms[1] and back."""
    low_lr = lr_max / div_factor
    final_lr = low_lr / 1e4
    a1 = max(int(total_steps * pct_start), 1)
    span2 = max(total_steps - a1, 1)
    r1 = _F32(1) / _F32(a1)
    r2 = _F32(1) / _F32(span2)

    def pcts(step):
        s = _F32(step)
        return (s, np.clip(s * r1, _F32(0), _F32(1)),
                np.clip((s - _F32(a1)) * r2, _F32(0), _F32(1)))

    def lr_fn(step):
        s, p1, p2 = pcts(step)
        return float(_annealing_cos(low_lr, lr_max, p1) if s < a1
                     else _annealing_cos(lr_max, final_lr, p2))

    def mom_fn(step):
        s, p1, p2 = pcts(step)
        return float(_annealing_cos(moms[0], moms[1], p1) if s < a1
                     else _annealing_cos(moms[1], moms[0], p2))

    return lr_fn, mom_fn


def exponential_decay_schedule(total_steps, init_lr, decay_length,
                               decay_factor, staircase=True):
    """lr = init_lr * decay_factor ** (step / decay_steps), the exponent
    floored when `staircase`; decay_steps = decay_length (a share of the
    run) x total_steps, at least 1. In f32, the division a multiply by
    the f32 reciprocal."""
    rcp = _F32(1) / _F32(max(int(decay_length * total_steps), 1))

    def lr_fn(step):
        p = _F32(step) * rcp
        if staircase:
            p = np.floor(p)
        return float(_F32(init_lr) * np.power(_F32(decay_factor), p))

    return lr_fn


def manual_stepping_schedule(total_steps, boundaries, rates):
    """lr = rates[i], i the number of boundaries (shares of the run, times
    total_steps) the step has reached; len(rates) = len(boundaries) + 1."""
    if len(boundaries) + 1 != len(rates):
        raise ValueError("manual_stepping needs one rate more than "
                         "boundaries")
    bounds = np.array([b * total_steps for b in boundaries], _F32)
    rates = np.array(rates, _F32)

    def lr_fn(step):
        return float(rates[int((_F32(step) >= bounds).sum())])

    return lr_fn


def _constant(value):
    value = float(_F32(value))
    return lambda step: value


class OptaxAdamW(torch.optim.Optimizer):
    """AdamW + clip by global norm with optax's arithmetic (module
    docstring). `step()` reads `.grad` (None counts as zero), updates every
    parameter and returns the global norm of the unclipped gradients, a
    0-d tensor. The step count is part of `state_dict()`."""

    def __init__(self, params, lr_fn, mom_fn, weight_decay=0.01,
                 max_norm=None):
        super().__init__(params, dict(weight_decay=weight_decay))
        self.lr_fn = lr_fn
        self.mom_fn = mom_fn
        self.max_norm = max_norm
        self.count = 0

    def state_dict(self):
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdamW.step takes no closure")
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        norm = torch.sqrt(torch.stack(
            [(g * g).sum() for g in grads]).sum())
        if self.max_norm is not None:
            # optax's select of g or (g / norm) * max_norm, on the device so
            # that no host sync decides it; a select, as optax's, never
            # reads the other branch (g / 0 is NaN for all-zero gradients)
            keep = norm < self.max_norm
            clipped = torch._foreach_mul(torch._foreach_div(grads, norm),
                                         self.max_norm)
            grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]

        lr = self.lr_fn(self.count)
        b1 = self.mom_fn(self.count)
        self.count += 1
        b2, eps, wd = B2, EPS, self.param_groups[0]["weight_decay"]
        dev = params[0].device
        # the bias corrections as 0-d tensors: a CUDA division by a python
        # float is a multiply by its reciprocal
        bc1 = torch.full((), float(_F32(1) - _F32(b1) ** self.count),
                         device=dev)
        bc2 = torch.full((), float(_F32(1) - _F32(b2) ** self.count),
                         device=dev)
        states = [self.state[p] for p in params]
        for p, st in zip(params, states):
            if not st:
                st["mu"] = torch.zeros_like(p)
                st["nu"] = torch.zeros_like(p)
        # one multi-tensor launch per operation, each rounded as optax's
        mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - b1),
                                torch._foreach_mul([s["mu"] for s in states],
                                                   b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2),
            torch._foreach_mul([s["nu"] for s in states], b2))
        den = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        u = torch._foreach_add(u, torch._foreach_mul(params, wd))
        torch._foreach_add_(params, torch._foreach_mul(u, -lr))
        for st, m, n in zip(states, mu, nu):
            st["mu"], st["nu"] = m, n
        return norm


def build_optimizer(params, cfg, lr_config, total_steps, grad_clip_norm=None):
    """The optimizer of a config's `optimizer` (`adam`) and `lr_config`
    (`one_cycle`, `exp_decay` or `manual_stepping`; others raise) over
    `total_steps` steps."""
    if cfg.get("type", "adam").lower() != "adam":
        raise NotImplementedError(f"optimizer type {cfg.get('type')!r}")
    kind = lr_config.get("type")
    if kind == "one_cycle":
        lr_fn, mom_fn = one_cycle_schedules(
            total_steps, lr_config["lr_max"], tuple(lr_config["moms"]),
            lr_config["div_factor"], lr_config["pct_start"])
    elif kind == "exp_decay":
        lr_fn = exponential_decay_schedule(
            total_steps, lr_config["init_lr"], lr_config["decay_length"],
            lr_config["decay_factor"],
            staircase=lr_config.get("staircase", True))
        mom_fn = _constant(0.9)
    elif kind == "manual_stepping":
        lr_fn = manual_stepping_schedule(total_steps,
                                         list(lr_config["boundaries"]),
                                         list(lr_config["rates"]))
        mom_fn = _constant(0.9)
    else:
        raise NotImplementedError(f"lr schedule {kind!r}")
    return OptaxAdamW(params, lr_fn, mom_fn, weight_decay=cfg.get("wd", 0.01),
                      max_norm=grad_clip_norm)
