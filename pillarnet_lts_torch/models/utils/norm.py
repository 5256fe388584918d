"""Masked BatchNorm: batch statistics over active sites in training, the
running statistics (folded into the preceding conv or matmul) at eval.

Port of `pillarnet_lts_tpu/models/utils/norm.py::MaskedBatchNorm`. In
training mode (`module.train()`) the statistics are the JAX package's
one-pass formulas (`norm.py:106-137`) over the sites where `mask` is set
(all sites with `mask=None`), across the whole batch:

  cnt = max(#sites, 1); mean = sum(x) / cnt;
  var = max(sum(x^2) / cnt - mean^2, 0)        (biased; normalizes)
  running_mean = (1 - m) running_mean + m mean
  running_var  = (1 - m) running_var + m var cnt / max(cnt - 1, 1)

with m = 0.01 (`_MOMENTUM`, the JAX package's `norm.py:42`) and
eps = 1e-3. With `mask=None` the site count is a
constant of the shape, and the JAX package's division by it compiles to a
multiply by its f32 reciprocal (XLA's simplifier); the port multiplies
likewise. The output is re-zeroed at inactive sites. Under
`torch.utils.checkpoint` (`remat`) the forward runs again in the backward;
`recomputing()` marks that replay, and the running statistics are then
left alone, so they move once per step as under JAX's `nn.remat`.

Under a data-parallel process group (`parallel/dist.py`) the batch is
the global one, as over the JAX package's sharded batch: sum(x),
sum(x^2) and the site count are summed over the ranks in one collective,
with a gradient through the sum, before the mean and variance are
formed, so every rank normalizes with, and moves its running statistics
by, the same global statistics. The count of the dense branch is the
local one times the ranks (every rank's batch has one shape). The replay
of a checkpointed forward runs the collective again: every rank replays
the same segments in the same order, and the same inputs give the same
sums.

At eval the norm is an affine y = x * inv + shift that the port folds into
the preceding conv or matmul (`fold_factors`); `forward` applies it
unfolded (and re-zeroes where a mask is given), as the JAX package does
after a transposed conv. Each module
chooses its path from its own `training` flag: `model.train()` selects the
training path of every module, `model.eval()` the eval path (the builders
return models in eval mode, as they are built for serving).

Parameter names follow torch (`weight`, `bias`, `running_mean`,
`running_var`); `runtime/convert.py` maps them from flax's
`scale`/`bias`/`mean`/`var`.

`MaskedGroupNorm` (`norm.py:145-194`) and the factory `build_norm` /
`get_norm_kwargs` (`:196-232`) complete the JAX package's norm-layer
surface: `dict(type="GN", num_groups=...)` builds a GroupNorm whose
statistics are per (sample, group) over the active sites; no config uses
it, as in the JAX package.
"""

import contextlib
import threading

import numpy as np
import torch
from torch import nn

from ...core.utils import f32_reciprocal
from ...parallel import dist

_MOMENTUM = 0.01
_REPLAY = threading.local()
_EXACT = threading.local()


@contextlib.contextmanager
def recomputing():
    """Marks a checkpointed forward's replay in the backward (the context
    `remat` hands `torch.utils.checkpoint` for its recompute)."""
    prev = getattr(_REPLAY, "active", False)
    _REPLAY.active = True
    try:
        yield
    finally:
        _REPLAY.active = prev


@contextlib.contextmanager
def exact_statistics():
    """Within it a training forward sets each norm's running statistics
    to its batch's own (momentum 1: `0 * running + mean` is the mean
    exactly), what precise BN (`runtime/precise_bn.py`) collects."""
    prev = getattr(_EXACT, "momentum", None)
    _EXACT.momentum = 1.0
    try:
        yield
    finally:
        _EXACT.momentum = prev


def _site_sum(t, dims):
    """`t` summed over `dims`, this rank's sites: one function for every
    sum of the statistics, so a test can take them in another order."""
    return t.sum(dims)


def _sum_over_ranks(*sums):
    """The per-rank sums `sums` summed over the ranks in one collective,
    differentiable (the sums themselves without a process group)."""
    if dist.process_count() == 1:
        return sums
    flat = dist.sum_with_grad(torch.cat([t.reshape(-1) for t in sums]))
    return flat.split([t.numel() for t in sums])


def _clamp0(v):
    """max(v, 0) with JAX's gradient at a tie (half to each side)."""
    return torch.maximum(v, torch.zeros_like(v))


class MaskedBatchNorm(nn.Module):
    def __init__(self, features, eps=1e-3, momentum=_MOMENTUM, device=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("running_mean",
                             torch.empty(features, device=device))
        self.register_buffer("running_var", torch.empty(features, device=device))
        self.init_weights(None)

    @torch.no_grad()
    def init_weights(self, generator):
        del generator  # deterministic: identity affine, unit statistics
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def fold_factors(self):
        """Eval-mode BN as y = x * inv + shift, in f32 whatever the compute
        dtype (callers cast the folded weights to it):
        inv = scale / sqrt(var + eps), shift = bias - mean * inv."""
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return inv, shift

    def forward(self, x, mask=None):
        """x (B, C, H, W) maps or (B, N, C) point rows; mask: a {0, 1} or
        bool tensor that broadcasts against x with size 1 on the channel
        axis ((B, 1, H, W) or (B, N, 1)), or None for every site.

        Training: normalize with the batch statistics of the masked sites
        and re-zero the others; eval: the running statistics, then the
        re-zero, as the JAX package's eval forward. Computed in f32,
        returned in x.dtype."""
        cdim = 1 if x.dim() == 4 else x.dim() - 1
        shape = [1] * x.dim()
        shape[cdim] = -1
        xf = x.float()
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = (xf - self.running_mean.view(shape)) * inv.view(shape) \
                + self.bias.view(shape)
            if mask is not None:
                y = y * mask.to(y.dtype)
            return y.to(x.dtype)

        dims = [d for d in range(x.dim()) if d != cdim]
        if mask is None:
            # the global site count: every rank's batch has this shape
            cnt = max(x.numel() // x.shape[cdim], 1) * dist.process_count()
            rcp = f32_reciprocal(cnt)
            s1, s2 = _sum_over_ranks(_site_sum(xf, dims),
                                     _site_sum(xf * xf, dims))
            mean = s1 * rcp
            var = _clamp0(s2 * rcp - mean * mean)
            # cnt / (cnt - 1) for the running variance, folded into one
            # constant
            bessel = float(np.float32(cnt) * np.float32(
                f32_reciprocal(max(cnt - 1, 1))))
        else:
            mf = mask.float()
            s1, s2, cnt = _sum_over_ranks(_site_sum(xf * mf, dims),
                                          _site_sum(xf * xf * mf, dims),
                                          mf.sum())
            cnt = cnt.clamp_min(1.0)
            mean = s1 / cnt
            var = _clamp0(s2 / cnt - mean * mean)
        if not getattr(_REPLAY, "active", False):
            with torch.no_grad():
                unbiased = (var * bessel if mask is None
                            else var * cnt / (cnt - 1.0).clamp_min(1.0))
                m = getattr(_EXACT, "momentum", None) or self.momentum
                self.running_mean.copy_(
                    (1.0 - m) * self.running_mean + m * mean)
                self.running_var.copy_(
                    (1.0 - m) * self.running_var + m * unbiased)
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)
        if mask is not None:
            y = y * mask.to(y.dtype)
        return y.to(x.dtype)


class MaskedGroupNorm(nn.Module):
    """GroupNorm with optional sparse-site statistics (JAX
    `norm.py::MaskedGroupNorm`): per (sample, group) the mean and the
    biased variance in f32 over the active sites x the group's channels
    (cnt = max(sites * C / G, 1); var = sum((x - mean)^2) / cnt), y =
    (x - mean) * rsqrt(var + eps) * scale + bias, re-zeroed at inactive
    sites, returned in x.dtype. The same in training and at eval (no
    running statistics). x: (B, C, H, W) maps or (B, N, C) rows; mask as
    `MaskedBatchNorm`'s, or None for every site. `weight` / `bias` are
    flax's `scale` / `bias`."""

    def __init__(self, features, num_groups=32, eps=1e-5, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.init_weights(None)

    @torch.no_grad()
    def init_weights(self, generator):
        del generator  # flax's: ones and zeros
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x, mask=None):
        cdim = 1 if x.dim() == 4 else x.dim() - 1
        xf = torch.movedim(x.float(), cdim, -1)  # channels last
        B, C = xf.shape[0], xf.shape[-1]
        if C % self.num_groups:  # at the call, as the JAX module checks
            raise ValueError(f"features={C} not divisible by "
                             f"num_groups={self.num_groups}")
        cg = C // self.num_groups
        xg = xf.reshape(B, -1, self.num_groups, cg)
        if mask is None:
            w = torch.ones((B, xg.shape[1], 1, 1), dtype=torch.float32,
                           device=x.device)
        else:
            m = torch.movedim(mask.float().expand(
                *x.shape[:cdim], 1, *x.shape[cdim + 1:]), cdim, -1)
            w = m.reshape(B, -1, 1, 1)
        cnt = (w.sum(1, keepdim=True) * cg).clamp_min(1.0)
        mean = (xg * w).sum((1, 3), keepdim=True) / cnt
        var = ((xg - mean).square() * w).sum((1, 3), keepdim=True) / cnt
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(xf.shape)
        y = y * self.weight + self.bias
        if mask is not None:
            y = y * w.reshape(xf.shape[:-1] + (1,))
        return torch.movedim(y, -1, cdim).to(x.dtype)


_BN_TYPES = ("BN", "BN1d", "SyncBN")


def build_norm(norm_cfg, features, device=None):
    """Norm-layer factory of the reference's `build_norm_layer` dispatch
    (JAX `norm.py::build_norm`): BN / BN1d / SyncBN -> `MaskedBatchNorm`
    (the mask at call time selects sparse or dense statistics; a process
    group makes them cross-replica), GN -> `MaskedGroupNorm`; anything else
    raises. `requires_grad` (a torch knob of the reference's configs) is
    dropped."""
    cfg = dict(norm_cfg or {"type": "BN"})
    t = cfg.pop("type", "BN")
    cfg.pop("requires_grad", None)
    if t in _BN_TYPES:
        return MaskedBatchNorm(features, eps=cfg.get("eps", 1e-3),
                               momentum=cfg.get("momentum", _MOMENTUM),
                               device=device)
    if t == "GN":
        return MaskedGroupNorm(features, num_groups=cfg.get("num_groups", 32),
                               eps=cfg.get("eps", 1e-5), device=device)
    raise NotImplementedError(f"norm type {t} not supported")


def get_norm_kwargs(norm_cfg):
    """A reference-style BN config (`dict(type="BN1d", momentum=0.01,
    eps=1e-3)`) -> `MaskedBatchNorm`'s momentum and eps (JAX
    `norm.py::get_norm_kwargs`); other types raise."""
    if norm_cfg is None:
        return dict(momentum=_MOMENTUM, eps=1e-3)
    t = norm_cfg.get("type", "BN")
    if t not in _BN_TYPES:
        raise NotImplementedError(f"norm type {t} not supported")
    return dict(momentum=norm_cfg.get("momentum", _MOMENTUM),
                eps=norm_cfg.get("eps", 1e-3))


class LayerNorm(nn.Module):
    """flax's `nn.LayerNorm` over the last axis: its statistics in f32
    whatever the input's dtype (mean = sum(x) / C, var = max(sum(x^2) / C
    - mean^2, 0), the division a multiply by the f32 reciprocal of C as
    XLA compiles it), eps 1e-6, y = (x - mean) * (rsqrt(var + eps) *
    scale) + bias in f32, returned in `dtype` (the module's compute dtype,
    as flax's `LayerNorm(dtype=...)`; None: x.dtype). `weight` / `bias`
    are flax's `scale` / `bias` (`runtime/convert.py`)."""

    def __init__(self, features, eps=1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.init_weights(None)

    @torch.no_grad()
    def init_weights(self, generator):
        del generator  # flax's: ones and zeros
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x, dtype=None):
        xf = x.float()
        rcp = f32_reciprocal(x.shape[-1])
        mean = xf.sum(-1, keepdim=True) * rcp
        var = _clamp0((xf * xf).sum(-1, keepdim=True) * rcp - mean * mean)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias
        return y.to(dtype or x.dtype)
