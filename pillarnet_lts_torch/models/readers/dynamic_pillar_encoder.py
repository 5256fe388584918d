"""Dynamic pillar feature encoder (reader).

Port of `pillarnet_lts_tpu/models/readers/dynamic_pillar_encoder.py`:

  padded points -> per-point pillar ids + [dx_c, dy_c, raw] features
  -> shared Linear + BN + ReLU MLP, BN folded into the weights
  -> scatter-max straight into the dense (B, H, W, F) BEV grid + occupancy.

In training (`module.train()`) the MLP runs unfolded: Linear, then the
masked BN with batch statistics over the valid points (`mask=valid`),
then ReLU (JAX :150-160); the gradient flows back through the scatter-max
(the `pillarnet::pillar_scatter_max` op's gradient, `ops/library.py`).

The MLP computes in `dtype` (f32 or bf16). int8 deploy (`quant=True`,
calibrated): the MLP quantizes its input per input channel and the scale
folds into the weight rows (`_PFNDense`), and with `quant_scatter` the
post-ReLU features go through the scatter as int8 codes with one
calibrated scale, dequantized in f32 and rounded once to `dtype`.

`compact_kmax > 0` (JAX :163-183): the post-ReLU features go through
`ops/compact.py::compact_segment_max` instead of the scatter, and the
reader returns `(CompactPillars, None)`, an active-site row table with a
budget of `compact_kmax` sites, for the backbone's compact conv1/conv2;
no dense grid is built and K1 is not launched. A cloud with more active
sites than the budget loses the rest (the JAX package's semantics); each
eager forward keeps their count over the batch in `dropped_sites`, a 0-d
int64 tensor on the points' device (None before the first).
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.compact import compact_segment_max
from ...ops.quant import activation_scale, quantize, weight_scale
from ...ops.scatter import pillar_scatter_max
from ...ops.voxelize import PillarSpec, voxelize_points
from ..backbones.compact_exec import CompactPillars
from ..registry import READERS
from ..utils.init import normal_
from ..utils.norm import MaskedBatchNorm
from ..utils.quant import Calibrated


class _PFNDense(Calibrated, nn.Module):
    """Bias-free Linear of the shared per-point MLP; `weight` is (out, in)
    (the flax kernel transposed). `quant=True` adds the int8 mode with a
    per-INPUT-channel activation absmax `in_absmax` (the input mixes
    metric coordinates with intensities; `dynamic_pillar_encoder.py:29-38`)."""

    def __init__(self, in_features, features, quant=False, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(features, in_features, device=device))
        self._init_quant(quant, "in_absmax", (in_features,), device)

    @torch.no_grad()
    def init_weights(self, generator):
        normal_(self.weight, (2.0 / self.weight.shape[1]) ** 0.5, generator)

    def folded(self, x, inv, shift, mask=None):
        """BN(x @ W) = x @ (W * inv) + shift, in x.dtype.

        int8: y = sum_c (x_c / s_c) (s_c w_c): the input quantizes per
        channel, the scaled weights per output channel
        (`dynamic_pillar_encoder.py:55-97`). The integer product runs as an
        f32 matmul, exact while Cin * 127^2 < 2^24. `mask` (B, N) bool keeps
        padded rows out of the calibration absmax."""
        if self.quant_ready():
            s_x = activation_scale(self.in_absmax)
            w_scaled = self.weight * s_x[None, :]
            s_w = weight_scale(w_scaled)
            wq = quantize(w_scaled, (1.0 / s_w)[:, None])
            yq = F.linear(quantize(x, 1.0 / s_x).float(), wq.float())
            return (yq * (s_w * inv) + shift).to(x.dtype)
        if self.observing:
            ax = x.abs()
            if mask is not None:
                ax = ax * mask[..., None].to(ax.dtype)
            self.observe(ax.amax(dim=tuple(range(x.dim() - 1))).float())
        return F.linear(x, (self.weight * inv[:, None]).to(x.dtype),
                        shift.to(x.dtype))


@READERS.register_module
class DynamicPFE(Calibrated, nn.Module):
    def __init__(self, in_channels=5, num_filters: Sequence[int] = (32,),
                 pillar_size=0.1, pc_range=(0, -40, -3, 70.4, 40, 1),
                 dtype=torch.float32, quant=False, quant_scatter=True,
                 compact_kmax=0, device=None):
        super().__init__()
        self.spec = PillarSpec(float(pillar_size), tuple(pc_range))
        self.dtype = dtype
        self.compact_kmax = int(compact_kmax)
        self.dropped_sites = None
        dims = [2 + in_channels] + list(num_filters)
        self.num_layers = len(dims) - 1
        for k in range(self.num_layers):
            setattr(self, f"pfn_dense_{k}",
                    _PFNDense(dims[k], dims[k + 1], quant, device=device))
            setattr(self, f"pfn_bn_{k}",
                    MaskedBatchNorm(dims[k + 1], device=device))
        # the int8 scatter payload's scale (`scatter_absmax`)
        self._init_quant(quant and quant_scatter, "scatter_absmax", (),
                         device)

    def forward(self, points, points_mask):
        """points (B, N, C); points_mask (B, N) bool
        -> grid (B, H, W, F) in `dtype`, occ (B, H, W) bool; with
        `compact_kmax`: (CompactPillars, None)."""
        spec = self.spec
        x, flat_ids, valid = voxelize_points(points, points_mask, spec)
        x = x.to(self.dtype)
        train = self.training
        for k in range(self.num_layers):
            dense = getattr(self, f"pfn_dense_{k}")
            bn = getattr(self, f"pfn_bn_{k}")
            if train:
                x = bn(F.linear(x, dense.weight.to(x.dtype)), valid[..., None])
            else:
                x = dense.folded(x, *bn.fold_factors(), valid)
            x = F.relu(x)
        if self.compact_kmax > 0:
            rows, site_ids, k_valid, dropped = compact_segment_max(
                x, flat_ids, valid, spec.height * spec.width,
                self.compact_kmax)
            if not torch.compiler.is_compiling():
                self.dropped_sites = dropped
            # the backbone appends its own sentinel rows
            return CompactPillars(rows[:, :self.compact_kmax], site_ids,
                                  k_valid, spec.height, spec.width), None
        if self.quant_ready() and not train:
            # post-ReLU features quantize to nonneg codes; per-tensor
            # monotone quantization commutes with the max
            s = activation_scale(self.scatter_absmax)
            xq = torch.round(x.float() * (1.0 / s)).clamp_(0, 127)
            grid_q, occ = pillar_scatter_max(xq.to(torch.int8), flat_ids,
                                             valid, spec.height, spec.width,
                                             nonneg=True)
            # dequantize in f32 and round ONCE: q * bf16(s) would round
            # twice and flip conv1 codes near 127 (JAX commit 79bf383)
            return (grid_q.float() * s).to(self.dtype), occ
        if self.observing:
            ax = x.abs() * valid[..., None].to(x.dtype)
            self.observe(ax.amax().float())
        # post-ReLU features are >= 0: the scatter's nonneg path; bf16
        # features go through the f32 kernel (exact both ways)
        grid, occ = pillar_scatter_max(x.float(), flat_ids, valid,
                                       spec.height, spec.width, nonneg=True)
        return grid.to(self.dtype), occ
