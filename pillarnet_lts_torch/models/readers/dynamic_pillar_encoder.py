"""Dynamic pillar feature encoder (reader), eval path.

Port of `pillarnet_lts_tpu/models/readers/dynamic_pillar_encoder.py`:

  padded points -> per-point pillar ids + [dx_c, dy_c, raw] features
  -> shared Linear + BN + ReLU MLP, BN folded into the weights
  -> scatter-max straight into the dense (B, H, W, F) BEV grid + occupancy.

The int8 and compact branches of the JAX reader wait for the int8 slice.
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.scatter import pillar_scatter_max
from ...ops.voxelize import PillarSpec, voxelize_points
from ..registry import READERS
from ..utils.init import normal_
from ..utils.norm import MaskedBatchNorm


class _PFNDense(nn.Module):
    """Bias-free Linear of the shared per-point MLP; `weight` is (out, in)
    (the flax kernel transposed)."""

    def __init__(self, in_features, features, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(features, in_features, device=device))

    @torch.no_grad()
    def init_weights(self, generator):
        normal_(self.weight, (2.0 / self.weight.shape[1]) ** 0.5, generator)

    def folded(self, x, inv, shift):
        """BN(x @ W) = x @ (W * inv) + shift."""
        return F.linear(x, self.weight * inv[:, None], shift)


@READERS.register_module
class DynamicPFE(nn.Module):
    def __init__(self, in_channels=5, num_filters: Sequence[int] = (32,),
                 pillar_size=0.1, pc_range=(0, -40, -3, 70.4, 40, 1),
                 device=None):
        super().__init__()
        self.spec = PillarSpec(float(pillar_size), tuple(pc_range))
        dims = [2 + in_channels] + list(num_filters)
        self.num_layers = len(dims) - 1
        for k in range(self.num_layers):
            setattr(self, f"pfn_dense_{k}",
                    _PFNDense(dims[k], dims[k + 1], device=device))
            setattr(self, f"pfn_bn_{k}",
                    MaskedBatchNorm(dims[k + 1], device=device))

    def forward(self, points, points_mask):
        """points (B, N, C); points_mask (B, N) bool
        -> grid (B, H, W, F), occ (B, H, W) bool."""
        spec = self.spec
        x, flat_ids, valid = voxelize_points(points, points_mask, spec)
        for k in range(self.num_layers):
            inv, shift = getattr(self, f"pfn_bn_{k}").fold_factors()
            x = F.relu(getattr(self, f"pfn_dense_{k}").folded(x, inv, shift))
        # post-ReLU features are >= 0: the scatter's nonneg path
        return pillar_scatter_max(x, flat_ids, valid, spec.height,
                                  spec.width, nonneg=True)
