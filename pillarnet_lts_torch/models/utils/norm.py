"""Masked BatchNorm, eval path.

Port of `pillarnet_lts_tpu/models/utils/norm.py::MaskedBatchNorm`. At eval
the norm is an affine y = x * inv + shift that the port folds into the
preceding conv or matmul (`fold_factors`); `forward` applies it unfolded,
as the JAX package does after a transposed conv. Masked training statistics
(mean/var over active sites only) come with the training slice.

Parameter names follow torch (`weight`, `bias`, `running_mean`,
`running_var`); `runtime/convert.py` maps them from flax's
`scale`/`bias`/`mean`/`var`.
"""

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    def __init__(self, features, eps=1e-3, device=None):
        super().__init__()
        self.eps = eps
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

    def forward(self, x):
        """x (B, C, H, W) -> (x - mean) * inv + bias, per channel, computed
        in f32 and cast back to x.dtype (the JAX package's eval order)."""
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean[:, None, None]) \
            * inv[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)
