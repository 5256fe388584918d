"""Token and channel mixing layers over the RoI grid tokens.

Port of `pillarnet_lts_tpu/models/roi_heads/mlp_layers.py` (`MLPMixer`,
`Affine`, `ResMLPLayer`) over (B * R, num_patches, C) tokens, with the
flax submodule and parameter names (`token_ln`, `token_fc1`, ...,
`token_scale`, `alpha`, `beta`), so `runtime/convert.py` loads them.

The dtypes follow flax's promotions: a Dense or LayerNorm built with the
compute `dtype` returns that dtype (a Dense casts its input to it), and a
residual sum or a product with an f32 parameter promotes to f32, so the
token stream stays in the dtype it arrives in (f32 from the grid pooling)
while the branches compute in `dtype`. flax's `nn.gelu` is the tanh
approximation; its LayerNorm takes eps 1e-6 and f32 statistics
(`models/utils/norm.py::LayerNorm`). The token Dense acts on the swapped
(B * R, C, num_patches) view.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.dense import Dense
from ..utils.norm import LayerNorm


def gelu(x):
    """flax's `nn.gelu` (approximate=True)."""
    return F.gelu(x, approximate="tanh")


class MLPMixer(nn.Module):
    def __init__(self, in_channels, num_patches, expansion_factor=4,
                 expansion_factor_token=0.5, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        inner = int(num_patches * expansion_factor)
        inner_c = int(in_channels * expansion_factor_token)
        self.token_ln = LayerNorm(in_channels, device=device)
        self.token_fc1 = Dense(num_patches, inner, device=device)
        self.token_fc2 = Dense(inner, num_patches, device=device)
        self.channel_ln = LayerNorm(in_channels, device=device)
        self.channel_fc1 = Dense(in_channels, inner_c, device=device)
        self.channel_fc2 = Dense(inner_c, in_channels, device=device)

    def forward(self, x):
        """x (N, num_patches, C) -> (N, num_patches, C)."""
        d = self.dtype
        y = self.token_ln(x, d).transpose(-1, -2)
        y = self.token_fc2(gelu(self.token_fc1(y)))
        x = x + y.transpose(-1, -2)
        y = self.channel_fc1(self.channel_ln(x, d))
        return x + self.channel_fc2(gelu(y))


class Affine(nn.Module):
    """alpha * x + beta, per channel, f32 parameters of shape (1, 1, C)."""

    def __init__(self, dim, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(1, 1, dim, device=device))
        self.beta = nn.Parameter(torch.empty(1, 1, dim, device=device))
        self.init_weights(None)

    @torch.no_grad()
    def init_weights(self, generator):
        del generator  # flax's: ones and zeros
        self.alpha.fill_(1.0)
        self.beta.zero_()

    def forward(self, x):
        return self.alpha * x + self.beta


class ResMLPLayer(nn.Module):
    def __init__(self, in_channels, num_patches, expansion_factor=2,
                 layer_scale_init=1e-4, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.layer_scale_init = layer_scale_init
        self.token_scale = nn.Parameter(
            torch.empty(in_channels, device=device))
        self.channel_scale = nn.Parameter(
            torch.empty(in_channels, device=device))
        self.token_aff = Affine(in_channels, device)
        self.token_fc = Dense(num_patches, num_patches, device=device)
        self.channel_aff = Affine(in_channels, device)
        self.channel_fc1 = Dense(in_channels, in_channels * expansion_factor,
                                 device=device)
        self.channel_fc2 = Dense(in_channels * expansion_factor, in_channels,
                                 device=device)
        self.post_aff = Affine(in_channels, device)
        self.init_weights(None)

    @torch.no_grad()
    def init_weights(self, generator):
        del generator  # flax's: constant layer_scale_init
        self.token_scale.fill_(self.layer_scale_init)
        self.channel_scale.fill_(self.layer_scale_init)

    def forward(self, x):
        """x (N, num_patches, C) -> (N, num_patches, C), in f32 (the
        affines' f32 parameters promote it)."""
        d = self.dtype
        x = self.token_aff(x)
        y = self.token_fc(x.transpose(-1, -2).to(d)).transpose(-1, -2)
        x = x + self.token_scale * y
        x = self.channel_aff(x)
        y = self.channel_fc2(gelu(self.channel_fc1(x.to(d))))
        x = x + self.channel_scale * y
        return self.post_aff(x)
