"""Dense (fully connected) layer with flax's parameter names mapped.

`weight` is torch's (out, in), the flax kernel (in, out) transposed
(`runtime/convert.py`); `bias` is optional. The second stage's MLPs
(`models/roi_heads/`, `models/point_heads/`) run every Dense + BN pair
with the BN folded into the weights at eval, as the backbone folds its
convs.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .init import normal_, xavier_uniform_


class Dense(nn.Module):
    """y = x @ W^T (+ b) over the last axis of x. `init_std`: the normal
    draw's std, by default sqrt(1 / in) (flax's lecun-normal scale);
    `kernel_init` "xavier_uniform" or "zeros" replaces the normal draw;
    the bias starts at `bias_init`."""

    def __init__(self, in_features, features, use_bias=True, init_std=None,
                 kernel_init="normal", bias_init=0.0, device=None):
        super().__init__()
        self.init_std = init_std
        self.kernel_init = kernel_init
        self.bias_init = bias_init
        self.weight = nn.Parameter(
            torch.empty(features, in_features, device=device))
        self.bias = (nn.Parameter(torch.empty(features, device=device))
                     if use_bias else None)

    @torch.no_grad()
    def init_weights(self, generator):
        o, i = self.weight.shape
        if self.kernel_init == "xavier_uniform":
            xavier_uniform_(self.weight, i, o, generator)
        elif self.kernel_init == "zeros":
            self.weight.zero_()
        else:
            std = (self.init_std if self.init_std is not None
                   else (1.0 / i) ** 0.5)
            normal_(self.weight, std, generator)
        if self.bias is not None:
            self.bias.fill_(self.bias_init)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)

    def folded(self, x, inv, shift):
        """BN(x @ W^T + b) at eval with the BN's affine (inv, shift) folded
        into the weights: x @ (W * inv)^T + (b * inv + shift)."""
        b = self.bias * inv + shift if self.bias is not None else shift
        return F.linear(x, (self.weight * inv[:, None]).to(x.dtype),
                        b.to(x.dtype))


def dense_bn_relu(dense, bn, x, train):
    """Dense -> BN -> ReLU over the last axis of x; the BN folded at eval,
    batch statistics over every row (all leading axes) in training
    (`train`: the calling module's flag)."""
    if not train:
        return F.relu(dense.folded(x, *bn.fold_factors()))
    y = dense(x)
    return F.relu(bn(y.reshape(-1, y.shape[-1])).reshape(y.shape))
