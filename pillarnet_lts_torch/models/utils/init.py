"""Seeded weight initialisation.

Weights are drawn on the CPU from one `torch.Generator`, in module
registration order, and copied to each parameter's device, so a seed gives
the same model on every device. The distributions follow the JAX package's
initialisers in scale (He-normal, Xavier-uniform, constant biases); the
draws themselves differ from `jax.random`, so weights shared between the two
frameworks go through `runtime/convert.py`, never through a seed.
"""

import math

import torch


@torch.no_grad()
def normal_(param, std, generator):
    param.copy_(torch.randn(param.shape, generator=generator) * std)


@torch.no_grad()
def xavier_uniform_(param, fan_in, fan_out, generator):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    param.copy_((torch.rand(param.shape, generator=generator) * 2 - 1) * limit)


@torch.no_grad()
def init_weights(model, seed):
    """Re-draw every weight of `model` from `seed`."""
    g = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(g)
    return model
