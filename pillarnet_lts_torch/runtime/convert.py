"""Carry the JAX package's weights into the port.

`load_jax_variables(model, variables)` takes the JAX package's
`{'params': ..., 'batch_stats': ...}` tree with numpy leaves and fills the
port's tensors. The port's module paths mirror the flax ones, so the map is
a per-leaf transform:

  flax                                       port
  -----------------------------------------  ------------------------------
  conv `kernel` (kh, kw, I, O)               MaskedConv.weight (O, I, kh, kw)
  _PFNDense `kernel` (I, O)                  _PFNDense.weight (O, I)
  Dense `kernel` (I, O) / `bias`             Dense.weight (O, I) / bias
  ConvTranspose `kernel` (kh, kw, I, O)      ConvTranspose.weight
                                             (I, O, kh, kw), spatially flipped
  BN `scale` / `bias`                        weight / bias
  BN batch_stats `mean` / `var`              running_mean / running_var
  LayerNorm `scale` / `bias`                 LayerNorm.weight / bias
  Affine `alpha` / `beta` (1, 1, C)          Affine.alpha / beta
  ResMLP `token_scale` / `channel_scale`     ResMLPLayer.token_scale / ...
  quant `in_absmax` (conv: (), PFN: (Cin,))  in_absmax (then calibrated)
  quant `scatter_absmax` (reader)            DynamicPFE.scatter_absmax

The flip: flax's ConvTranspose correlates the zero-dilated input with an
unflipped kernel, while torch's conv_transpose2d places `w[:, :, i, j]` at
output offset (i, j) — mirrored relative to that (the inverse of
`pillarnet_lts_tpu/runtime/torch_convert.py::_t_convT`).

The load is strict: every leaf of `variables` is consumed exactly once and
every port tensor is filled, else it raises and names the paths. The int8
calibration (the 'quant' collection of a calibrated JAX model) is one
unit: without a 'quant' collection the quant buffers stay unset and the
model uncalibrated; with one, every quant buffer must be in it. Reference
`.pth` checkpoints are a different naming (the reference's module names);
`runtime/torch_convert.py` maps them onto `variables_of(model)`, the
model's own weights in flax layout.
"""

import re
from collections.abc import Mapping

import numpy as np
import torch

from ..models.backbones.base import MaskedConv
from ..models.necks.rpn import ConvTranspose
from ..models.readers.dynamic_pillar_encoder import DynamicPFE, _PFNDense
from ..models.roi_heads.mlp_layers import Affine, ResMLPLayer
from ..models.utils.dense import Dense
from ..models.utils.norm import LayerNorm, MaskedBatchNorm


def _conv_kernel(w):
    return np.transpose(w, (3, 2, 0, 1))


def _dense_kernel(w):
    return np.transpose(w, (1, 0))


def _conv_transpose_kernel(w):
    return np.transpose(w[::-1, ::-1], (2, 3, 0, 1))


# module type -> {tensor attribute: (collection, flax leaf, transform)}
_LEAVES = {
    MaskedConv: {"weight": ("params", "kernel", _conv_kernel),
                 "bias": ("params", "bias", None),
                 "in_absmax": ("quant", "in_absmax", None)},
    _PFNDense: {"weight": ("params", "kernel", _dense_kernel),
                "in_absmax": ("quant", "in_absmax", None)},
    Dense: {"weight": ("params", "kernel", _dense_kernel),
            "bias": ("params", "bias", None)},
    DynamicPFE: {"scatter_absmax": ("quant", "scatter_absmax", None)},
    ConvTranspose: {"weight": ("params", "kernel", _conv_transpose_kernel)},
    MaskedBatchNorm: {"weight": ("params", "scale", None),
                      "bias": ("params", "bias", None),
                      "running_mean": ("batch_stats", "mean", None),
                      "running_var": ("batch_stats", "var", None)},
    LayerNorm: {"weight": ("params", "scale", None),
                "bias": ("params", "bias", None)},
    Affine: {"alpha": ("params", "alpha", None),
             "beta": ("params", "beta", None)},
    ResMLPLayer: {"token_scale": ("params", "token_scale", None),
                  "channel_scale": ("params", "channel_scale", None)},
}


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _targets(model):
    """{flax path tuple: (port tensor, transform, port name)}."""
    out = {}
    for name, mod in model.named_modules():
        spec = _LEAVES.get(type(mod))
        if spec is None:
            own = list(mod.parameters(recurse=False)) + list(
                mod.buffers(recurse=False))
            if own:
                raise TypeError(f"no weight mapping for {type(mod).__name__} "
                                f"at {name!r}")
            continue
        path = tuple(name.split(".")) if name else ()
        for attr, (coll, leaf, fn) in spec.items():
            t = getattr(mod, attr, None)
            if t is not None:
                out[(coll,) + path + (leaf,)] = (t, fn, f"{name}.{attr}", mod)
    return out


def load_jax_variables(model, variables):
    """Fill `model` from a JAX variables tree with numpy leaves; strict.
    A 'quant' collection also calibrates the model's int8 modules."""
    flat = _flatten(variables)
    targets = _targets(model)
    if "quant" not in variables:
        targets = {k: v for k, v in targets.items() if k[0] != "quant"}

    def fmt(keys):
        return ", ".join("/".join(k) for k in sorted(keys))

    missing = set(targets) - set(flat)
    extra = set(flat) - set(targets)
    if missing or extra:
        raise KeyError(
            "JAX variables do not match the port model; "
            f"missing: [{fmt(missing)}]; unused: [{fmt(extra)}]")
    with torch.no_grad():
        for key, (t, fn, name, mod) in targets.items():
            arr = np.asarray(flat[key], dtype=np.float32)
            if fn is not None:
                arr = fn(arr)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{'/'.join(key)} -> {name}: shape "
                                 f"{tuple(arr.shape)} != {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(arr, order="C")))
            if key[0] == "quant":
                mod.calibrated = True
    return model


# transform -> its inverse: a port tensor back to the flax leaf
_TO_FLAX = {
    _conv_kernel: lambda w: np.transpose(w, (2, 3, 1, 0)),
    _dense_kernel: lambda w: np.transpose(w, (1, 0)),
    _conv_transpose_kernel: lambda w: np.transpose(w, (2, 3, 0, 1))[::-1,
                                                                    ::-1],
}


def variables_of(model):
    """The model's current weights as a flax-layout tree ('params' and
    'batch_stats', f32 numpy), the inverse of `load_jax_variables`: a
    template whose leaves keep the model's values where a non-strict
    conversion fills nothing."""
    tree = {}
    for key, (t, fn, _, _) in _targets(model).items():
        if key[0] == "quant":
            continue
        w = t.detach().float().cpu().numpy()
        node = tree
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = np.ascontiguousarray(
            w if fn is None else _TO_FLAX[fn](w))
    return tree


_KEYSTR = re.compile(r"\['([^']*)'\]")


def variables_from_keystr(arrays):
    """Nest path-keyed leaves (`"var:['params']['reader_net'][...]"`, the
    golden fixtures' `jax.tree_util.keystr` form) into a variables tree.
    Keys without the `var:` prefix are skipped."""
    tree = {}
    for key, value in arrays.items():
        if not key.startswith("var:"):
            continue
        body = key[len("var:"):]
        parts = _KEYSTR.findall(body)
        if not parts or "".join(f"['{p}']" for p in parts) != body:
            raise ValueError(f"unparsable variable key {key!r}")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value)
    return tree
