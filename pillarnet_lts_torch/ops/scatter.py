"""Pillar scatter-max: the Hopper kernels for CUDA tensors, the plain
version for CPU tensors.

Port of `pillarnet_lts_tpu/ops/scatter.py`. Two kernels compute the same
function, picked by `set_backend`, the counterpart of the JAX package's
switch between its TPU kernels:

- "auto" (default): `pillar_scatter_max`, the atomic-max kernel
  (`csrc/pillar_scatter_max.cu`), the counterpart of the default TPU kernel
  `pillar_scatter_max_mxu`;
- "tiled": `pillar_scatter_max_tiled`, the sorted-run kernel
  (`csrc/pillar_scatter_max_tiled.cu`), the counterpart of
  `set_backend('pallas')` (`pillar_scatter_max_pallas`).

Both write each element of the grid once, the occupied rows where they
reduce them and the rest in one streaming pass (`csrc/pillar_grid.cuh`),
so the grid and the occupancy come from `torch.empty`: no zero fill, no
cast. The JAX package's other backends ('xla', 'sort') are plain JAX,
not kernels, and its MXU knobs (`set_mxu_pack`, tile rows) have no meaning
on Hopper; neither is carried over. On CPU tensors both backends run the
plain version.

`pillar_scatter_max` is differentiable in the point features: the ops
`pillarnet::pillar_scatter_max` and `pillarnet::pillar_scatter_max_tiled`
(`ops/library.py`, where the launches live) carry the TPU kernels' custom
VJP (`voxelize_kernel.py:853-890`, XLA there, `scatter_max_backward`
here), which hands a pillar's whole gradient to every valid point equal to
its max, so tied points each receive it (a split, as `scatter_reduce_`'s or
JAX's XLA `segment_max` gradient gives, is not what the TPU path trains
with). The occupancy has no gradient.
"""

import torch

from . import _kernels
from .voxelize import scatter_max_to_grid

_BACKENDS = ("auto", "tiled")
_BACKEND = "auto"


def set_backend(name):
    """Select the scatter-max kernel of CUDA tensors: "auto" or "tiled"."""
    global _BACKEND
    if name not in _BACKENDS:
        raise ValueError(f"scatter backend {name!r} not in {_BACKENDS}")
    _BACKEND = name


def scatter_max_backward(point_feats, flat_ids, valid, grid, dgrid):
    """The gradient of the scatter-max's point features: dgrid (B, H, W, C)
    at each valid point's pillar where its feature equals the grid's max
    there, else 0 (torch ops: one gather of the grid's and of dgrid's rows,
    a compare, a select)."""
    B, N, C = point_feats.shape
    hw = grid.shape[1] * grid.shape[2]
    rows = (flat_ids.long().clamp(0, hw - 1)
            + hw * torch.arange(B, device=flat_ids.device)[:, None])
    rows = rows.reshape(-1)
    g_at = grid.reshape(B * hw, C).index_select(0, rows)
    d_at = dgrid.reshape(B * hw, C).index_select(0, rows)
    winner = (point_feats.reshape(B * N, C) == g_at) & valid.reshape(B * N, 1)
    return torch.where(winner, d_at, 0).reshape(B, N, C)


def pillar_scatter_max(point_feats, flat_ids, valid, height, width,
                       nonneg=False):
    """(B, N, C) features + (B, N) pillar ids -> (B, H, W, C) grid, (B, H, W) occ.

    f32 features of either sign, or the int8 deploy's codes in [0, 127]
    (`nonneg=True` required); the grid comes back in the features' dtype.
    A point is dropped when it is not valid or its id lies outside
    [0, H*W). `nonneg=True` promises every valid f32 feature is >= 0
    (post-ReLU reader features); the kernel's float max is exact for both
    signs, so it serves both modes alike.
    The op `pillarnet::pillar_scatter_max`: a CPU tensor takes the plain
    version; a CUDA tensor launches `csrc/pillar_scatter_max.cu` (f32 or
    int8 codes), or raises. With `set_backend("tiled")`,
    `pillar_scatter_max_tiled`'s op. Float features that require grad get
    the TPU kernels' gradient.
    """
    if _BACKEND == "tiled":
        return pillar_scatter_max_tiled(point_feats, flat_ids, valid, height,
                                        width, nonneg)
    _kernels.check_device("pillar_scatter_max", point_feats)
    return torch.ops.pillarnet.pillar_scatter_max(point_feats, flat_ids,
                                                  valid, height, width,
                                                  nonneg)


def scatter_max_tiled_plain(point_feats, flat_ids, valid, height, width):
    """Plain version of the sorted-run kernel: the scatter-max in f32, the
    grid cast back to the input dtype (exact: a max of the inputs)."""
    grid, occ = scatter_max_to_grid(point_feats.float(), flat_ids, valid,
                                    height, width)
    return grid.to(point_feats.dtype), occ


def pillar_scatter_max_tiled(point_feats, flat_ids, valid, height, width,
                             nonneg=False):
    """`pillar_scatter_max` through the sorted-run kernel (K1').

    The contract of `pillar_scatter_max` for f32, bf16 and int8 features of
    either sign, each reduced and returned in its own dtype (as the TPU
    kernel's f32 round trip, `voxelize_kernel.py:93-96`, is exact);
    `nonneg` is accepted and ignored. The kernel makes sort keys (dropped
    points past every pillar), `torch.sort` orders them (stable), and the
    kernel reduces each pillar's run of points into its grid row: no
    atomics on the grid, so the result is deterministic. It carries
    `pillar_scatter_max`'s gradient.

    The op `pillarnet::pillar_scatter_max_tiled`: a CPU tensor takes the
    plain version; a CUDA tensor launches `csrc/pillar_scatter_max_tiled.cu`
    or raises.
    """
    _kernels.check_device("pillar_scatter_max_tiled", point_feats)
    return torch.ops.pillarnet.pillar_scatter_max_tiled(
        point_feats, flat_ids, valid, height, width, nonneg)
