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

The JAX package's other backends ('xla', 'sort') are plain JAX, not
kernels, and its MXU knobs (`set_mxu_pack`, tile rows) have no meaning on
Hopper; neither is carried over. On CPU tensors both backends run the plain
version.
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


def pillar_scatter_max(point_feats, flat_ids, valid, height, width,
                       nonneg=False):
    """(B, N, C) features + (B, N) pillar ids -> (B, H, W, C) grid, (B, H, W) occ.

    `nonneg=True` promises every valid feature is >= 0 (post-ReLU reader
    features); the kernel then max-combines float bit patterns directly.
    int8 features are the int8 deploy's codes, in [0, 127] (`nonneg=True`
    required); the grid then holds the per-pillar max codes as int8.
    A CPU tensor takes the plain version; a CUDA tensor launches
    `csrc/pillar_scatter_max.cu` (f32 or int8 codes), or with
    `set_backend("tiled")` `csrc/pillar_scatter_max_tiled.cu`, or raises.
    """
    if _BACKEND == "tiled":
        return pillar_scatter_max_tiled(point_feats, flat_ids, valid, height,
                                        width, nonneg)
    if point_feats.device.type == "cpu":
        return scatter_max_to_grid(point_feats, flat_ids, valid, height, width)

    name = "pillar_scatter_max"
    _kernels.check_args(name, point_feats=point_feats, flat_ids=flat_ids,
                        valid=valid)
    if point_feats.dtype == torch.int8:
        return _scatter_codes(point_feats, flat_ids, valid, height, width,
                              nonneg)
    if point_feats.dtype != torch.float32:
        raise TypeError(f"{name}: f32 features or int8 codes only, got "
                        f"{point_feats.dtype}")
    if flat_ids.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(f"{name}: ids must be int32 and valid bool, got "
                        f"{flat_ids.dtype} and {valid.dtype}")
    if point_feats.dim() != 3 or flat_ids.shape != point_feats.shape[:2] \
            or valid.shape != point_feats.shape[:2]:
        raise ValueError(f"{name}: shapes {tuple(point_feats.shape)}, "
                         f"{tuple(flat_ids.shape)}, {tuple(valid.shape)}")

    B, N, C = point_feats.shape
    dev = point_feats.device
    # the nonneg path max-combines int bit patterns over +0.0; the signed
    # path runs in an order-preserving uint32 code and decodes in place
    grid = torch.zeros((B, height, width, C), dtype=torch.int32, device=dev)
    occ = torch.zeros((B, height, width), dtype=torch.bool, device=dev)
    fn = _kernels.kernel(name)
    with torch.cuda.device(dev):
        err = fn(point_feats.data_ptr(), flat_ids.data_ptr(),
                 valid.data_ptr(), grid.data_ptr(), occ.data_ptr(), B, N, C,
                 height * width, int(bool(nonneg)),
                 _kernels.stream_handle(dev))
    _kernels.launched(name, err)
    return grid.view(torch.float32), occ


def _scatter_codes(codes, flat_ids, valid, height, width, nonneg):
    """int8 code mode of the kernel (checked CUDA tensors)."""
    name = "pillar_scatter_max"
    B, N, C = codes.shape
    if not nonneg or C % 4:
        raise ValueError(f"{name}: int8 codes need nonneg=True and channels "
                         f"in multiples of 4, got nonneg={nonneg}, C={C}")
    if flat_ids.dtype != torch.int32 or valid.dtype != torch.bool \
            or flat_ids.shape != (B, N) or valid.shape != (B, N):
        raise ValueError(f"{name}: ids {flat_ids.dtype} {tuple(flat_ids.shape)}"
                         f", valid {valid.dtype} {tuple(valid.shape)}")
    _kernels.check_args(name, align=4, codes=codes)
    dev = codes.device
    grid = torch.zeros((B, height, width, C), dtype=torch.int8, device=dev)
    occ = torch.zeros((B, height, width), dtype=torch.bool, device=dev)
    fn = _kernels.kernel("pillar_scatter_max_i8")
    with torch.cuda.device(dev):
        err = fn(codes.data_ptr(), flat_ids.data_ptr(), valid.data_ptr(),
                 grid.data_ptr(), occ.data_ptr(), B, N, C, height * width,
                 _kernels.stream_handle(dev))
    _kernels.launched(name, err)
    return grid, occ


def scatter_max_tiled_plain(point_feats, flat_ids, valid, height, width):
    """Plain version of the sorted-run kernel: the scatter-max in f32, the
    grid cast back to the input dtype (exact: a max of the inputs)."""
    grid, occ = scatter_max_to_grid(point_feats.float(), flat_ids, valid,
                                    height, width)
    return grid.to(point_feats.dtype), occ


def pillar_scatter_max_tiled(point_feats, flat_ids, valid, height, width,
                             nonneg=False):
    """`pillar_scatter_max` through the sorted-run kernel (K1').

    The contract of `pillar_scatter_max` in its signed f32 mode: bf16
    features (and the int8 deploy's codes) go through f32 and come back in
    their dtype, as the TPU kernel casts (`voxelize_kernel.py:93-96`);
    `nonneg` is accepted and ignored. The points are sorted by pillar id
    here (`torch.sort`, stable; dropped points last) and the kernel reduces
    each pillar's run of points with one owner thread per channel: no
    atomics. Forward only: the gradient comes with training.

    A CPU tensor takes the plain version; a CUDA tensor launches
    `csrc/pillar_scatter_max_tiled.cu` or raises.
    """
    del nonneg
    if point_feats.device.type == "cpu":
        return scatter_max_tiled_plain(point_feats, flat_ids, valid, height,
                                       width)

    name = "pillar_scatter_max_tiled"
    _kernels.check_args(name, point_feats=point_feats, flat_ids=flat_ids,
                        valid=valid)
    if point_feats.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise TypeError(f"{name}: f32, bf16 or int8 features only, got "
                        f"{point_feats.dtype}")
    if flat_ids.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(f"{name}: ids must be int32 and valid bool, got "
                        f"{flat_ids.dtype} and {valid.dtype}")
    if point_feats.dim() != 3 or flat_ids.shape != point_feats.shape[:2] \
            or valid.shape != point_feats.shape[:2]:
        raise ValueError(f"{name}: shapes {tuple(point_feats.shape)}, "
                         f"{tuple(flat_ids.shape)}, {tuple(valid.shape)}")

    B, N, C = point_feats.shape
    hw = height * width
    if N >= 2**31:
        raise ValueError(f"{name}: N={N} points must fit int32")
    dev = point_feats.device
    feats = point_feats.float().contiguous()
    keep = valid & (flat_ids >= 0) & (flat_ids < hw)
    ids = torch.where(keep, flat_ids, hw)
    sorted_ids, order = torch.sort(ids, dim=1, stable=True)
    order = order.to(torch.int32)
    grid = torch.zeros((B, height, width, C), dtype=torch.float32, device=dev)
    occ = torch.zeros((B, height, width), dtype=torch.bool, device=dev)
    fn = _kernels.kernel(name)
    with torch.cuda.device(dev):
        err = fn(feats.data_ptr(), sorted_ids.data_ptr(), order.data_ptr(),
                 grid.data_ptr(), occ.data_ptr(), B, N, C, hw,
                 _kernels.stream_handle(dev))
    _kernels.launched(name, err)
    return grid.to(point_feats.dtype), occ
