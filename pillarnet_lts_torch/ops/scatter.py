"""Pillar scatter-max: the Hopper kernel for CUDA tensors, the plain version
for CPU tensors.

Port of `pillarnet_lts_tpu/ops/scatter.py`. The TPU backend knobs
(`set_backend`, `set_mxu_pack`, tile rows) have no meaning on Hopper and are
not carried over: the device of the input decides.
"""

import torch

from . import _kernels
from .voxelize import scatter_max_to_grid


def pillar_scatter_max(point_feats, flat_ids, valid, height, width,
                       nonneg=False):
    """(B, N, C) features + (B, N) pillar ids -> (B, H, W, C) grid, (B, H, W) occ.

    `nonneg=True` promises every valid feature is >= 0 (post-ReLU reader
    features); the kernel then max-combines float bit patterns directly.
    int8 features are the int8 deploy's codes, in [0, 127] (`nonneg=True`
    required); the grid then holds the per-pillar max codes as int8.
    A CPU tensor takes the plain version; a CUDA tensor launches
    `csrc/pillar_scatter_max.cu` (f32 or int8 codes) or raises.
    """
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
