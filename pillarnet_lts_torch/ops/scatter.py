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
"""

import torch

from . import _kernels
from .voxelize import scatter_max_to_grid

_BACKENDS = ("auto", "tiled")
_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
_ELEM = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # K1' `elem`
_BACKEND = "auto"


def set_backend(name):
    """Select the scatter-max kernel of CUDA tensors: "auto" or "tiled"."""
    global _BACKEND
    if name not in _BACKENDS:
        raise ValueError(f"scatter backend {name!r} not in {_BACKENDS}")
    _BACKEND = name


def _check(name, point_feats, flat_ids, valid, dtypes, height, width):
    """Checks shared by the two kernels' wrappers (CUDA tensors)."""
    _kernels.check_args(name, align=4, point_feats=point_feats,
                        flat_ids=flat_ids, valid=valid)
    if point_feats.dtype not in dtypes:
        names = ", ".join(_NAMES[d] for d in dtypes)
        raise TypeError(f"{name}: {names} features only, got "
                        f"{point_feats.dtype}")
    if flat_ids.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(f"{name}: ids must be int32 and valid bool, got "
                        f"{flat_ids.dtype} and {valid.dtype}")
    if point_feats.dim() != 3 or flat_ids.shape != point_feats.shape[:2] \
            or valid.shape != point_feats.shape[:2]:
        raise ValueError(f"{name}: shapes {tuple(point_feats.shape)}, "
                         f"{tuple(flat_ids.shape)}, {tuple(valid.shape)}")
    B, N, C = point_feats.shape
    if B * N >= 2**31 or B * height * width >= 2**31 or B > 65535:
        raise ValueError(f"{name}: B*N={B * N} points and B*H*W="
                         f"{B * height * width} pillars must fit int32, "
                         f"B={B} at most 65535")
    if C == 0 or C * point_feats.element_size() % 4:
        raise ValueError(f"{name}: a {point_feats.dtype} row of C={C} "
                         f"channels is not a whole number of 32-bit words")
    return B, N, C


def pillar_scatter_max(point_feats, flat_ids, valid, height, width,
                       nonneg=False):
    """(B, N, C) features + (B, N) pillar ids -> (B, H, W, C) grid, (B, H, W) occ.

    f32 features of either sign, or the int8 deploy's codes in [0, 127]
    (`nonneg=True` required); the grid comes back in the features' dtype.
    A point is dropped when it is not valid or its id lies outside
    [0, H*W). `nonneg=True` promises every valid f32 feature is >= 0
    (post-ReLU reader features); the kernel's float max is exact for both
    signs, so it serves both modes alike.
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
    B, N, C = _check(name, point_feats, flat_ids, valid,
                     (torch.float32, torch.int8), height, width)
    codes = point_feats.dtype == torch.int8
    if codes and not nonneg:
        raise ValueError(f"{name}: int8 codes need nonneg=True")
    dev = point_feats.device
    grid = torch.empty((B, height, width, C), dtype=point_feats.dtype,
                       device=dev)
    occ = torch.empty((B, height, width), dtype=torch.bool, device=dev)
    heads = torch.empty(B * height * width, dtype=torch.int32, device=dev)
    fn = _kernels.kernel(name)
    with torch.cuda.device(dev):
        err = fn(point_feats.data_ptr(), flat_ids.data_ptr(),
                 valid.data_ptr(), heads.data_ptr(), grid.data_ptr(),
                 occ.data_ptr(), B, N, C, height * width, int(codes),
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

    The contract of `pillar_scatter_max` for f32, bf16 and int8 features of
    either sign, each reduced and returned in its own dtype (as the TPU
    kernel's f32 round trip, `voxelize_kernel.py:93-96`, is exact);
    `nonneg` is accepted and ignored. The kernel makes sort keys (dropped
    points past every pillar), `torch.sort` orders them (stable), and the
    kernel reduces each pillar's run of points into its grid row: no
    atomics on the grid, so the result is deterministic. Forward only: the
    gradient comes with training.

    A CPU tensor takes the plain version; a CUDA tensor launches
    `csrc/pillar_scatter_max_tiled.cu` or raises.
    """
    del nonneg
    if point_feats.device.type == "cpu":
        return scatter_max_tiled_plain(point_feats, flat_ids, valid, height,
                                       width)

    name = "pillar_scatter_max_tiled"
    B, N, C = _check(name, point_feats, flat_ids, valid, tuple(_ELEM),
                     height, width)
    hw = height * width
    rw = C * point_feats.element_size() // 4
    dev = point_feats.device
    stream = _kernels.stream_handle(dev)
    grid = torch.empty((B, height, width, C), dtype=point_feats.dtype,
                       device=dev)
    occ = torch.empty((B, height, width), dtype=torch.bool, device=dev)
    # scratch: the sort keys, the head map and the long-run count, the list
    # of long runs (one per 128 sorted positions at most), room for the
    # pieces of long runs (a row per sorted position)
    keys, heads, runs, rows = (
        torch.empty(size, dtype=torch.int32, device=dev)
        for size in (B * N, B * hw + 1, B * N // 128 + 1, B * N * rw))
    with torch.cuda.device(dev):
        err = _kernels.kernel("pillar_scatter_max_tiled_keys")(
            flat_ids.data_ptr(), valid.data_ptr(), keys.data_ptr(), B, N, hw,
            stream)
    _kernels.raise_on_error(name, err)
    sorted_keys, perm = torch.sort(keys, stable=True)
    fn = _kernels.kernel(name)
    with torch.cuda.device(dev):
        err = fn(point_feats.data_ptr(), sorted_keys.data_ptr(),
                 perm.data_ptr(), heads.data_ptr(), runs.data_ptr(),
                 rows.data_ptr(), grid.data_ptr(), occ.data_ptr(), B, N, rw,
                 hw, _ELEM[point_feats.dtype], stream)
    _kernels.launched(name, err)
    return grid, occ
