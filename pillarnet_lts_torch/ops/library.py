"""The port's hand kernels as `torch.library` custom ops (`pillarnet::*`).

One op per kernel of `ops/_kernels.py::KERNELS`; the kernel modules' public
functions (`ops/scatter.py`, `ops/iou3d.py`, `ops/nms.py`, `ops/quant.py`,
`ops/int8_stage.py`) reach the kernels only through these ops:

  op                                    kernel (`csrc/`)
  ------------------------------------  ---------------------------------
  pillar_scatter_max                    K1, pillar_scatter_max.cu
  pillar_scatter_max_tiled              K1', pillar_scatter_max_tiled.cu
                                        (its sort keys, the sort, its
                                        scatter: one op)
  rotated_overlap                       K2, rotated_overlap.cu
  suppression_mask                      K3, suppression_mask.cu
  suppression_mask_corners              K3's staged corners (a check)
  int8_conv, int8_conv_f32              K4, int8_conv.cu (bf16 / f32)
  int8_stage, int8_stage_f32            K5, int8_stage.cu (bf16 / f32)

Each op has three implementations: on CUDA tensors the ctypes launch of the
kernel on torch's current stream (it counts in `_kernels.LAUNCHES`), on CPU
tensors the kernel's plain version, and a fake one that gives the exact
output shapes and dtypes. So the ops are opaque to `torch.export`: a traced
graph holds `torch.ops.pillarnet.*` nodes, never a data pointer, and an
exported program launches the same kernels when it runs on the card. The two
scatter-max ops carry the TPU kernels' gradient (`scatter.
scatter_max_backward`) through `torch.library.register_autograd`.

This module imports torch, `_kernels` and the plain versions only: it is
the one import of the package that a process loading an exported program
(`runtime/export.py::load_serving`) needs.
"""

import math
from typing import Optional, Tuple

import torch

from . import _kernels
from .int8_stage import CHANNELS, int8_stage_plain
from .iou3d import _pairwise_area_plain, check_pair_tiles
from .nms import _suppression_matrix_plain, mask_kernel_corners
from .quant import int8_conv_bn_act_plain, unpack_kernel
from .scatter import scatter_max_backward, scatter_max_tiled_plain
from .voxelize import scatter_max_to_grid

NAMESPACE = "pillarnet"

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
_ELEM = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # K1' `elem`
# K4's tiling: input channels in chunks of 32, output channels in tiles of
# 32 or 64
_CIN_CHUNK = 32
_COUT_TILE = 32


def _op(name, device_types="cpu"):
    """Declare `pillarnet::name`; the decorated function is its
    implementation for `device_types` (the plain version)."""
    return torch.library.custom_op(f"{NAMESPACE}::{name}", mutates_args=(),
                                   device_types=device_types)


# --- K1 and K1': the pillar scatter-max ------------------------------------

def _check_scatter(name, point_feats, flat_ids, valid, dtypes, height,
                   width):
    """Checks shared by the two scatter-max kernels (CUDA tensors)."""
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


def _grid_outputs(point_feats, height, width):
    B, _, C = point_feats.shape
    grid = point_feats.new_empty((B, height, width, C))
    occ = point_feats.new_empty((B, height, width), dtype=torch.bool)
    return grid, occ


@_op("pillar_scatter_max")
def pillar_scatter_max(point_feats: torch.Tensor, flat_ids: torch.Tensor,
                       valid: torch.Tensor, height: int, width: int,
                       nonneg: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (B, N, C) f32 features (or int8 codes with `nonneg`) + (B, N)
    pillar ids -> (B, H, W, C) grid, (B, H, W) occupancy."""
    return scatter_max_to_grid(point_feats, flat_ids, valid, height, width)


@pillar_scatter_max.register_kernel("cuda")
def _pillar_scatter_max_cuda(point_feats, flat_ids, valid, height, width,
                             nonneg):
    name = "pillar_scatter_max"
    B, N, C = _check_scatter(name, point_feats, flat_ids, valid,
                             (torch.float32, torch.int8), height, width)
    codes = point_feats.dtype == torch.int8
    if codes and not nonneg:
        raise ValueError(f"{name}: int8 codes need nonneg=True")
    dev = point_feats.device
    # the kernel writes every element of both: no fill
    grid, occ = _grid_outputs(point_feats, height, width)
    heads = torch.empty(B * height * width, dtype=torch.int32, device=dev)
    fn = _kernels.kernel(name)
    with torch.cuda.device(dev):
        err = fn(point_feats.data_ptr(), flat_ids.data_ptr(),
                 valid.data_ptr(), heads.data_ptr(), grid.data_ptr(),
                 occ.data_ptr(), B, N, C, height * width, int(codes),
                 _kernels.stream_handle(dev))
    _kernels.launched(name, err)
    return grid, occ


@_op("pillar_scatter_max_tiled")
def pillar_scatter_max_tiled(point_feats: torch.Tensor,
                             flat_ids: torch.Tensor, valid: torch.Tensor,
                             height: int, width: int, nonneg: bool
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1': the contract of `pillar_scatter_max` for f32, bf16 and int8
    features of either sign (`nonneg` is ignored), through the sorted-run
    kernel."""
    return scatter_max_tiled_plain(point_feats, flat_ids, valid, height,
                                   width)


@pillar_scatter_max_tiled.register_kernel("cuda")
def _pillar_scatter_max_tiled_cuda(point_feats, flat_ids, valid, height,
                                   width, nonneg):
    del nonneg
    name = "pillar_scatter_max_tiled"
    B, N, C = _check_scatter(name, point_feats, flat_ids, valid,
                             tuple(_ELEM), height, width)
    hw = height * width
    rw = C * point_feats.element_size() // 4
    dev = point_feats.device
    stream = _kernels.stream_handle(dev)
    grid, occ = _grid_outputs(point_feats, height, width)
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


def _scatter_fake(point_feats, flat_ids, valid, height, width, nonneg):
    return _grid_outputs(point_feats, height, width)


def _scatter_setup(ctx, inputs, output):
    point_feats, flat_ids, valid = inputs[:3]
    ctx.save_for_backward(point_feats, flat_ids, valid, output[0])


def _scatter_backward(ctx, dgrid, docc):
    """The TPU kernels' VJP: dgrid at each valid point's pillar where its
    feature equals the max there, else 0; the occupancy has no gradient."""
    del docc
    return (scatter_max_backward(*ctx.saved_tensors, dgrid),
            None, None, None, None, None)


for _scatter in (pillar_scatter_max, pillar_scatter_max_tiled):
    _scatter.register_fake(_scatter_fake)
    _scatter.register_autograd(_scatter_backward, setup_context=_scatter_setup)


# --- K2: the rotated overlap -----------------------------------------------

@_op("rotated_overlap")
def rotated_overlap(a_quad: torch.Tensor, b_quad: torch.Tensor
                    ) -> torch.Tensor:
    """K2: pairwise intersection areas of convex CCW quads, (..., Ka, 4, 2)
    x (..., Kb, 4, 2) -> (..., Ka, Kb) f32."""
    return _pairwise_area_plain(a_quad, b_quad)


@rotated_overlap.register_kernel("cuda")
def _rotated_overlap_cuda(a_quad, b_quad):
    name = "rotated_overlap"
    if a_quad.dtype != torch.float32 or b_quad.dtype != torch.float32:
        raise TypeError(f"{name}: f32 corners only, got {a_quad.dtype}, "
                        f"{b_quad.dtype}")
    batch = a_quad.shape[:-3]
    if (a_quad.shape[-2:] != (4, 2) or b_quad.shape[-2:] != (4, 2)
            or b_quad.shape[:-3] != batch):
        raise ValueError(f"{name}: shapes {tuple(a_quad.shape)}, "
                         f"{tuple(b_quad.shape)}")
    ka, kb = a_quad.shape[-3], b_quad.shape[-3]
    t = math.prod(batch)
    check_pair_tiles(name, t, ka, kb)
    a = a_quad.contiguous()
    b = b_quad.contiguous()
    _kernels.check_args(name, a_quad=a, b_quad=b)
    out = torch.empty(batch + (ka, kb), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out  # nothing to launch
    fn = _kernels.kernel(name)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), t, ka, kb,
                 _kernels.stream_handle(a.device))
    _kernels.launched(name, err)
    return out


@rotated_overlap.register_fake
def _rotated_overlap_fake(a_quad, b_quad):
    return a_quad.new_empty(a_quad.shape[:-3]
                            + (a_quad.shape[-3], b_quad.shape[-3]),
                            dtype=torch.float32)


# --- K3: the suppression mask ----------------------------------------------

@_op("suppression_mask")
def suppression_mask(boxes: torch.Tensor, thresh: Optional[torch.Tensor],
                     value: float) -> torch.Tensor:
    """K3: (R, K, 7+) det3d boxes, score-descending, and the IoU threshold
    of each row ((R,) f32 `thresh`, or `value` for all rows when `thresh`
    is None) -> (R, K, K) f32 mask M[r, j, i] = (j < i) * (IoU(j, i) >
    thresh[r])."""
    R = boxes.shape[0]
    th = thresh if thresh is not None else torch.full((R,), value)
    return _suppression_matrix_plain(*mask_kernel_corners(boxes), th)


@suppression_mask.register_kernel("cuda")
def _suppression_mask_cuda(boxes, thresh, value):
    name = "suppression_mask"
    R, K, D = boxes.shape
    check_pair_tiles(name, R, K, K)
    boxes = boxes.float().contiguous()
    tensors = {"boxes": boxes}
    if thresh is not None:
        tensors["thresh"] = thresh
    _kernels.check_args(name, **tensors)
    out = torch.empty((R, K, K), dtype=torch.float32, device=boxes.device)
    if out.numel() == 0:
        return out  # nothing to launch
    fn = _kernels.kernel(name)
    with torch.cuda.device(boxes.device):
        # a float threshold goes in as a launch argument: no host copy
        err = fn(boxes.data_ptr(),
                 None if thresh is None else thresh.data_ptr(), value,
                 out.data_ptr(), R, K, D,
                 _kernels.stream_handle(boxes.device))
    _kernels.launched(name, err)
    return out


@suppression_mask.register_fake
def _suppression_mask_fake(boxes, thresh, value):
    R, K = boxes.shape[:2]
    return boxes.new_empty((R, K, K), dtype=torch.float32)


@_op("suppression_mask_corners")
def suppression_mask_corners(boxes: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The corners of A and B+ (R, K, 4, 2) each that K3 stages from
    (R, K, 7+) det3d boxes (a check; it counts no launch)."""
    return mask_kernel_corners(boxes)


@suppression_mask_corners.register_kernel("cuda")
def _suppression_mask_corners_cuda(boxes):
    name = "suppression_mask_corners"
    boxes = boxes.float().contiguous()
    _kernels.check_args(name, boxes=boxes)
    R, K, D = boxes.shape
    ca, cb = (torch.empty((R, K, 4, 2), dtype=torch.float32,
                          device=boxes.device) for _ in range(2))
    with torch.cuda.device(boxes.device):
        err = _kernels.kernel(name)(
            boxes.data_ptr(), ca.data_ptr(), cb.data_ptr(), R * K, D,
            _kernels.stream_handle(boxes.device))
    _kernels.raise_on_error(name, err)
    return ca, cb


@suppression_mask_corners.register_fake
def _suppression_mask_corners_fake(boxes):
    R, K = boxes.shape[:2]
    return tuple(boxes.new_empty((R, K, 4, 2), dtype=torch.float32)
                 for _ in range(2))


# --- K4: the int8 conv with its fused epilogue -----------------------------

def _int8_conv_plain(x, w_pack, inv_s, dq, shift, stride, mask, residual,
                     act):
    return int8_conv_bn_act_plain(x, unpack_kernel(w_pack), inv_s, dq, shift,
                                  stride, mask, residual, act)


def _int8_conv_cuda(name, dtype, x, w_pack, inv_s, dq, shift, stride, mask,
                    residual, act):
    """Launch K4's variant `name` (activations of `dtype`)."""
    B, H, W, cin = x.shape
    taps, cout, wcin = w_pack.shape
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    tensors = dict(x=x, w_pack=w_pack, inv_s=inv_s, dq=dq, shift=shift)
    if mask is not None:
        tensors["mask"] = mask
    if residual is not None:
        tensors["residual"] = residual
    _kernels.check_args(name, **tensors)
    _kernels.check_args(name, align=16, x=x, w_pack=w_pack,
                        **({} if residual is None else {"residual": residual}))
    if x.dtype != dtype or w_pack.dtype != torch.int8:
        raise TypeError(f"{name}: {_NAMES[dtype]} activations (the bf16 or "
                        f"f32 variant by their dtype) and an int8 kernel, "
                        f"got {x.dtype} and {w_pack.dtype}")
    for arg in ("inv_s", "dq", "shift"):
        if tensors[arg].dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be f32")
    if (taps, wcin) != (9, cin) or stride not in (1, 2) \
            or inv_s.numel() != 1 or dq.shape != (cout,) \
            or shift.shape != (cout,):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w_pack "
                         f"{tuple(w_pack.shape)}, stride {stride}")
    if cin % _CIN_CHUNK or cout % _COUT_TILE:
        raise ValueError(f"{name}: channels must be multiples of "
                         f"{_CIN_CHUNK} (in) and {_COUT_TILE} (out), got "
                         f"{cin} -> {cout}")
    if mask is not None and (mask.shape != (B, Ho, Wo)
                             or mask.dtype != x.dtype):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} {mask.dtype}")
    if residual is not None and (residual.shape != (B, Ho, Wo, cout)
                                 or residual.dtype != x.dtype):
        raise ValueError(f"{name}: residual {tuple(residual.shape)}")

    out = torch.empty((B, Ho, Wo, cout), dtype=x.dtype, device=x.device)
    fn = _kernels.kernel(name)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w_pack.data_ptr(), inv_s.data_ptr(),
                 dq.data_ptr(), shift.data_ptr(),
                 mask.data_ptr() if mask is not None else None,
                 residual.data_ptr() if residual is not None else None,
                 out.data_ptr(), B, H, W, cin, Ho, Wo, cout, stride,
                 int(bool(act)), _kernels.stream_handle(x.device))
    _kernels.launched(name, err)
    return out


def _int8_conv_fake(x, w_pack, inv_s, dq, shift, stride, mask, residual,
                    act):
    B, H, W, _ = x.shape
    return x.new_empty((B, (H - 1) // stride + 1, (W - 1) // stride + 1,
                        w_pack.shape[1]))


@_op("int8_conv")
def int8_conv(x: torch.Tensor, w_pack: torch.Tensor, inv_s: torch.Tensor,
              dq: torch.Tensor, shift: torch.Tensor, stride: int,
              mask: Optional[torch.Tensor], residual: Optional[torch.Tensor],
              act: bool) -> torch.Tensor:
    """K4 on bf16 activations: (B, H, W, Cin) x, the (9, Cout, Cin) packed
    int8 kernel (`quant.pack_kernel`) -> (B, Ho, Wo, Cout) in x.dtype
    (`quant.int8_conv_bn_act`)."""
    return _int8_conv_plain(x, w_pack, inv_s, dq, shift, stride, mask,
                            residual, act)


@_op("int8_conv_f32")
def int8_conv_f32(x: torch.Tensor, w_pack: torch.Tensor, inv_s: torch.Tensor,
                  dq: torch.Tensor, shift: torch.Tensor, stride: int,
                  mask: Optional[torch.Tensor], residual: Optional[torch.Tensor],
                  act: bool) -> torch.Tensor:
    """K4 on f32 activations (`int8_conv`'s contract)."""
    return _int8_conv_plain(x, w_pack, inv_s, dq, shift, stride, mask,
                            residual, act)


@int8_conv.register_kernel("cuda")
def _int8_conv_bf16_cuda(*args):
    return _int8_conv_cuda("int8_conv", torch.bfloat16, *args)


@int8_conv_f32.register_kernel("cuda")
def _int8_conv_f32_cuda(*args):
    return _int8_conv_cuda("int8_conv_f32", torch.float32, *args)


int8_conv.register_fake(_int8_conv_fake)
int8_conv_f32.register_fake(_int8_conv_fake)


# --- K5: the fused int8 stride-1 stage -------------------------------------

def _int8_stage_plain(x, w_pack, inv_s, dq, shift, mask):
    return int8_stage_plain(x, unpack_kernel(w_pack), inv_s, dq, shift, mask)


def _int8_stage_cuda(name, dtype, x, w_pack, inv_s, dq, shift, mask):
    """Launch K5's variant `name` (activations of `dtype`)."""
    _kernels.check_args(name, x=x, w_pack=w_pack, inv_s=inv_s, dq=dq,
                        shift=shift, mask=mask)
    _kernels.check_args(name, align=16, x=x, w_pack=w_pack)
    B, H, W, C = x.shape
    n = w_pack.shape[0]
    if x.dtype != dtype or mask.dtype != x.dtype \
            or w_pack.dtype != torch.int8:
        raise TypeError(f"{name}: {_NAMES[dtype]} x and mask (the bf16 or "
                        f"f32 variant by their dtype) and an int8 kernel, "
                        f"got {x.dtype}, {mask.dtype}, {w_pack.dtype}")
    if any(t.dtype != torch.float32 for t in (inv_s, dq, shift)):
        raise TypeError(f"{name}: inv_s, dq and shift must be f32")
    if C != CHANNELS or n < 3 or n % 2 == 0 \
            or w_pack.shape != (n, 9, C, C) or inv_s.shape != (n,) \
            or dq.shape != (n, C) or shift.shape != (n, C) \
            or mask.shape != (B, H, W):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w_pack "
                         f"{tuple(w_pack.shape)}, mask {tuple(mask.shape)}")

    out = torch.empty_like(x)
    fn = _kernels.kernel(name)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w_pack.data_ptr(), inv_s.data_ptr(),
                 dq.data_ptr(), shift.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), B, H, W, n, _kernels.stream_handle(x.device))
    _kernels.launched(name, err)
    return out


def _int8_stage_fake(x, w_pack, inv_s, dq, shift, mask):
    return torch.empty_like(x)


@_op("int8_stage")
def int8_stage(x: torch.Tensor, w_pack: torch.Tensor, inv_s: torch.Tensor,
               dq: torch.Tensor, shift: torch.Tensor, mask: torch.Tensor
               ) -> torch.Tensor:
    """K5 on bf16 activations: (B, H, W, 32) x, the (n, 9, 32, 32) packed
    kernels of the stage's n convs -> (B, H, W, 32)
    (`int8_stage.int8_stage`)."""
    return _int8_stage_plain(x, w_pack, inv_s, dq, shift, mask)


@_op("int8_stage_f32")
def int8_stage_f32(x: torch.Tensor, w_pack: torch.Tensor,
                   inv_s: torch.Tensor, dq: torch.Tensor,
                   shift: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K5 on f32 activations (`int8_stage`'s contract)."""
    return _int8_stage_plain(x, w_pack, inv_s, dq, shift, mask)


@int8_stage.register_kernel("cuda")
def _int8_stage_bf16_cuda(*args):
    return _int8_stage_cuda("int8_stage", torch.bfloat16, *args)


@int8_stage_f32.register_kernel("cuda")
def _int8_stage_f32_cuda(*args):
    return _int8_stage_cuda("int8_stage_f32", torch.float32, *args)


int8_stage.register_fake(_int8_stage_fake)
int8_stage_f32.register_fake(_int8_stage_fake)


# kernel entry of `_kernels.KERNELS` -> the op that launches it
OPS = {"pillar_scatter_max": pillar_scatter_max,
       "pillar_scatter_max_tiled": pillar_scatter_max_tiled,
       "pillar_scatter_max_tiled_keys": pillar_scatter_max_tiled,
       "rotated_overlap": rotated_overlap,
       "suppression_mask": suppression_mask,
       "suppression_mask_corners": suppression_mask_corners,
       "int8_conv": int8_conv, "int8_conv_f32": int8_conv_f32,
       "int8_stage": int8_stage, "int8_stage_f32": int8_stage_f32}
