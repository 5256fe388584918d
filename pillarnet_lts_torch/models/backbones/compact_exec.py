"""Compact (gather-based) execution of the sparse ResNet blocks.

Port of `pillarnet_lts_tpu/models/backbones/compact_exec.py`: the same
modules (`Sparse2DBasicBlock[V]`, `SparseDownStage`), the same parameters
and the same BN statistics, run over the compact active-site rows of
`ops/compact.py` instead of the masked-dense BEV map. The JAX package's
batched `_gather_matmul` is `ops.compact.gather_conv` here.

All helpers are batched: rows (B, K, C), nbr (B, Kout, 9), valid
(B, Kout) bool. Padding rows are kept at exactly 0 (the masked BN
re-zeroes them in training, the valid-mask multiply at eval), so gathers
from the zero sentinel row and the residual adds stay exact.

Numerics: the gather and matmul run in the rows' dtype (bf16 gathers and
multiplies in bf16 with f32 accumulation, as the JAX package's bf16 `@`);
TF32 stays off (`models/builder.py`).
"""

import dataclasses

import torch
import torch.nn.functional as F

from ...ops.compact import gather_conv


@dataclasses.dataclass
class CompactPillars:
    """Active-site row table, sorted row-major by flat BEV id.

    rows: (B, kmax, C) features; padding rows are 0.
    site_ids: (B, kmax) int32 flat ids (y * width + x); padding = H * W.
    k_valid: (B,) int32 active-site counts (clamped to kmax).
    height, width: the grid (static)."""

    rows: torch.Tensor
    site_ids: torch.Tensor
    k_valid: torch.Tensor
    height: int
    width: int


def _ext(rows):
    """Append the zero sentinel row: (B, K, C) -> (B, K + 1, C)."""
    return F.pad(rows, (0, 0, 0, 1))


def _kernel_rows(weight):
    """(Cout, Cin, 3, 3) conv weight -> (9 * Cin, Cout), row-major
    (dy, dx, Cin): the JAX package's `kernel.reshape(9 * cin, cout)`."""
    cout, cin = weight.shape[:2]
    return weight.permute(2, 3, 1, 0).reshape(9 * cin, cout)


def conv_bn_act_compact(conv, bn, rows, nbr, valid, train, act=True):
    """conv -> BN over the valid rows -> optional ReLU on compact rows; at
    eval the BN folds into the gather-conv weights
    (`MaskedConv.folded_params`) and the valid mask re-zeroes (the
    counterpart of `base.py::conv_bn_act`)."""
    x = _ext(rows)
    if train:
        y = gather_conv(x, nbr, _kernel_rows(conv.weight).to(x.dtype),
                        conv.bias)
        y = bn(y, valid[..., None])
    else:
        w, b = conv.folded_params(*bn.fold_factors())
        y = gather_conv(x, nbr, _kernel_rows(w).to(x.dtype), b)
        y = y * valid[..., None].to(y.dtype)
    return F.relu(y) if act else y


def basic_block_compact(block, rows, nbr, valid, train):
    """`Sparse2DBasicBlock.forward` over compact rows."""
    out = conv_bn_act_compact(block.conv1, block.bn1, rows, nbr, valid, train)
    out = conv_bn_act_compact(block.conv2, block.bn2, out, nbr, valid, train,
                              act=False)
    return F.relu(out + rows)


def basic_block_v_compact(block, rows, nbr, valid, train):
    """`Sparse2DBasicBlockV.forward` over compact rows."""
    x = conv_bn_act_compact(block.conv0, block.bn0, rows, nbr, valid, train,
                            act=False)
    out = conv_bn_act_compact(block.conv1, block.bn1, x, nbr, valid, train)
    out = conv_bn_act_compact(block.conv2, block.bn2, out, nbr, valid, train,
                              act=False)
    return F.relu(out + x)


def down_stage_compact(stage, rows_fine, nbr_down, nbr_coarse, valid_coarse,
                       train):
    """`SparseDownStage.forward` over compact rows: the strided gather-conv
    from the fine rows, then the stage's residual blocks at the coarse
    level."""
    y = conv_bn_act_compact(stage.down_conv, stage.down_bn, rows_fine,
                            nbr_down, valid_coarse, train)
    for i in range(stage.num_blocks):
        y = basic_block_compact(getattr(stage, f"block{i}"), y, nbr_coarse,
                                valid_coarse, train)
    return y
