"""The whole int8 stride-1 stage in one kernel (K5), and its plain version.

Port of the contract of the TPU kernel
`pillarnet_lts_tpu/ops/pallas/s2d_conv_kernel.py::s2d_stage_int8` (:385,
body `_stage_kernel` :287): the n = 3 + 2 * (blocks - 1) SubM convs of the
32-channel stride-1 stage (a BlockV, then residual blocks), each int8 with
the fused epilogue of `ops/quant.py::int8_conv_bn_act`:

  conv0:           A = conv(x) * mask                 (no ReLU)
  mid  (odd i):    B = relu(conv(A)) * mask
  tail (even i):   A = relu(conv(B) + A) * mask

The plain version chains the plain int8 convs through that structure in
the activations' dtype (bf16 or f32, as `quant.int8_conv_bn_act_plain`);
the kernel (`csrc/int8_stage.cu`, one variant per dtype) keeps the
intermediates in shared memory and is held bit-equal to it. The s2d
phase layout of the TPU kernel is not carried over: the int32 sums do not
depend on it.
"""

import torch

from . import _kernels
from .quant import check_pack, int8_conv_bn_act_plain, pack_kernel

CHANNELS = 32  # the only stage width the kernel takes (PillarNet's stage 1)

# activation dtype -> the fused stage kernel's variant (its op and launch
# counter)
_STAGE_VARIANTS = {torch.bfloat16: "int8_stage",
                   torch.float32: "int8_stage_f32"}


def int8_stage_plain(x, w_q, inv_s, dq, shift, mask):
    """Plain version of `int8_stage` (same arguments)."""
    def conv(h, i, **kw):
        return int8_conv_bn_act_plain(h, w_q[i], inv_s[i], dq[i], shift[i], 1,
                                      mask=mask, **kw)

    ident = conv(x, 0, act=False)
    for b in range((w_q.shape[0] - 1) // 2):
        mid = conv(ident, 1 + 2 * b)
        ident = conv(mid, 2 + 2 * b, residual=ident)
    return ident


def int8_stage(x, w_q, inv_s, dq, shift, mask, w_pack=None):
    """Fused int8 stride-1 stage.

    x:     (B, H, W, 32) bf16 or f32 stage input (the model's compute
           dtype), zero at inactive sites;
    w_q:   (n, 3, 3, 32, 32) int8 kernels in execution order, n odd >= 3;
    inv_s: (n,) f32, 1 / activation scale of each conv;
    dq:    (n, 32) f32 dequant vectors; shift: (n, 32) f32;
    mask:  (B, H, W) {0, 1} occupancy multiplier in x.dtype;
    w_pack: optional `quant.pack_kernel(w_q)`, (n, 9, 32, 32) (the
           backbone's `fused_stage1_params` caches it); when given, it is
           the kernels that both devices read (the CPU through
           `quant.unpack_kernel`); when absent, the wrapper packs w_q
           itself.

    Returns (B, H, W, 32) in x.dtype. The op of x.dtype's variant
    (`pillarnet::int8_stage` bf16, `pillarnet::int8_stage_f32` f32): a
    CPU tensor takes the plain version; a CUDA tensor launches
    `csrc/int8_stage.cu`'s variant or raises (an f32 x is quantized
    itself, never cast to bf16)."""
    name = _STAGE_VARIANTS.get(x.dtype, "int8_stage")
    _kernels.check_device(name, x)
    if w_pack is None:
        w_pack = pack_kernel(w_q)
    else:
        check_pack(name, w_pack, w_q)
    return getattr(torch.ops.pillarnet, name)(x, w_pack, inv_s, dq, shift,
                                              mask)
