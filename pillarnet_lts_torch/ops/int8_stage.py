"""The whole int8 stride-1 stage in one kernel (K5), and its plain version.

Port of the contract of the TPU kernel
`pillarnet_lts_tpu/ops/pallas/s2d_conv_kernel.py::s2d_stage_int8` (:385,
body `_stage_kernel` :287): the n = 3 + 2 * (blocks - 1) SubM convs of the
32-channel stride-1 stage (a BlockV, then residual blocks), each int8 with
the fused epilogue of `ops/quant.py::int8_conv_bn_act`:

  conv0:           A = conv(x) * mask                 (no ReLU)
  mid  (odd i):    B = relu(conv(A)) * mask
  tail (even i):   A = relu(conv(B) + A) * mask

The plain version chains the plain int8 convs through that structure; the
kernel (`csrc/int8_stage.cu`) keeps the intermediates in shared memory and
is held bit-equal to it. The s2d phase layout of the TPU kernel is not
carried over: the int32 sums do not depend on it.
"""

import torch

from . import _kernels
from .quant import (check_pack, int8_conv_bn_act_plain, pack_kernel,
                    unpack_kernel)

CHANNELS = 32  # the only stage width the kernel takes (PillarNet's stage 1)


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

    x:     (B, H, W, 32) bf16 stage input, zero at inactive sites;
    w_q:   (n, 3, 3, 32, 32) int8 kernels in execution order, n odd >= 3;
    inv_s: (n,) f32, 1 / activation scale of each conv;
    dq:    (n, 32) f32 dequant vectors; shift: (n, 32) f32;
    mask:  (B, H, W) {0, 1} occupancy multiplier in x.dtype;
    w_pack: optional `quant.pack_kernel(w_q)`, (n, 9, 32, 32) (the
           backbone's `fused_stage1_params` caches it); when given, it is
           the kernels that both devices read (the CPU through
           `quant.unpack_kernel`); when absent, the wrapper packs w_q
           itself on the card.

    Returns (B, H, W, 32) in x.dtype. A CPU tensor takes the plain version;
    a CUDA tensor launches `csrc/int8_stage.cu` or raises."""
    name = "int8_stage"
    if w_pack is not None:
        check_pack(name, w_pack, w_q)
    if x.device.type == "cpu":
        w = w_q if w_pack is None else unpack_kernel(w_pack)
        return int8_stage_plain(x, w, inv_s, dq, shift, mask)

    if w_pack is None:
        w_pack = pack_kernel(w_q)
    _kernels.check_args(name, x=x, w_pack=w_pack, inv_s=inv_s, dq=dq,
                        shift=shift, mask=mask)
    _kernels.check_args(name, align=16, x=x, w_pack=w_pack)
    B, H, W, C = x.shape
    n = w_q.shape[0]
    if x.dtype != torch.bfloat16 or mask.dtype != x.dtype \
            or w_q.dtype != torch.int8:
        raise TypeError(f"{name}: bf16 x and mask and an int8 kernel, got "
                        f"{x.dtype}, {mask.dtype}, {w_q.dtype}")
    if any(t.dtype != torch.float32 for t in (inv_s, dq, shift)):
        raise TypeError(f"{name}: inv_s, dq and shift must be f32")
    if C != CHANNELS or n < 3 or n % 2 == 0 \
            or w_q.shape != (n, 3, 3, C, C) or inv_s.shape != (n,) \
            or dq.shape != (n, C) or shift.shape != (n, C) \
            or mask.shape != (B, H, W):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, mask {tuple(mask.shape)}")

    out = torch.empty_like(x)
    fn = _kernels.kernel(name)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w_pack.data_ptr(), inv_s.data_ptr(),
                 dq.data_ptr(), shift.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), B, H, W, n, _kernels.stream_handle(x.device))
    _kernels.launched(name, err)
    return out
