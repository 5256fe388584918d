"""int8 deploy arithmetic: activation and weight quantization, the plain
int8 conv, and the fused int8 conv + BN + residual + ReLU + re-zero.

Port of the int8 helpers of `pillarnet_lts_tpu/models/backbones/base.py`
(`quantize_act` :368, `conv_core_int8` :375, `MaskedConv.weight_scale` /
`kernel_int8` :727) and of the contract of the TPU kernel
`pillarnet_lts_tpu/ops/pallas/s2d_conv_kernel.py::s2d_subm_conv_int8` (:137).
The scheme: symmetric per-output-channel weight scales taken over the raw
kernel (the BN fold factor rides the dequant vector), symmetric per-tensor
activation scales from a calibrated absmax, int32 sums, f32 dequant.

Public functions keep the JAX package's layouts: activations NHWC, kernels
HWIO. `int8_conv_bn_act` calls the op `pillarnet::int8_conv` or
`pillarnet::int8_conv_f32` (`ops/library.py`, by the activations' dtype),
which launches `csrc/int8_conv.cu` on a CUDA tensor and runs its plain
version on a CPU tensor; nothing falls back, and nothing casts f32 to bf16.
The op reads the weights as `pack_kernel(w_q)`, which a caller may compute
once and pass as `w_pack`; the plain version runs on
`unpack_kernel(w_pack)`, so both devices read the same tensor.

Rounding is the JAX package's: `torch.round` rounds half to even, as
`jnp.round` does. The dequant epilogue is a multiply and then an add, each
rounded (no FMA), and the kernel is built with `-fmad=false` to match.
The scales' `/ 127` is a multiply by f32(1 / 127): XLA's simplifier
rewrites the JAX package's division by a constant so under `jit`, and the
scales must come out bit-equal.
"""

import torch
import torch.nn.functional as F

from . import _kernels

# activation dtype -> the int8 conv kernel's variant (its op and launch
# counter)
_CONV_VARIANTS = {torch.bfloat16: "int8_conv", torch.float32: "int8_conv_f32"}

INV_127 = 1.0 / 127.0  # applied to f32 tensors, it rounds to f32(1 / 127)


def quantize(x, inv_s):
    """int8 codes clip(round(x * inv_s), -127, 127), computed in f32;
    `inv_s` broadcasts against x."""
    q = torch.round(x.float() * inv_s)
    return q.clamp_(-127.0, 127.0).to(torch.int8)


def quantize_act(x, s_x):
    """bf16/f32 -> int8 codes with a symmetric per-tensor scale `s_x`
    (a 0-dim f32 tensor): clip(round(x * (1 / s_x)), -127, 127)."""
    return quantize(x, 1.0 / s_x)


def activation_scale(absmax):
    """Per-tensor (or per-channel) activation scale from a calibrated
    absmax: max(absmax, 1e-6) / 127."""
    return torch.clamp_min(absmax, 1e-6) * INV_127


def weight_scale(w):
    """Per-output-channel weight scale of an (O, ...) kernel (raw, before
    any BN fold): max(|w| over all but O) / 127, at least 1e-12."""
    return torch.clamp_min(w.abs().flatten(1).amax(1) * INV_127, 1e-12)


def kernel_int8(w, s_w):
    """OIHW f32 kernel -> HWIO int8 kernel: clip(round(w * (1 / s_w)))."""
    q = quantize(w, (1.0 / s_w)[:, None, None, None])
    return q.permute(2, 3, 1, 0).contiguous()


def pack_kernel(w_q):
    """(..., 3, 3, Cin, Cout) HWIO int8 kernel(s) -> (..., 9, Cout, Cin):
    each output channel's input channels contiguous, tap by tap, the order
    in which the CUDA kernels' tensor-core B operand reads them."""
    *lead, kh, kw, cin, cout = w_q.shape
    return w_q.transpose(-1, -2).reshape(*lead, kh * kw, cout,
                                         cin).contiguous()


def unpack_kernel(w_pack):
    """Inverse of `pack_kernel`: (..., 9, Cout, Cin) -> (..., 3, 3, Cin,
    Cout)."""
    *lead, taps, cout, cin = w_pack.shape
    return w_pack.reshape(*lead, 3, taps // 3, cout, cin).transpose(-1, -2)


def check_pack(name, w_pack, w_q):
    """Raise unless `w_pack` has the shape and type of `pack_kernel(w_q)`."""
    *lead, kh, kw, cin, cout = w_q.shape
    if w_pack.dtype != torch.int8 \
            or tuple(w_pack.shape) != (*lead, kh * kw, cout, cin):
        raise ValueError(f"{name}: w_pack {tuple(w_pack.shape)} "
                         f"{w_pack.dtype} is not pack_kernel of w_q "
                         f"{tuple(w_q.shape)}")


def conv_core_int8(xq, wq, stride):
    """int8 NHWC x int8 HWIO -> int32 NHWC sums, 3x3, padding 1 (plain).

    The sums reach 9 * Cin * 127^2 (3.7e7 at Cin = 256), past f32's exact
    integers, so they are taken in float64 (exact below 2^53) and rounded,
    which also absorbs the tiny errors of a Winograd or FFT algorithm that
    cuDNN may pick for a float64 conv on the card."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                 wq.permute(3, 2, 0, 1).double(), stride=stride, padding=1)
    return y.round().to(torch.int32).permute(0, 2, 3, 1)


def dequant_epilogue(acc, dq, shift, dtype):
    """int32 sums -> (acc * dq + shift) in f32, two roundings, -> dtype."""
    return (acc.float() * dq + shift).to(dtype)


def int8_conv_bn_act_plain(x, w_q, inv_s, dq, shift, stride, mask=None,
                           residual=None, act=True):
    """Plain version of `int8_conv_bn_act` (same arguments)."""
    y = dequant_epilogue(conv_core_int8(quantize(x, inv_s), w_q, stride), dq,
                         shift, x.dtype)
    if residual is not None:
        y = y + residual
    if act:
        y = F.relu(y)
    if mask is not None:
        y = y * mask[..., None].to(y.dtype)
    return y


def int8_conv_bn_act(x, w_q, inv_s, dq, shift, stride, mask=None,
                     residual=None, act=True, w_pack=None):
    """One int8 3x3 conv (padding 1) with the fused eval epilogue.

    x:        (B, H, W, Cin) bf16 or f32 activations (the model's compute
              dtype: bf16 configs and f32 configs after
              `enable_backbone_quant`);
    w_q:      (3, 3, Cin, Cout) int8 kernel (`kernel_int8`);
    inv_s:    0-dim f32 tensor, 1 / activation scale (computed in f32);
    dq:       (Cout,) f32 dequant vector s_x * s_w * inv (BN fold included);
    shift:    (Cout,) f32, conv bias * inv + BN shift;
    stride:   1 or 2;
    mask:     optional (B, Ho, Wo) {0, 1} re-zero multiplier, x.dtype;
    residual: optional (B, Ho, Wo, Cout) in x.dtype;
    w_pack:   optional `pack_kernel(w_q)` (`MaskedConv.int8_params` caches
              it); the kernel that both devices read (the CPU through
              `unpack_kernel`); when absent, the wrapper packs w_q itself.

    Quantizes x on load (round half to even, clip to +-127; an f32 x is
    quantized itself), sums in int32, then (acc * dq + shift) -> x.dtype,
    + residual, ReLU if `act`, times the mask, each in x.dtype. Returns
    (B, Ho, Wo, Cout) in x.dtype. The op of x.dtype's variant
    (`pillarnet::int8_conv` bf16, `pillarnet::int8_conv_f32` f32): a CPU
    tensor takes the plain version; a CUDA tensor launches
    `csrc/int8_conv.cu`'s variant or raises (a pointer of x, w_pack or the
    residual that is not 16-byte aligned raises: nothing is copied)."""
    name = _CONV_VARIANTS.get(x.dtype, "int8_conv")
    _kernels.check_device(name, x)
    if w_pack is None:
        w_pack = pack_kernel(w_q)
    else:
        check_pack(name, w_pack, w_q)
    return getattr(torch.ops.pillarnet, name)(x, w_pack, inv_s, dq, shift,
                                              stride, mask, residual, act)
