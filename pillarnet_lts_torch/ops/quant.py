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
HWIO. `int8_conv_bn_act` launches `csrc/int8_conv.cu` on a CUDA tensor and
runs its plain version on a CPU tensor; nothing falls back. The kernel reads
its weights as `pack_kernel(w_q)`, which a caller may compute once and pass
as `w_pack`; when it is passed, the plain version runs on
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

# the kernel's tiling: input channels in chunks of 32, output channels in
# tiles of 32 or 64
_CIN_CHUNK = 32
_COUT_TILE = 32

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

    x:        (B, H, W, Cin) bf16 activations (f32 accepted on the CPU);
    w_q:      (3, 3, Cin, Cout) int8 kernel (`kernel_int8`);
    inv_s:    0-dim f32 tensor, 1 / activation scale (computed in f32);
    dq:       (Cout,) f32 dequant vector s_x * s_w * inv (BN fold included);
    shift:    (Cout,) f32, conv bias * inv + BN shift;
    stride:   1 or 2;
    mask:     optional (B, Ho, Wo) {0, 1} re-zero multiplier, x.dtype;
    residual: optional (B, Ho, Wo, Cout) in x.dtype;
    w_pack:   optional `pack_kernel(w_q)` (`MaskedConv.int8_params` caches
              it); when given, it is the kernel that both devices read
              (the CPU through `unpack_kernel`); when absent, the wrapper
              packs w_q itself on the card.

    Quantizes x on load (round half to even, clip to +-127), sums in int32,
    then (acc * dq + shift) -> x.dtype, + residual, ReLU if `act`, times the
    mask. Returns (B, Ho, Wo, Cout) in x.dtype. A CPU tensor takes the
    plain version; a CUDA tensor launches `csrc/int8_conv.cu` or raises."""
    name = "int8_conv"
    if w_pack is not None:
        check_pack(name, w_pack, w_q)
    if x.device.type == "cpu":
        w = w_q if w_pack is None else unpack_kernel(w_pack)
        return int8_conv_bn_act_plain(x, w, inv_s, dq, shift, stride, mask,
                                      residual, act)

    if w_pack is None:
        w_pack = pack_kernel(w_q)
    B, H, W, cin = x.shape
    kh, kw, wcin, cout = w_q.shape
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    tensors = dict(x=x, w_pack=w_pack, inv_s=inv_s, dq=dq, shift=shift)
    if mask is not None:
        tensors["mask"] = mask
    if residual is not None:
        tensors["residual"] = residual
    _kernels.check_args(name, **tensors)
    _kernels.check_args(name, align=16, x=x, w_pack=w_pack,
                        **({} if residual is None else {"residual": residual}))
    if x.dtype != torch.bfloat16 or w_q.dtype != torch.int8:
        raise TypeError(f"{name}: bf16 activations and an int8 kernel, got "
                        f"{x.dtype} and {w_q.dtype}")
    for arg in ("inv_s", "dq", "shift"):
        if tensors[arg].dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be f32")
    if (kh, kw, wcin) != (3, 3, cin) or stride not in (1, 2) \
            or inv_s.numel() != 1 or dq.shape != (cout,) \
            or shift.shape != (cout,):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, stride {stride}")
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
