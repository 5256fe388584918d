"""PyTorch port, the int8 conv kernels' packed weights: `ops.quant.
pack_kernel` (the (9, Cout, Cin) layout of the tensor-core operand), the
cache of `MaskedConv.int8_params` and the backbone's stacked stage params,
and the wrappers' `w_pack` keyword on the CPU.

The kernels themselves run only on the card (`tests/test_torch_port_cuda.py`);
here the packing and the keyword's plumbing are held exact: integer
permutations compare bit for bit, and the CPU wrappers (the plain versions)
give identical tensors with and without the keyword. When the keyword is
given, the CPU reads the pack (`unpack_kernel`), as the card does, so a
stale pack shows on the CPU too. The JAX parity of the
int8 conv and stage stays in `tests/test_torch_port_int8.py`.
"""

import os

import numpy as np
import pytest
import torch

from pillarnet_lts_torch.apis import build_model_from_cfg, load_config
from pillarnet_lts_torch.models.backbones.base import MaskedConv, state_key
from pillarnet_lts_torch.models.utils.norm import MaskedBatchNorm
from pillarnet_lts_torch.ops import quant
from pillarnet_lts_torch.ops.int8_stage import int8_stage, int8_stage_plain
import test_torch_port_threads  # noqa: F401  (one torch thread)

ROOT = os.path.join(os.path.dirname(__file__), "..")
FLAGSHIP_INT8 = os.path.join(ROOT, "configs", "pillarnet",
                             "pillarnet34_nusc_int8.py")

# (Cin, Cout, stride) of every int8 conv of the flagship (PillarResNet34 +
# RPNV1 at in_channels 32): stage 1, the down convs, the stages, conv5's
# strided and dense convs, the neck (its first conv after the concat)
FLAGSHIP_CONVS = [(32, 32, 1), (32, 64, 2), (64, 64, 1), (64, 128, 2),
                  (128, 128, 1), (128, 256, 2), (256, 256, 1), (256, 256, 2),
                  (512, 256, 1)]


def _codes(rng, shape):
    return torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))


@pytest.fixture(scope="module")
def flagship_int8():
    """The int8 flagship (full width, random weights, uncalibrated) with
    the fused stage on."""
    cfg = load_config(FLAGSHIP_INT8)
    cfg["model"]["backbone"]["s2d_pallas"] = True
    return build_model_from_cfg(cfg, device="cpu", seed=0)


def test_flagship_conv_shapes_are_the_listed_ones(flagship_int8):
    model = flagship_int8
    shapes = {(m.weight.shape[1], m.weight.shape[0], m.stride)
              for m in model.modules()
              if isinstance(m, MaskedConv) and m.quant}
    assert shapes == set(FLAGSHIP_CONVS)


@pytest.mark.parametrize("cin,cout,stride", FLAGSHIP_CONVS)
def test_pack_is_the_hwio_kernel_permuted(cin, cout, stride):
    w_q = _codes(np.random.RandomState(cin + cout + stride),
                 (3, 3, cin, cout))
    pack = quant.pack_kernel(w_q)
    assert pack.dtype == torch.int8 and pack.is_contiguous()
    assert pack.shape == (9, cout, cin)
    w = w_q.numpy()
    want = np.stack([w[t // 3, t % 3].T for t in range(9)])
    np.testing.assert_array_equal(pack.numpy(), want)
    quant.check_pack("test", pack, w_q)


def test_pack_of_a_stacked_stage_is_the_stack_of_packs():
    w_q = _codes(np.random.RandomState(5), (7, 3, 3, 32, 32))
    pack = quant.pack_kernel(w_q)
    assert pack.shape == (7, 9, 32, 32) and pack.is_contiguous()
    for i in range(7):
        assert torch.equal(pack[i], quant.pack_kernel(w_q[i]))


@pytest.mark.parametrize("lead", [(), (7,)])
@pytest.mark.parametrize("cin,cout,stride", FLAGSHIP_CONVS)
def test_unpack_inverts_the_pack(cin, cout, stride, lead):
    w_q = _codes(np.random.RandomState(cin * cout + stride),
                 (*lead, 3, 3, cin, cout))
    assert torch.equal(quant.unpack_kernel(quant.pack_kernel(w_q)), w_q)


@pytest.mark.parametrize("shape", [(9, 32, 32), (3, 3, 32, 32),
                                   (9, 64, 32)])
def test_a_pack_of_the_wrong_shape_raises(shape):
    w_q = _codes(np.random.RandomState(1), (3, 3, 64, 32))
    bad = torch.zeros(shape, dtype=torch.int8)
    with pytest.raises(ValueError, match="w_pack"):
        quant.check_pack("int8_conv", bad, w_q)
    x = torch.zeros((1, 4, 4, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="w_pack"):
        quant.int8_conv_bn_act(x, w_q, torch.tensor(1.0), torch.ones(32),
                               torch.zeros(32), 1, w_pack=bad)


def _calibrated_conv(cin=64, cout=32, stride=1):
    gen = torch.Generator().manual_seed(cin + cout)
    conv = MaskedConv(cin, cout, stride=stride, quant=True)
    conv.init_weights(gen)
    conv.set_absmax(torch.tensor(3.0))
    bn = MaskedBatchNorm(cout)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.running_var.uniform_(0.5, 2.0, generator=gen)
    return conv, bn


def _change(what, conv, bn):
    with torch.no_grad():
        if what == "weights":
            conv.weight.mul_(-1.5)
        elif what == "scale":
            conv.set_absmax(torch.tensor(5.0))
        elif what == "bn":
            bn.running_var.mul_(2.0)
        elif what == "bias":
            conv.bias.add_(0.25)


def test_int8_params_reuse_the_pack_while_nothing_changes():
    conv, bn = _calibrated_conv()
    first = conv.int8_params(bn)
    again = conv.int8_params(bn)
    assert all(a is b for a, b in zip(first, again))
    w_q, w_pack = first[0], first[4]
    assert torch.equal(w_pack, quant.pack_kernel(w_q))


@pytest.mark.parametrize("what", ["weights", "scale", "bn", "bias"])
def test_int8_params_recompute_the_pack_on_a_change(what):
    conv, bn = _calibrated_conv()
    before = conv.int8_params(bn)
    key = conv._int8[0]
    _change(what, conv, bn)
    assert state_key(conv.weight, conv.bias, conv.in_absmax, bn.weight,
                     bn.bias, bn.running_mean, bn.running_var) != key
    after = conv.int8_params(bn)
    assert all(a is not b for a, b in zip(before, after))
    assert torch.equal(after[4], quant.pack_kernel(after[0]))
    if what == "weights":  # the codes themselves change sign
        assert torch.equal(after[4], -before[4])
    else:  # same codes, new dequant or shift
        assert torch.equal(after[4], before[4])


def _conv_inputs(seed, cin, cout, stride, B=2, H=11, W=13):
    rng = np.random.RandomState(seed)
    occ = rng.rand(B, H, W) < 0.4
    bf = torch.bfloat16
    x = torch.from_numpy((rng.randn(B, H, W, cin) * occ[..., None])
                         .astype(np.float32)).to(bf)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    mask = torch.from_numpy(rng.rand(B, Ho, Wo) < 0.5).to(bf)
    res = torch.from_numpy(rng.randn(B, Ho, Wo, cout).astype(np.float32)) \
        .to(bf) * mask[..., None]
    args = (x, _codes(rng, (3, 3, cin, cout)),
            torch.tensor(127.0 / float(x.float().abs().max())),
            torch.from_numpy((rng.rand(cout) * 1e-3 + 1e-4)
                             .astype(np.float32)),
            torch.from_numpy(rng.randn(cout).astype(np.float32)), stride)
    return args, mask, res


@pytest.mark.parametrize("cin,cout,stride", [(32, 32, 1), (32, 64, 2),
                                             (512, 256, 1)])
def test_int8_conv_on_the_cpu_with_and_without_the_pack(cin, cout, stride):
    """Same result with and without `w_pack`, and both the plain version."""
    args, mask, res = _conv_inputs(cin + stride, cin, cout, stride)
    kw = dict(mask=mask, residual=res if stride == 1 else None)
    want = quant.int8_conv_bn_act_plain(*args, **kw)
    got = quant.int8_conv_bn_act(*args, **kw)
    packed = quant.int8_conv_bn_act(*args, **kw,
                                    w_pack=quant.pack_kernel(args[1]))
    assert torch.equal(got, want) and torch.equal(packed, want)
    assert got.float().abs().max() > 0


@pytest.mark.parametrize("cin,cout,stride", [(32, 32, 1), (64, 128, 2)])
def test_int8_conv_on_the_cpu_reads_the_pack(cin, cout, stride):
    """Given a pack, the CPU computes with it, not with w_q: the pack of
    another kernel gives that kernel's result."""
    args, mask, _ = _conv_inputs(cin * stride, cin, cout, stride)
    other = -args[1]
    want = quant.int8_conv_bn_act_plain(args[0], other, *args[2:], mask=mask)
    got = quant.int8_conv_bn_act(*args, mask=mask,
                                 w_pack=quant.pack_kernel(other))
    assert torch.equal(got, want)
    assert not torch.equal(got, quant.int8_conv_bn_act(*args, mask=mask))


def _stage_inputs(seed):
    rng = np.random.RandomState(seed)
    B, H, W, c, n = 1, 17, 21, 32, 5
    occ = rng.rand(B, H, W) < 0.3
    bf = torch.bfloat16
    x = torch.from_numpy((rng.randn(B, H, W, c) * occ[..., None])
                         .astype(np.float32)).to(bf)
    w_q = _codes(rng, (n, 3, 3, c, c))
    inv_s = torch.from_numpy((30.0 + 5 * np.arange(n)).astype(np.float32))
    dq = torch.from_numpy((rng.rand(n, c) * 2e-5 + 1e-5).astype(np.float32))
    shift = torch.from_numpy((rng.randn(n, c) * 0.05).astype(np.float32))
    mask = torch.from_numpy(occ).to(bf)
    return (x, w_q, inv_s, dq, shift, mask)


def test_int8_stage_on_the_cpu_with_and_without_the_pack():
    args = _stage_inputs(3)
    w_q = args[1]
    want = int8_stage_plain(*args)
    assert torch.equal(int8_stage(*args), want)
    assert torch.equal(int8_stage(*args, w_pack=quant.pack_kernel(w_q)),
                       want)
    with pytest.raises(ValueError, match="w_pack"):
        int8_stage(*args, w_pack=quant.pack_kernel(w_q[:3]))


def test_int8_stage_on_the_cpu_reads_the_pack():
    args = _stage_inputs(4)
    other = args[1].flip(0)  # the same kernels in another order
    want = int8_stage_plain(args[0], other, *args[2:])
    got = int8_stage(*args, w_pack=quant.pack_kernel(other))
    assert torch.equal(got, want) and not torch.equal(got, int8_stage(*args))


def test_fused_stage_params_carry_the_stacked_pack(flagship_int8):
    bb = flagship_int8.backbone_net
    pairs = [p for blk in bb._stage1_blocks() for p in blk.convs()]
    for conv, _ in pairs:
        conv.set_absmax(torch.tensor(2.0))
    w_q, inv_s, dq, shift, w_pack = bb.fused_stage1_params()
    assert w_q.shape == (7, 3, 3, 32, 32) and w_pack.shape == (7, 9, 32, 32)
    assert torch.equal(w_pack, quant.pack_kernel(w_q))
    for i, (conv, bn) in enumerate(pairs):
        assert torch.equal(w_pack[i], conv.int8_params(bn)[4])
    assert bb.fused_stage1_params()[4] is w_pack  # cached
    _change("weights", *pairs[3])
    assert torch.equal(bb.fused_stage1_params()[4][3], -w_pack[3])
