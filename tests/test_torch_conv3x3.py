"""The metaseg forward's float32 3x3 conv (ecseg_torch/ops/conv3x3.py): its
plain twin -- the kernel's sums in the kernel's order -- against
``F.conv2d`` and the JAX package's ``conv2d`` at ``Precision.HIGHEST``, the
weight packing the kernel reads, the wrapper's refusals, and
``MetasegUNet``'s routing: the kernel only for a float32 forward on the
card that builds no autograd graph; the CPU, autograd's forward, bf16 and
NuSeT keep ``F.conv2d``.  The CUDA kernel is held against cuDNN and the
twin on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import copy
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

import jax
import jax.numpy as jnp

from ecseg_tpu.models import layers as jl
from ecseg_tpu.models import metaseg_unet as ju
from ecseg_torch.models.layers import SameConv2d
from ecseg_torch.models.metaseg_unet import MetasegUNet
from ecseg_torch.models.weights import params_from_numpy
from ecseg_torch.ops import conv3x3
from ecseg_torch.runtime import fallbacks

from _torchutil import numpy_metaseg_tree, single_torch_thread  # noqa: F401 (autouse fixture)

CASES = [  # (n, h, w, ca, cb, cout): cb > 0 is a split input (skip, upsampled half)
    (2, 16, 16, 1, 0, 64),  # enc1_1's one channel
    (1, 256, 256, 1, 0, 8),  # a 256^2 plane
    (2, 16, 16, 32, 0, 32),
    (1, 16, 16, 1024, 0, 8),  # the XL bottleneck's cin
    (1, 16, 16, 16, 16, 12),  # a split at chunks of 16
    (2, 20, 18, 8, 8, 4),  # a split off the 16-channel chunk, ragged tiles
    (1, 256, 256, 32, 32, 4),  # a split 256^2 plane (dec1_1 at the default widths)
    (1, 9, 7, 3, 5, 8),  # channel counts off 4: element copies
]
IDS = [f"n{c[0]}_{c[1]}x{c[2]}_{c[3]}+{c[4]}to{c[5]}" for c in CASES]


def _operands(rng, n, h, w, ca, cb, cout, integer=False):
    cin = ca + cb
    if integer:
        x = rng.integers(-4, 5, (n, cin, h, w)).astype(np.float32)
        k = rng.integers(-4, 5, (cout, cin, 3, 3)).astype(np.float32)
        b = rng.integers(-40, 41, cout).astype(np.float32)
    else:
        x = rng.standard_normal((n, cin, h, w), np.float32)
        k = (rng.standard_normal((cout, cin, 3, 3), np.float32) / np.sqrt(9 * cin)).astype(np.float32)
        b = rng.standard_normal(cout, np.float32)
    return torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b)


def _twin(x, k, b, ca, cb):
    return conv3x3.conv3x3_relu(x[:, :ca], k, b, x[:, ca:] if cb else None)


def _jax(x, k, b):
    """relu(conv2d) of the JAX package (NHWC, HWIO, Precision.HIGHEST), NCHW out."""
    y = jl.conv2d(jnp.asarray(x.permute(0, 2, 3, 1).numpy()), jnp.asarray(k.permute(2, 3, 1, 0).numpy()), jnp.asarray(b.numpy()))
    return np.asarray(jnp.maximum(y, 0)).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("n,h,w,ca,cb,cout", CASES, ids=IDS)
def test_twin_equals_conv2d_and_jax_on_integer_inputs(n, h, w, ca, cb, cout):
    """Small integers make every product and partial sum exact, so any sum
    order gives the same bytes: the twin's bias and ReLU epilogue and its
    taps' alignment equal ``F.conv2d`` + bias + ReLU and the JAX conv."""
    x, k, b = _operands(np.random.default_rng(ca * 100 + cb + h), n, h, w, ca, cb, cout, integer=True)
    got = _twin(x, k, b, ca, cb)
    assert got.shape == (n, cout, h, w) and got.dtype == torch.float32
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = torch.relu(F.conv2d(x, k, b, padding=1))
    assert torch.equal(got, want)
    assert (want == 0).any() and (want > 0).any()  # the ReLU clips and passes
    np.testing.assert_array_equal(got.numpy(), _jax(x, k, b))


@pytest.mark.parametrize("n,h,w,ca,cb,cout", CASES, ids=IDS)
def test_twin_within_float32_of_conv2d_and_jax(n, h, w, ca, cb, cout):
    """Normal inputs: the twin's order moves the sums by float32 rounding
    only (a few units of 1e-6 of the output's scale, over 9 * cin terms)."""
    x, k, b = _operands(np.random.default_rng(7 + ca + cb + cout), n, h, w, ca, cb, cout)
    got = _twin(x, k, b, ca, cb).numpy()
    for want in (torch.relu(F.conv2d(x, k, b, padding=1)).numpy(), _jax(x, k, b)):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * scale)


def test_twin_sums_channel_major_then_taps():
    """The twin's order is the kernel's: for one output, the running float32
    sum over (input channel, tap row-major), then the bias, then the ReLU."""
    rng = np.random.default_rng(3)
    x, k, b = _operands(rng, 1, 3, 3, 5, 0, 4)
    got = conv3x3.conv3x3_relu(x, k, b)[0, :, 1, 1]
    xn, kn, bn = x.numpy(), k.numpy(), b.numpy()
    want = []
    for co in range(4):
        acc = np.float32(0)
        for ci in range(5):
            for tap in range(9):
                acc = np.float32(acc + xn[0, ci, tap // 3, tap % 3] * kn[co, ci, tap // 3, tap % 3])
        want.append(max(np.float32(acc + bn[co]), np.float32(0)))
    np.testing.assert_array_equal(got.numpy(), np.array(want, np.float32))


@pytest.mark.parametrize("cout,cin,bn,bk", [(64, 1, 64, 1), (12, 20, 64, 16), (200, 48, 128, 16), (128, 7, 128, 1)])
def test_pack_weights_layout(cout, cin, bn, bk):
    """Per block of bn output channels, per chunk of bk input channels, per
    channel, per tap: the block's bn output channels, zero where padded."""
    w = torch.randn(cout, cin, 3, 3)
    packed = conv3x3.pack_weights(w, bn, bk)
    nb, chunks = -(-cout // bn), -(-cin // bk)
    assert packed.shape == (nb * chunks * bk * 9 * bn,)
    p = packed.reshape(nb, chunks, bk, 9, bn)
    for blk, ch, ci, tap, co in [(0, 0, 0, 0, 0), (nb - 1, chunks - 1, bk - 1, 8, bn - 1), (0, chunks - 1, 0, 4, 3)]:
        o, i = blk * bn + co, ch * bk + ci
        want = w[o, i, tap // 3, tap % 3] if o < cout and i < cin else 0.0
        assert p[blk, ch, ci, tap, co] == want
    full = torch.zeros(nb * bn, chunks * bk, 3, 3)
    full[:cout, :cin] = w
    assert torch.equal(p.permute(0, 4, 1, 2, 3).reshape(nb * bn, chunks * bk, 3, 3), full)


def test_packed_weights_pack_once_per_weight_version():
    """One packing per weight tensor, kept until its storage, version or
    tiling changes; a deep copy of a layer packs its own."""
    layer = SameConv2d(8, 12, 3)
    first = conv3x3.packed_weights(layer.weight, 64, 16)
    assert torch.equal(first, conv3x3.pack_weights(layer.weight.detach(), 64, 16))
    assert conv3x3.packed_weights(layer.weight, 64, 16) is first
    assert not torch.equal(conv3x3.packed_weights(layer.weight, 64, 1), conv3x3.pack_weights(layer.weight.detach(), 64, 16))
    with torch.no_grad():
        layer.weight.mul_(2)  # an in-place write: a new version
    again = conv3x3.packed_weights(layer.weight, 64, 16)
    assert again is not first and torch.equal(again, 2 * first)
    layer.load_state_dict({"weight": torch.ones_like(layer.weight), "bias": layer.bias.detach()})
    before = conv3x3.packed_weights(layer.weight, 64, 16)
    assert torch.equal(before, conv3x3.pack_weights(torch.ones_like(layer.weight), 64, 16))
    layer.to(torch.float64).to(torch.float32)  # new storage
    after = conv3x3.packed_weights(layer.weight, 64, 16)
    assert after is not before and torch.equal(after, before)
    assert not hasattr(copy.deepcopy(layer).weight, conv3x3.PACKED_ATTR)


@pytest.mark.parametrize("ca,cb,bk", [(1, 0, 1), (64, 0, 16), (12, 0, 16), (512, 512, 16), (32, 8, 16), (8, 8, 1), (24, 24, 1), (6, 2, 1), (3, 0, 1)])
def test_block_k_by_the_channel_counts(ca, cb, bk):
    assert conv3x3.block_k(ca, cb) == bk
    assert cb == 0 or ca % bk == 0  # a chunk never straddles the two halves


def test_block_n_by_cout():
    assert [conv3x3.block_n(c) for c in (4, 32, 64, 68, 128, 1024)] == [64, 64, 64, 128, 128, 128]


def _f32(*shape):
    return torch.zeros(shape, dtype=torch.float32)


@pytest.mark.parametrize(
    "args,exc,match",
    [
        ((_f32(1, 4, 8, 8).double(), _f32(8, 4, 3, 3), _f32(8)), TypeError, "must be float32"),
        ((_f32(1, 4, 8, 8), _f32(8, 4, 3, 3).bfloat16(), _f32(8)), TypeError, "must be float32"),
        ((_f32(1, 4, 8, 8), _f32(8, 4, 1, 1), _f32(8)), ValueError, "is not 3x3"),
        ((_f32(1, 4, 8, 8), _f32(8, 4, 5, 5), _f32(8)), ValueError, "is not 3x3"),
        ((_f32(1, 4, 8, 8), _f32(6, 4, 3, 3), _f32(6)), ValueError, "not a multiple of 4"),
        ((_f32(1, 4, 8, 8), _f32(8, 5, 3, 3), _f32(8)), ValueError, "input channels"),
        ((_f32(1, 4, 8, 8), _f32(8, 4, 3, 3), _f32(4)), ValueError, "bias must be"),
        ((_f32(1, 4, 8, 8), _f32(8, 8, 3, 3), _f32(8), _f32(1, 4, 8, 9)), ValueError, "do not fit"),
    ],
    ids=["x_f64", "w_bf16", "k1", "k5", "cout6", "cin", "bias", "x2_plane"],
)
def test_refusals(args, exc, match):
    with pytest.raises(exc, match=match):
        conv3x3.conv3x3_relu(*args)


def test_refuses_another_device():
    meta = torch.zeros((1, 4, 8, 8), device="meta")
    with pytest.raises(ValueError, match="expected a CPU or CUDA tensor"):
        conv3x3.conv3x3_relu(meta, _f32(8, 4, 3, 3), _f32(8))
    with pytest.raises(ValueError, match="is on meta"):
        conv3x3.conv3x3_relu(_f32(1, 4, 8, 8), _f32(8, 4, 3, 3), torch.zeros(8, device="meta"))


def test_kernel_operands_must_be_channels_last():
    """The card's path reads NHWC memory: an NCHW-contiguous operand is
    refused (the forward hands it channels-last)."""
    x = _f32(2, 4, 8, 8)
    with pytest.raises(ValueError, match="channels-last"):
        conv3x3.check_layout(x, None)
    with pytest.raises(ValueError, match="x2 must be channels-last"):
        conv3x3.check_layout(x.contiguous(memory_format=torch.channels_last), x)
    conv3x3.check_layout(x.contiguous(memory_format=torch.channels_last), x.contiguous(memory_format=torch.channels_last))
    conv3x3.check_layout(_f32(2, 1, 8, 8), None)  # one channel: both layouts at once


def test_refusal_names_what_the_forward_leaves_to_cudnn():
    assert conv3x3.refusal(_f32(1, 4, 8, 8), _f32(8, 4, 3, 3)) is None
    assert conv3x3.refusal(_f32(1, 4, 8, 8), _f32(8, 8, 3, 3), _f32(1, 4, 8, 8)) is None
    assert "not 3x3" in conv3x3.refusal(_f32(1, 4, 8, 8), _f32(4, 4, 1, 1))
    assert "multiple of 4" in conv3x3.refusal(_f32(1, 4, 8, 8), _f32(6, 4, 3, 3))


# --- MetasegUNet's routing ---------------------------------------------------


def _card_input(requires_grad=False):
    """What ``_kernel_route`` reads of a CUDA tensor (this host has no card)."""
    return types.SimpleNamespace(is_cuda=True, requires_grad=requires_grad)


def test_route_takes_the_kernel_only_on_the_card_in_float32_without_autograd():
    model = MetasegUNet((8, 16), 32)
    x = torch.zeros((1, 256, 256, 1), dtype=torch.uint8)
    with torch.no_grad():
        assert not model._kernel_route(x, torch.float32)  # the CPU
        assert model._kernel_route(_card_input(), torch.float32)
        assert not model._kernel_route(_card_input(), torch.bfloat16)  # the bf16 forms
    # autograd records: parameters that require grad (the training step's forward)
    assert torch.is_grad_enabled()
    assert not model._kernel_route(_card_input(), torch.float32)
    assert not model._kernel_route(_card_input(requires_grad=True), torch.float32)
    model.requires_grad_(False)
    assert model._kernel_route(_card_input(), torch.float32)  # nothing to record
    assert not model._kernel_route(_card_input(requires_grad=True), torch.float32)
    assert not model.to(torch.bfloat16)._kernel_route(_card_input(), torch.float32)  # bf16 weights


def _count_conv3x3(monkeypatch, raise_on_call=False):
    calls = []
    real = conv3x3.conv3x3_relu

    def counted(*a, **k):
        if raise_on_call:
            raise AssertionError("routed to the conv3x3 kernel")
        calls.append(a[1].shape)
        return real(*a, **k)

    monkeypatch.setattr(conv3x3, "conv3x3_relu", counted)
    return calls


class _ConvCalls(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is F.conv2d:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _old_forward(model, x):
    """The float32 forward before the kernel: relu(cuDNN conv with fused
    bias) of the concat at every 3x3 layer, NCHW."""
    L = model.layers
    x = x.permute(0, 3, 1, 2).float() / 255.0
    skips = []
    for i in range(1, 5):
        x = torch.relu(L[f"enc{i}_1"](x))
        x = torch.relu(L[f"enc{i}_2"](x))
        skips.append(x)
        x = F.max_pool2d(x, 2, 2, ceil_mode=True)
    x = torch.relu(L["bott_2"](torch.relu(L["bott_1"](x))))
    for i in range(4, 0, -1):
        x = torch.relu(L[f"up{i}"](x))
        x = torch.relu(L[f"dec{i}_1"](torch.cat([skips[i - 1], x], dim=1)))
        x = torch.relu(L[f"dec{i}_2"](x))
    return torch.softmax(L["head"](x).float(), dim=1).permute(0, 2, 3, 1)


def test_cpu_forward_keeps_conv2d_bit_for_bit(monkeypatch):
    calls = _count_conv3x3(monkeypatch, raise_on_call=True)
    model = MetasegUNet((4, 8, 8, 8), 16, generator=torch.Generator().manual_seed(2)).eval()
    x = torch.from_numpy((np.random.default_rng(2).random((2, 64, 64, 1)) * 255).astype(np.uint8))
    rec = _ConvCalls()
    with torch.no_grad(), rec:
        got = model(x)
    assert rec.n == 19 and not calls  # 18 3x3 convs and the head, all F.conv2d
    with torch.no_grad():
        assert torch.equal(got, _old_forward(model, x))


def test_autograd_and_bf16_forwards_keep_conv2d(monkeypatch):
    """With the input taken for a card's, the predicate still sends the
    training step's forward (autograd records) and the bf16 forms to
    ``F.conv2d``."""
    _count_conv3x3(monkeypatch, raise_on_call=True)
    route = MetasegUNet._kernel_route
    monkeypatch.setattr(MetasegUNet, "_kernel_route", lambda self, x, dtype: route(self, _card_input(x.requires_grad), dtype))
    model = MetasegUNet((4, 8, 8, 8), 16)
    x = torch.from_numpy((np.random.default_rng(4).random((1, 32, 32, 1)) * 255).astype(np.uint8))
    model(x).sum().backward()  # autograd records: no kernel
    assert model.layers["enc1_1"].weight.grad is not None
    with torch.no_grad():
        model(x, dtype=torch.bfloat16)  # bf16 activations: no kernel
        model.to(torch.bfloat16)(x)  # bf16 weights: no kernel


def test_routed_forward_runs_18_kernel_convs_and_matches_jax(monkeypatch):
    """The routed forward with the twin in the kernel's place (the CPU has
    no card): 18 3x3 convs through ``conv3x3_relu``, channels-last through
    the trunk, ``dec*_1`` reading its two halves in place; the
    probabilities within float32 of the JAX package's forward."""
    calls = _count_conv3x3(monkeypatch)
    monkeypatch.setattr(MetasegUNet, "_kernel_route", lambda self, x, dtype: True)
    tree = numpy_metaseg_tree((8, 16, 16, 16), 32, seed=5)
    x = (np.random.default_rng(5).random((2, 128, 128, 1)) * 255).astype(np.uint8)
    want = np.asarray(jax.jit(ju.forward)(tree, jnp.asarray(x)))
    model = params_from_numpy(tree).eval()
    fallbacks.reset()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(calls) == 18 and fallbacks.counts() == {}
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_refused_shapes_go_to_cudnn_and_are_counted(monkeypatch):
    """A routed forward whose layers the kernel refuses (cout 6: not a
    multiple of 4) runs them through ``F.conv2d`` and counts each in
    ``runtime/fallbacks``."""
    calls = _count_conv3x3(monkeypatch)
    monkeypatch.setattr(MetasegUNet, "_kernel_route", lambda self, x, dtype: True)
    model = MetasegUNet((6, 8, 8, 8), 16, generator=torch.Generator().manual_seed(6)).eval()
    x = torch.from_numpy((np.random.default_rng(6).random((1, 64, 64, 1)) * 255).astype(np.uint8))
    fallbacks.reset()
    try:
        with torch.no_grad():
            got = model(x)
            want = _old_forward(model, x)
        assert fallbacks.counts() == {fallbacks.CONV3X3_CUDNN: 4}  # enc1_1, enc1_2, dec1_1, dec1_2
        assert len(calls) == 14
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    finally:
        fallbacks.reset()


def test_nuset_keeps_conv2d(monkeypatch):
    from ecseg_torch.models.nuset import NuSeTUNet

    _count_conv3x3(monkeypatch, raise_on_call=True)
    model = NuSeTUNet().eval()
    rec = _ConvCalls()
    with torch.no_grad(), rec:
        model(torch.zeros((1, 1, 64, 64)))
    assert rec.n > 0
