"""The metaseg forward's float32 3x3 conv (ecseg_torch/ops/conv3x3.py): its
plain twin -- the kernel's sums in the kernel's order -- against
``F.conv2d`` and the JAX package's ``conv2d`` at ``Precision.HIGHEST``, the
weight packing the kernel reads, the wrapper's refusals, and the route
that ``MetasegUNet`` and ``NuSeTUNet`` share (``layers.KernelRouted``): the
kernel only for a float32 forward on the card that builds no autograd
graph; the CPU, autograd's forward and bf16 keep ``F.conv2d``; the
kernel's tile choice at each metaseg layer, and its acceptance of every
NuSeT layer.  The CUDA kernel is held against cuDNN and the twin on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

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
from ecseg_torch.models import layers, nuset
from ecseg_torch.models.layers import SameConv2d
from ecseg_torch.models.metaseg_unet import ENC_WIDTHS_XL, BOTTLENECK_XL, MetasegUNet
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


def _routed_forward_against_jax(monkeypatch, ups_on_kernel):
    calls = _count_conv3x3(monkeypatch)
    monkeypatch.setattr(MetasegUNet, "_kernel_route", lambda self, x, dtype: True)
    monkeypatch.setattr(layers, "ZERO_SPREAD_MAX_IMAGES", 2 if ups_on_kernel else 1)
    tree = numpy_metaseg_tree((8, 16, 16, 16), 32, seed=5)
    x = (np.random.default_rng(5).random((2, 128, 128, 1)) * 255).astype(np.uint8)
    want = np.asarray(jax.jit(ju.forward)(tree, jnp.asarray(x)))
    model = params_from_numpy(tree).eval()
    fallbacks.reset()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(calls) == 18 + 4 * ups_on_kernel and fallbacks.counts() == {}
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_routed_forward_runs_18_kernel_convs_and_matches_jax(monkeypatch):
    """The routed forward with the twin in the kernel's place (the CPU has
    no card), at a batch over ``layers.ZERO_SPREAD_MAX_IMAGES``: 18 3x3
    convs through ``conv3x3_relu``, channels-last through the trunk,
    ``dec*_1`` reading its two halves in place; the probabilities within
    float32 of the JAX package's forward."""
    _routed_forward_against_jax(monkeypatch, ups_on_kernel=False)


def test_routed_small_batch_runs_its_transpose_convs_on_the_kernel_and_matches_jax(monkeypatch):
    """As above at a batch of ``layers.ZERO_SPREAD_MAX_IMAGES`` or fewer:
    the four transpose convs take the kernel too, as 3x3 convs of the
    zero-spread input (22 calls), within float32 of the JAX package."""
    _routed_forward_against_jax(monkeypatch, ups_on_kernel=True)


def test_refused_shapes_go_to_cudnn_and_are_counted(monkeypatch):
    """A routed forward whose layers the kernel refuses (cout 6: not a
    multiple of 4) runs them through ``F.conv2d`` and counts each in
    ``runtime/fallbacks``."""
    calls = _count_conv3x3(monkeypatch)
    monkeypatch.setattr(MetasegUNet, "_kernel_route", lambda self, x, dtype: True)
    monkeypatch.setattr(layers, "ZERO_SPREAD_MAX_IMAGES", 0)  # the transpose convs on cuDNN
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
    """NuSeT's forward on the CPU: every conv through ``F.conv2d``."""
    _count_conv3x3(monkeypatch, raise_on_call=True)
    model = nuset.NuSeTUNet().eval()
    rec = _ConvCalls()
    with torch.no_grad(), rec:
        model(torch.zeros((1, 1, 64, 64)))
    assert rec.n > 0


# --- the tile choice at metaseg's layers ------------------------------------

# (block_n, block_k) of each 3x3 conv in forward order: enc1_1 ... bott_2,
# dec4_1 ... dec1_2; enc1_1's one channel is copied an element at a time
METASEG_TILES = {
    "default": [(64, 1), (64, 16), (64, 16), (64, 16), (128, 16), (128, 16), (128, 16), (128, 16), (128, 16), (128, 16),
                (128, 16), (128, 16), (128, 16), (128, 16), (64, 16), (64, 16), (64, 16), (64, 16)],
    "xl": [(64, 1), (64, 16), (128, 16), (128, 16), (128, 16), (128, 16), (128, 16), (128, 16), (128, 16), (128, 16),
           (128, 16), (128, 16), (128, 16), (128, 16), (128, 16), (128, 16), (64, 16), (64, 16)],
}


def _record_tiles(monkeypatch):
    """Route every forward to the kernel with the twin in its place, and
    record each call's (block_n, block_k), as ``conv3x3_relu`` picks them
    on the card."""
    tiles = []
    real = conv3x3.conv3x3_relu

    def recorded(x, weight, bias, x2=None, relu=True):
        tiles.append((conv3x3.block_n(weight.shape[0]), conv3x3.block_k(x.shape[1], 0 if x2 is None else x2.shape[1])))
        return real(x, weight, bias, x2, relu)

    monkeypatch.setattr(conv3x3, "conv3x3_relu", recorded)
    return tiles


@pytest.mark.parametrize("arch", sorted(METASEG_TILES))
def test_metaseg_tiles_are_pinned(monkeypatch, arch):
    """The shared route leaves metaseg's launches and their tiles as they
    were at a batch over ``layers.ZERO_SPREAD_MAX_IMAGES`` (its 100-patch
    calls; the limit lowered to 1 here, so that 2 patches do): 18 calls a
    forward, each layer's (block_n, block_k) as pinned."""
    tiles = _record_tiles(monkeypatch)
    monkeypatch.setattr(MetasegUNet, "_kernel_route", lambda self, x, dtype: True)
    monkeypatch.setattr(layers, "ZERO_SPREAD_MAX_IMAGES", 1)
    widths = {"default": {}, "xl": {"widths": ENC_WIDTHS_XL, "bottleneck": BOTTLENECK_XL}}[arch]
    model = MetasegUNet(**widths).eval()
    fallbacks.reset()
    with torch.no_grad():
        model(torch.zeros((2, 16, 16, 1), dtype=torch.uint8))
    assert tiles == METASEG_TILES[arch] and fallbacks.counts() == {}


@pytest.mark.parametrize("arch", sorted(METASEG_TILES))
def test_metaseg_small_batch_runs_its_transpose_convs_on_the_kernel(monkeypatch, arch):
    """At ``layers.ZERO_SPREAD_MAX_IMAGES`` patches or fewer (one here)
    the four transpose convs take the kernel too, after the layer they upsample
    from: the 18 3x3 convs keep their pinned tiles; each transpose conv
    runs at its own cout's block_n and 16-channel chunks."""
    tiles = _record_tiles(monkeypatch)
    monkeypatch.setattr(MetasegUNet, "_kernel_route", lambda self, x, dtype: True)
    widths = {"default": {}, "xl": {"widths": ENC_WIDTHS_XL, "bottleneck": BOTTLENECK_XL}}[arch]
    model = MetasegUNet(**widths).eval()
    fallbacks.reset()
    with torch.no_grad():
        model(torch.zeros((1, 16, 16, 1), dtype=torch.uint8))
    pinned, want = METASEG_TILES[arch], []
    for k, w in enumerate(model.widths[::-1]):  # up4 after bott_2, up3 after dec4_2, ...: cout the level's width
        want += pinned[: 10] if k == 0 else pinned[8 + 2 * k : 10 + 2 * k]
        want.append((conv3x3.block_n(w), conv3x3.BK_VEC))
    want += pinned[16:]  # dec1_1, dec1_2
    assert tiles == want and fallbacks.counts() == {}


def test_transpose_route_is_chosen_by_batch():
    """One choice for every routed transpose conv, from its input's batch:
    the kernel up to ``layers.ZERO_SPREAD_MAX_IMAGES`` images (NuSeT's
    passes hold one), cuDNN above."""
    limit = layers.ZERO_SPREAD_MAX_IMAGES
    assert limit >= 1
    for n, want in ((1, True), (limit, True), (limit + 1, False), (100, False)):
        assert layers.transpose_on_kernel(torch.empty((n, 8, 4, 4), device="meta")) == want


# --- NuSeT's 3x3 convs on the kernel ----------------------------------------

NUSET_SIDE = 608  # NuSeT's input side at stat_fish's 0.3 scale on a 2048^2 image


def _nuset_relu_convs():
    """NuSeT's 18 ReLU'd 3x3 convs, in forward order: (name, plane side at
    a 608^2 input, channels of x, of x2, cout)."""
    rows, c = [], 1
    for i, w in enumerate(nuset.ENC_WIDTHS, start=1):
        side = NUSET_SIDE >> (i - 1)
        rows += [(f"conv{i}-1", side, c, 0, w), (f"conv{i}-2", side, w, 0, w)]
        c = w
    side = NUSET_SIDE >> 4
    rows += [("conv5-1", side, c, 0, nuset.BOTTLENECK), ("conv5-2", side, nuset.BOTTLENECK, 0, nuset.BOTTLENECK)]
    for i, w in zip((4, 3, 2, 1), nuset.ENC_WIDTHS[::-1]):
        side = NUSET_SIDE >> (i - 1)
        first = (f"conv{i}-3", side, w, 0, w) if i == 4 else (f"conv{i}-3", side, w, w, w)  # skip first, then the upsampled half
        rows += [first, (f"conv{i}-4", side, w, 0, w)]
    return rows


NUSET_CONVS = _nuset_relu_convs()


@pytest.mark.parametrize("name,side,ca,cb,cout", NUSET_CONVS, ids=[r[0] for r in NUSET_CONVS])
def test_kernel_takes_every_nuset_relu_conv_at_608(name, side, ca, cb, cout):
    """No NuSeT layer is a shape the kernel refuses: ``conv{1,2,3}-3`` as
    the skip (``x``) and the transpose conv's output (``x2``), ``conv1-1``'s
    one channel an element at a time, every other chunk 16 channels."""
    x = torch.empty((1, ca, side, side), device="meta")
    x2 = torch.empty((1, cb, side, side), device="meta") if cb else None
    weight = torch.empty((cout, ca + cb, 3, 3), device="meta")
    assert conv3x3.refusal(x, weight, x2) is None
    assert conv3x3.block_k(ca, cb) == (conv3x3.BK_ELEM if name == "conv1-1" else conv3x3.BK_VEC)
    assert conv3x3.block_n(cout) == (conv3x3.BN_SMALL if cout <= 64 else conv3x3.BN_LARGE)


def test_nuset_relu_convs_are_the_models():
    """The table above is NuSeTUNet's: its 3x3 convs less ``final``, with
    their input channels split where the decoder concatenates."""
    model = nuset.NuSeTUNet()
    convs = [name for name, layer in model.layers.items() if isinstance(layer, SameConv2d)]
    assert [r[0] for r in NUSET_CONVS] == convs and len(convs) == 18
    for name, _, ca, cb, cout in NUSET_CONVS:
        assert tuple(model.layers[name].weight.shape) == (cout, ca + cb, 3, 3)


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "normal"])
@pytest.mark.parametrize("w", [64, 128, 256], ids=lambda w: f"conv_skip{w}")
def test_twin_on_nuset_skip_first_concat(w, integer):
    """``conv{1,2,3}-3``'s form: the twin on the skip and the upsampled half
    against ``relu(F.conv2d(cat([skip, up])) + bias)``, the bias added
    after the float32 conv as ``layers.conv_same`` adds it: equal on small
    integers (every sum exact), within float32 sum-order noise otherwise."""
    x, k, b = _operands(np.random.default_rng(w + integer), 1, 12, 10, w, w, w, integer=integer)
    got = conv3x3.conv3x3_relu_plain(x[:, :w], k, b, x[:, w:])
    want = torch.relu(layers.conv_same(torch.cat([x[:, :w], x[:, w:]], dim=1), k, b))
    if integer:
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5 * float(want.abs().max()))
    assert (want == 0).any() and (want > 0).any()


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "normal"])
@pytest.mark.parametrize("cb", [0, 8], ids=["one_input", "two_halves"])
def test_twin_without_relu_is_the_conv_plus_bias(cb, integer):
    """``relu=False``: the twin's sums and bias with the negative outputs
    kept, equal to ``conv_same`` on small integers, within float32
    sum-order noise otherwise; ``relu=True`` is its ReLU, bit for bit."""
    x, k, b = _operands(np.random.default_rng(20 + cb + integer), 2, 9, 11, 8, cb, 12, integer=integer)
    x2 = x[:, 8:] if cb else None
    got = conv3x3.conv3x3_relu_plain(x[:, :8], k, b, x2, relu=False)
    want = layers.conv_same(x, k, b)
    assert got.is_contiguous(memory_format=torch.channels_last) and (got < 0).any()
    if integer:
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5 * float(want.abs().max()))
    assert torch.equal(conv3x3.conv3x3_relu_plain(x[:, :8], k, b, x2), torch.relu(got))
    assert torch.equal(conv3x3.conv3x3_relu(x[:, :8], k, b, x2, relu=False), got)  # the CPU's dispatch


@pytest.fixture(scope="module")
def nuset_unet():
    return nuset.NuSeTUNet(torch.Generator().manual_seed(1)).eval()


def test_route_says_no_to_nuset_off_the_card_under_autograd_and_off_float32(nuset_unet):
    """The shared route on NuSeT's U-Net: the kernel only for a float32
    forward of float32 weights on the card that builds no autograd graph."""
    x = torch.zeros((1, 1, 32, 32))
    with torch.no_grad():
        assert not nuset_unet._kernel_route(x, x.dtype)  # the CPU
        assert nuset_unet._kernel_route(_card_input(), torch.float32)
        for dtype in (torch.float64, torch.bfloat16, torch.float16):
            assert not nuset_unet._kernel_route(_card_input(), dtype)
    assert torch.is_grad_enabled()
    assert not nuset_unet._kernel_route(_card_input(), torch.float32)  # its parameters record
    frozen = copy.deepcopy(nuset_unet).requires_grad_(False)
    assert frozen._kernel_route(_card_input(), torch.float32)
    assert not frozen._kernel_route(_card_input(requires_grad=True), torch.float32)
    assert not frozen.to(torch.float64)._kernel_route(_card_input(), torch.float32)  # float64 weights


def test_nuset_refused_shapes_go_to_conv_same_and_are_counted(monkeypatch):
    """A routed NuSeT forward whose level-1 widths the kernel refuses (cout
    6) runs those four convs and ``deconv1`` (6 output channels) on cuDNN
    and counts each; the other 14 and 3 transpose convs take the kernel
    (the twin here) and the logits stay within float32 of the unrouted
    forward's."""
    monkeypatch.setattr(nuset, "ENC_WIDTHS", (6, 8, 8, 8))
    monkeypatch.setattr(nuset, "BOTTLENECK", 16)
    model = nuset.NuSeTUNet(torch.Generator().manual_seed(6)).eval()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 1, 32, 48), np.float32))
    with torch.no_grad():
        want, want_feat = model(x)
    calls = _count_conv3x3(monkeypatch)
    monkeypatch.setattr(nuset.NuSeTUNet, "_kernel_route", lambda self, x, dtype: True)
    fallbacks.reset()
    try:
        with torch.no_grad():
            got, feat = model(x)
        assert fallbacks.counts() == {fallbacks.CONV3X3_CUDNN: 5}  # deconv1, conv1-1, conv1-2, conv1-3, conv1-4
        assert len(calls) == 17
    finally:
        fallbacks.reset()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(feat.numpy(), want_feat.numpy(), atol=1e-5, rtol=0)


# --- a transpose conv on the kernel ----------------------------------------

DECONV_CASES = [  # (cin, cout, h, w): NuSeT's levels at small planes, odd and one-pixel planes
    (1024, 512, 3, 2), (64, 32, 7, 5), (16, 8, 1, 1), (8, 4, 6, 9), (12, 64, 4, 4),
]


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("cin,cout,h,w", DECONV_CASES, ids=[f"{c[0]}to{c[1]}_{c[2]}x{c[3]}" for c in DECONV_CASES])
def test_transpose_conv_on_the_kernel_equals_forward_bias_after(cin, cout, h, w, relu):
    """``layers.kernel_conv_transpose3x3`` with the twin in the kernel's
    place: TF's stride-2 'SAME' transpose conv (``forward_bias_after``, then
    the ReLU on ``relu``) as the 3x3 conv of the zero-spread input; equal
    on small integers (every sum exact), within float32 sum-order noise
    otherwise; channels-last."""
    layer = layers.TFConvTranspose2d(cin, cout)
    rng = np.random.default_rng(cin + cout + h + relu)
    for integer in (True, False):
        with torch.no_grad():
            if integer:
                layer.weight.copy_(torch.from_numpy(rng.integers(-4, 5, layer.weight.shape).astype(np.float32)))
                layer.bias.copy_(torch.from_numpy(rng.integers(-40, 41, cout).astype(np.float32)))
                x = torch.from_numpy(rng.integers(-4, 5, (1, cin, h, w)).astype(np.float32))
            else:
                layer.weight.copy_(torch.from_numpy(rng.standard_normal(layer.weight.shape, np.float32) / np.sqrt(9 * cin)))
                layer.bias.copy_(torch.from_numpy(rng.standard_normal(cout, np.float32)))
                x = torch.from_numpy(rng.standard_normal((1, cin, h, w), np.float32))
            want = layer.forward_bias_after(x)
            want = torch.relu(want) if relu else want
            got = layers.kernel_conv_transpose3x3(layer, x.contiguous(memory_format=torch.channels_last), relu)
        assert got.shape == (1, cout, 2 * h, 2 * w) and got.is_contiguous(memory_format=torch.channels_last)
        if integer:
            assert torch.equal(got, want)
            assert (want < 0).any() != relu  # the linear form keeps its negative outputs
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5 * float(want.abs().max()))


def test_transpose_conv_weights_are_kept_until_the_layer_changes():
    """The flipped kernel is made once per weight version, and again after
    an in-place write; the linear form runs the kernel without its ReLU,
    on the same weights, with no second output block."""
    layer = layers.TFConvTranspose2d(8, 4)
    k = layers._transpose_as_conv(layer)
    assert k.shape == (4, 8, 3, 3) and torch.equal(k, layer.weight.detach().permute(1, 0, 2, 3).flip(2, 3))
    assert layers._transpose_as_conv(layer) is k
    with torch.no_grad():
        layer.weight.mul_(2)
    assert torch.equal(layers._transpose_as_conv(layer), 2 * k)


def test_transpose_conv_without_a_bias_or_at_another_stride_is_left_to_its_layer():
    x = torch.zeros((1, 8, 4, 4)).contiguous(memory_format=torch.channels_last)
    assert layers.kernel_conv_transpose3x3(SameConv2d(8, 4, 3), x, True) is None
    assert layers.kernel_conv_transpose3x3(layers.TFConvTranspose2d(8, 4, stride=1), x, True) is None
