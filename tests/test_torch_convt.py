"""The port's B11 twin (ecseg_torch/ops/convt.conv2d_transpose_packed on
CPU tensors) against ``ecseg_tpu.ops.convt_pallas.conv2d_transpose_packed``
(interpret mode on the CPU) on tests/test_convt_pallas.py's shapes --
bit-equal on integer inputs, where every product and sum is exact, and
within that file's bf16 bound -- and against the port's own
``TFConvTranspose2d`` + ReLU.  The CUDA kernel is held against the twin on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ecseg_tpu.models.layers import conv2d_transpose
from ecseg_tpu.ops.convt_pallas import conv2d_transpose_packed as jax_packed
from ecseg_torch.models.layers import TFConvTranspose2d
from ecseg_torch.ops.convt import conv2d_transpose_packed, pack_mma_weights

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

SHAPES = [  # tests/test_convt_pallas.py:17-25
    (3, 16, 16, 512, 256),
    (2, 32, 32, 256, 128),
    (2, 64, 64, 128, 64),
    (5, 8, 24, 8, 128),
    (1, 16, 40, 16, 64),
]


def _ints(rng, shape, lim=4):
    return rng.integers(-lim, lim + 1, shape).astype(np.float32)


@pytest.mark.parametrize("n,h,w,cin,cout", SHAPES)
def test_twin_equals_jax_on_integer_inputs(n, h, w, cin, cout):
    rng = np.random.default_rng(n * 1000 + h + cin)
    x, k, b = _ints(rng, (n, h, w, cin)), _ints(rng, (3, 3, cin, cout)), _ints(rng, (cout,))
    want = np.asarray(jax_packed(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    got = conv2d_transpose_packed(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b))
    assert got.shape == (n, 2 * h, 2 * w, cout) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_twin_bf16_within_the_jax_bound():
    """tests/test_convt_pallas.py:46-61's bound: bf16 inputs within 5 % of
    the largest f32 output, for both the JAX kernel and the twin (each
    rounds once, to bf16, after a float32 sum)."""
    rng = np.random.default_rng(0)
    n, h, w, cin, cout = 2, 16, 16, 64, 64
    x, k, b = (rng.standard_normal(s, np.float32) for s in ((n, h, w, cin), (3, 3, cin, cout), (cout,)))
    want = np.maximum(np.asarray(conv2d_transpose(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))), 0)
    scale = np.abs(want).max()
    got = conv2d_transpose_packed(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16(), torch.from_numpy(b)
    )
    assert got.dtype == torch.bfloat16
    assert np.abs(want - got.float().numpy()).max() <= 0.05 * scale
    jgot = np.asarray(
        jax_packed(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(b))
    ).astype(np.float32)
    # twin and JAX kernel: the same bf16 products, float32 sums in another
    # order, one rounding each: at most one bf16 ulp (2**-8 relative) apart
    # plus the sum-order noise of float32 (1e-5 of the output scale)
    assert (np.abs(jgot - got.float().numpy()) <= 2**-8 * np.abs(jgot) + 1e-5 * scale).all()


def test_twin_without_bias_equals_jax():
    rng = np.random.default_rng(1)
    x, k = _ints(rng, (2, 16, 16, 32), 3), _ints(rng, (3, 3, 32, 64), 3)
    want = np.asarray(jax_packed(jnp.asarray(x), jnp.asarray(k), None))
    np.testing.assert_array_equal(conv2d_transpose_packed(torch.from_numpy(x), torch.from_numpy(k)).numpy(), want)


@pytest.mark.parametrize("size", [8, 9])
def test_twin_equals_the_ports_transpose_layer(size):
    rng = np.random.default_rng(size)
    x, k, b = _ints(rng, (2, size, size, 6)), _ints(rng, (3, 3, 6, 8)), _ints(rng, (8,))
    layer = TFConvTranspose2d(6, 8)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(k).permute(2, 3, 0, 1))
        layer.bias.copy_(torch.from_numpy(b))
        want = torch.relu(layer(torch.from_numpy(x).permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
    got = conv2d_transpose_packed(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b))
    assert torch.equal(got, want)


def test_relu_off_is_refused_as_in_jax():
    with pytest.raises(NotImplementedError):
        conv2d_transpose_packed(torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 4, 64), relu=False)


# tap ky * 3 + kx -> (the window it reads: 0 x[i][j], 1 x[i][j-1],
# 2 x[i-1][j], 3 x[i-1][j-1]; the output parity a * 2 + b it feeds), as
# csrc/convt.cu's win_of / par_of
PARITY_TAPS = ((0, 0), (0, 1), (1, 0), (0, 2), (0, 3), (1, 2), (2, 0), (2, 1), (3, 0))


def unpack_mma_weights(packed, cin, cout):
    """``pack_mma_weights``'s output back to the HWIO kernel."""
    chunks, blocks = -(-cin // 32), -(-cout // 64)
    k = packed.reshape(blocks, chunks, 9, 4, 8, 8, 8).permute(2, 1, 3, 6, 0, 4, 5)
    return k.reshape(3, 3, chunks * 32, blocks * 64)[:, :, :cin, :cout]


def _parity_einsum(x, packed, cin, cout, bias):
    """The bf16 kernel's algorithm in torch, float64: the four windows
    x[i][j], x[i][j-1], x[i-1][j], x[i-1][j-1] (zero outside the input)
    times the taps unpacked from the packed weights, summed per output
    parity through ``PARITY_TAPS`` (9 products, no zero taps), then the
    bias, the ReLU and the pixel shuffle."""
    n, h, w, _ = x.shape
    k = unpack_mma_weights(packed, cin, cout).reshape(9, cin, cout).double()
    xp = torch.nn.functional.pad(x.double(), (0, 0, 1, 0, 1, 0))
    windows = [xp[:, 1:, 1:], xp[:, 1:, :-1], xp[:, :-1, 1:], xp[:, :-1, :-1]]
    par = torch.zeros(4, n, h, w, cout, dtype=torch.float64)
    for tap, (v, p) in enumerate(PARITY_TAPS):
        par[p] += torch.einsum("nhwc,co->nhwo", windows[v], k[tap])
    y = torch.relu(par + bias.double()).reshape(2, 2, n, h, w, cout)
    return y.permute(2, 3, 0, 4, 1, 5).reshape(n, 2 * h, 2 * w, cout)


@pytest.mark.parametrize("n,h,w,cin,cout", SHAPES + [(2, 5, 7, 3, 4), (1, 9, 17, 40, 68)])
def test_packed_weights_and_parity_table(n, h, w, cin, cout):
    """The packed weights (64-channel blocks x 32-channel chunks x 9 taps,
    each a canonical (64, 32) block) unpack to the HWIO kernel, and the
    four-window einsum over them with the per-parity tap table equals the
    twin on integer inputs (exact), also off the kernel's blocking."""
    rng = np.random.default_rng(n + h + w + cin + cout)
    x, k, b = _ints(rng, (n, h, w, cin)), _ints(rng, (3, 3, cin, cout)), _ints(rng, (cout,))
    packed = pack_mma_weights(torch.from_numpy(k))
    assert packed.numel() == 9 * -(-cin // 32) * 32 * -(-cout // 64) * 64
    assert torch.equal(unpack_mma_weights(packed, cin, cout), torch.from_numpy(k))
    got = _parity_einsum(torch.from_numpy(x), packed, cin, cout, torch.from_numpy(b))
    want = conv2d_transpose_packed(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b))
    assert torch.equal(got.float(), want)


@pytest.mark.parametrize("n,h,w,cin,cout", SHAPES)
def test_parity_einsum_equals_jax(n, h, w, cin, cout):
    """The same einsum against the JAX kernel (interpret mode) on
    tests/test_convt_pallas.py's shapes, integer-valued (exact)."""
    rng = np.random.default_rng(7 * n + cin)
    x, k, b = _ints(rng, (n, h, w, cin)), _ints(rng, (3, 3, cin, cout)), _ints(rng, (cout,))
    want = np.asarray(jax_packed(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    got = _parity_einsum(torch.from_numpy(x), pack_mma_weights(torch.from_numpy(k)), cin, cout, torch.from_numpy(b))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_packed_tap_is_canonical():
    """Block 0, chunk 0, tap t of the packed weights: weight (k, n) in core
    matrix (k // 8, n // 8) at index (k // 8) * 8 + n // 8, row n % 8,
    column k % 8."""
    k = torch.arange(9 * 32 * 64, dtype=torch.float32).reshape(3, 3, 32, 64)
    packed = pack_mma_weights(k)
    for tap in (0, 4, 8):
        for kk, nn in [(0, 0), (5, 3), (9, 17), (31, 63)]:
            idx = tap * 2048 + ((kk // 8) * 8 + nn // 8) * 64 + (nn % 8) * 8 + kk % 8
            assert packed[idx] == k[tap // 3, tap % 3, kk, nn]
