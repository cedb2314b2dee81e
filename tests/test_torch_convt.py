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
from ecseg_torch.ops.convt import conv2d_transpose_packed

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
