"""The port's int8 U-Net (``ecseg_torch/models/quant.py``) against
``ecseg_tpu/models/quant.py`` on the CPU: the int8 kernels and scales
bit-equal (transpose layers included), the int32 accumulators of a plain and
a transpose conv bit-equal to XLA's ``conv_general_dilated`` with
``preferred_element_type=int32`` on the same int8 input (through the
GEMM's k/n padding, its m padding and several batch chunks), and the whole
forward at widths (8, 16), bottleneck 32, on tests/test_quant.py's blob
inputs: probabilities within ``PROB_ATOL`` of the JAX int8 forward and
labels agreeing on >= ``JAX_AGREEMENT`` of the pixels (observed: max |diff|
3e-8, agreement 1.0; the bf16 rescale may round differently from
XLA:CPU's, so the bound is not bit-equality), and >= 0.95 label agreement
with the port's float32 forward, as tests/test_quant.py asks of JAX."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from ecseg_tpu.models import quant as jq
from ecseg_torch.models import quant as tq
from ecseg_torch.models.weights import params_from_numpy, quant_params_from_numpy

from _torchutil import numpy_metaseg_tree, single_torch_thread  # noqa: F401 (autouse fixture)

PROB_ATOL = 1e-3
JAX_AGREEMENT = 0.99
FLOAT_AGREEMENT = 0.95  # tests/test_quant.py's bound for the JAX package


@pytest.fixture(scope="module")
def tree():
    """init_params' structure and distributions (seeded numpy kernels, small
    random biases) at widths (8, 16), bottleneck 32."""
    return numpy_metaseg_tree((8, 16), 32, seed=3)


def _blobs():
    """tests/test_quant.py's inputs: dark background with bright blobs."""
    rng = np.random.default_rng(1)
    x = (rng.random((4, 64, 64, 1)) * 60).astype(np.float32)
    for b in range(4):
        for _ in range(12):
            y0, x0 = rng.integers(0, 56, 2)
            x[b, y0 : y0 + 8, x0 : x0 + 8] += 170
    return np.clip(x, 0, 255).astype(np.uint8)


def _bits(a):
    return np.asarray(a).view(np.uint32)


def test_quantize_kernel_matches_jax():
    k = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (3, 3, 16, 32)) * 0.2)
    kq, scale = tq.quantize_kernel(k)
    jkq, jscale = jq.quantize_kernel(jnp.asarray(k))
    assert kq.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(kq.numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(_bits(scale.numpy()), _bits(jscale))


def test_quantize_unet_matches_jax(tree):
    got = tq.quantize_unet(tree)
    want = jq.quantize_unet(jax.tree.map(jnp.asarray, tree))
    assert set(got) == set(want) == set(tree)
    assert set(got["enc1_1"]) == {"kernel", "bias"}  # the default skip stays float
    np.testing.assert_array_equal(got["enc1_1"]["kernel"].numpy(), np.asarray(want["enc1_1"]["kernel"]))
    for name in tree:
        if name == "enc1_1":
            continue
        assert set(got[name]) == set(want[name]) == {"kernel_q", "scale", "bias"}, name
        np.testing.assert_array_equal(got[name]["kernel_q"].numpy(), np.asarray(want[name]["kernel_q"]), err_msg=name)
        np.testing.assert_array_equal(_bits(got[name]["scale"].numpy()), _bits(want[name]["scale"]), err_msg=name)
        # a transpose kernel's scales are per output channel of the op (HWIO axis 3)
        assert got[name]["scale"].shape == (tree[name]["kernel"].shape[3],)


def _jax_int32(xq, kq, transpose, stride=2):
    """``ecseg_tpu/models/quant.qconv2d``'s int32 convolution, as it calls it."""
    dn = ("NHWC", "HWIO", "NHWC")
    if transpose:
        def pad(k):
            total = max(k - stride, 0)
            return (k - 1 - total // 2, k - 1 - (total - total // 2))

        y = lax.conv_general_dilated(jnp.asarray(xq), jnp.flip(jnp.asarray(kq), axis=(0, 1)), (1, 1),
                                     [pad(kq.shape[0]), pad(kq.shape[1])], lhs_dilation=(stride, stride),
                                     dimension_numbers=dn, preferred_element_type=jnp.int32)
    else:
        y = lax.conv_general_dilated(jnp.asarray(xq), jnp.asarray(kq), (1, 1), "SAME", dimension_numbers=dn,
                                     preferred_element_type=jnp.int32)
    return np.asarray(y)


@pytest.mark.parametrize(
    "n,h,w,cin,cout,k,transpose",
    [(3, 12, 10, 16, 8, 3, False), (2, 9, 7, 1, 8, 3, False), (2, 8, 8, 6, 4, 1, False),
     (3, 6, 5, 16, 8, 3, True), (1, 2, 2, 5, 3, 3, True), (2, 7, 6, 32, 16, 2, True)],
    ids=["conv", "cin1", "head1x1", "transpose", "tiny_m", "transpose_k2"],
)
def test_int32_accumulators_match_xla(monkeypatch, n, h, w, cin, cout, k, transpose):
    """Bit-equal int32 sums for one int8 input; ``SLAB_BYTES`` small enough
    that the batch runs in one-image chunks."""
    monkeypatch.setattr(tq, "SLAB_BYTES", 1)
    rng = np.random.default_rng(n * h + cin)
    xq = rng.integers(-127, 128, (n, h, w, cin)).astype(np.int8)
    kq = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    got = tq.qconv_int32(torch.from_numpy(xq), torch.from_numpy(kq), transpose)
    want = _jax_int32(xq, kq, transpose)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("transpose", [False, True], ids=["conv", "transpose"])
def test_skipped_layer_runs_the_float_bf16_conv_as_jax(transpose):
    """A layer left in float (``skip``) runs the bf16 conv of the JAX
    package's ``qconv2d``: the kernel cast to bf16, the bias added after
    the rounding; within one bf16 rounding of the JAX result (the two sum
    in float32 in different orders)."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 6, 5, 8)).astype(np.float32)
    p = {"kernel": rng.normal(0, 0.3, (3, 3, 8, 4)).astype(np.float32), "bias": rng.normal(0, 0.1, 4).astype(np.float32)}
    want = np.asarray(jq.qconv2d(jnp.asarray(x, jnp.bfloat16), jax.tree.map(jnp.asarray, p), transpose=transpose), np.float32)
    got = tq.qconv2d(torch.from_numpy(x).to(torch.bfloat16), {k: torch.from_numpy(v) for k, v in p.items()}, transpose=transpose)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7, atol=2**-7)


def test_forward_matches_jax_int8_forward(tree):
    x = _blobs()
    want = np.asarray(jq.forward(jq.quantize_unet(jax.tree.map(jnp.asarray, tree)), jnp.asarray(x)))
    got = tq.forward(tq.quantize_unet(tree), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 64, 64, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
    agreement = float((got.argmax(-1) == want.argmax(-1)).mean())
    assert agreement >= JAX_AGREEMENT, agreement


def test_module_matches_functional_forward_and_agrees_with_float32(tree):
    """``QuantMetasegUNet`` (built through the weight bridge from the numpy
    tree) runs the functional forward on its buffers; its labels agree with
    the float32 U-Net's; its int8 weights are about a quarter of float32's."""
    x = torch.from_numpy(_blobs())
    model = quant_params_from_numpy(tree)
    assert model.layers["up1"].weight.dtype == torch.int8
    assert model.layers["up1"].weight.shape == (16, 8, 3, 3)  # ConvTranspose2d's (in, out, kh, kw)
    assert model.layers["enc2_1"].weight.shape == (16, 8, 3, 3)  # OIHW
    with torch.no_grad():
        got = model(x)
        ref = params_from_numpy(tree)(x)
    np.testing.assert_array_equal(got.numpy(), tq.forward(tq.quantize_unet(tree), x).numpy())
    agreement = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    assert agreement >= FLOAT_AGREEMENT, agreement
    int8_bytes = sum(b.numel() * b.element_size() for b in model.buffers())
    f32_bytes = sum(a.size * 4 for p in tree.values() for a in p.values())
    assert int8_bytes < 0.35 * f32_bytes


def test_quant_params_refuse_another_tree(tree):
    bad = dict(tree)
    del bad["dec1_2"]
    with pytest.raises(ValueError, match="do not match"):
        quant_params_from_numpy(bad)
