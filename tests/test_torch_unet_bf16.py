"""The port's bf16 U-Net forward and ``forward_cat1`` against
``ecseg_tpu.models.metaseg_unet.forward``/``forward_cat1(dtype=bfloat16)``
at narrow widths, both settings of ``ECSEG_SPLIT_CONCAT``, and the weight
bridge on a bf16 parameter tree (what ``bench._realistic_params`` returns).

Tolerances: probabilities within 2e-3.  Both sides round every layer's
output to bf16 (8 significant bits) at the same points, but sum each conv in
another order, so an activation can land one bf16 ulp apart and carry that
to the softmax; the measured worst case on these cases is 3.3e-4.  Labels
(the argmax of the exact uint8 quantize) agree on >= 99 % of the pixels on
random weights, whose near-uniform softmax puts many pixels within an ulp of
a quantize tie, and on every pixel on ``bench._realistic_params`` weights.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ecseg_tpu.models import metaseg_unet as ju
from ecseg_tpu.ops.tiling import quantize_u8_jax
from ecseg_torch.models import metaseg_unet as tu
from ecseg_torch.models.weights import params_from_numpy, params_to_numpy
from ecseg_torch.ops.tiling import patch_labels

from _torchutil import bench_realistic_params, numpy_metaseg_tree, single_torch_thread  # noqa: F401 (autouse fixture)

ARCHS = {"two_levels": ((4, 8), 16), "three_levels": ((4, 8, 16), 32)}
PROB_ATOL = 2e-3


def _bf16_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)


def _port(tree_bf16):
    return params_from_numpy(jax.tree.map(np.asarray, tree_bf16)).to(torch.bfloat16).eval()


def _jax(fn, tree_bf16, x):
    # a fresh jit per call: the JAX package reads ECSEG_SPLIT_CONCAT at trace time
    return np.asarray(jax.jit(functools.partial(fn, dtype=jnp.bfloat16))(tree_bf16, jnp.asarray(x)))


def _patches(seed, n=2):
    return (np.random.default_rng(seed).random((n, 256, 256, 1)) * 255).astype(np.uint8)


def _agreement(got_probs, want_probs):
    want = np.asarray(quantize_u8_jax(jnp.asarray(want_probs))).argmax(-1)
    return float((patch_labels(torch.from_numpy(got_probs)).numpy() == want).mean())


@pytest.mark.parametrize("split", ["0", "1"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bf16_forward_matches_jax_on_random_weights(monkeypatch, arch, split):
    monkeypatch.setenv("ECSEG_SPLIT_CONCAT", split)
    widths, bott = ARCHS[arch]
    tree = _bf16_tree(numpy_metaseg_tree(widths, bott, seed=len(widths)))
    x = _patches(len(widths))
    want = _jax(ju.forward, tree, x)
    with torch.no_grad():
        got = _port(tree)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 256, 256, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=PROB_ATOL, rtol=0)
    assert _agreement(got.numpy(), want) >= 0.99


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bf16_forward_cat1_matches_jax(monkeypatch, arch):
    """The level-1 concat in bf16: equal up to one bf16 ulp (2**-7
    relative) for the reason stated above, and within 2**-8 absolute where
    a ReLU'd sum of larger terms lands near 0 (measured worst 9.8e-4)."""
    monkeypatch.setenv("ECSEG_SPLIT_CONCAT", "1")
    widths, bott = ARCHS[arch]
    tree = _bf16_tree(numpy_metaseg_tree(widths, bott, seed=7))
    x = _patches(7)
    want = _jax(ju.forward_cat1, tree, x).astype(np.float32)
    with torch.no_grad():
        got = _port(tree).forward_cat1(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 256, 256, 2 * widths[0])
    assert got.is_contiguous()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7, atol=2**-8)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bf16_forward_on_realistic_weights_labels_equal(arch):
    widths, bott = ARCHS[arch]
    tree = bench_realistic_params(widths, bott)
    x = _patches(11)
    want = _jax(ju.forward, tree, x)
    with torch.no_grad():
        got = _port(tree)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)
    assert _agreement(got, want) == 1.0


def test_bridge_takes_a_bf16_tree():
    """``params_from_numpy`` on the bf16 tree ``bench._realistic_params``
    returns (left in bf16) round-trips through ``params_to_numpy`` to the
    same float32 values: bf16 -> float32 is exact."""
    tree = jax.tree.map(np.asarray, bench_realistic_params(*ARCHS["two_levels"]))
    assert tree["enc2_1"]["kernel"].dtype != np.float32  # ml_dtypes bfloat16
    back = params_to_numpy(params_from_numpy(tree))
    assert set(back) == set(tree)
    for name in tree:
        for k in ("kernel", "bias"):
            assert back[name][k].dtype == np.float32
            np.testing.assert_array_equal(back[name][k], tree[name][k].astype(np.float32))


def test_flops_per_patch_matches_jax():
    for widths, bott in [(tu.ENC_WIDTHS, tu.BOTTLENECK), (tu.ENC_WIDTHS_XL, tu.BOTTLENECK_XL), ((4, 8), 16)]:
        assert tu.flops_per_patch(widths, bott) == ju.flops_per_patch(widths, bott)


@pytest.mark.parametrize("value,want", [("1", True), (" On ", True), ("yes", True), ("0", False), ("", False), ("2", False)])
def test_split_concat_parsing(monkeypatch, value, want):
    monkeypatch.setenv("ECSEG_SPLIT_CONCAT", value)
    assert tu.split_concat() is want
