"""The port's U-Net (ecseg_torch/models) against ecseg_tpu's
metaseg_unet.forward, the layers against ecseg_tpu/models/layers, and the
weight bridge and demo crafting against the JAX parameter tree."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ecseg_tpu.models import layers as jl
from ecseg_tpu.models import metaseg_unet as ju
from ecseg_tpu.models.keras_import import save_npz_pytree
from ecseg_tpu.ops.tiling import quantize_u8_jax
from ecseg_torch.models import layers as tl
from ecseg_torch.models.demo import demo_metaseg_params
from ecseg_torch.models.metaseg_unet import MetasegUNet
from ecseg_torch.models.weights import load_npz, params_from_numpy, params_to_numpy, save_npz
from ecseg_torch.ops.tiling import patch_labels

from _torchutil import numpy_metaseg_tree, single_torch_thread  # noqa: F401 (autouse fixture)


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _check_forward(tree, x):
    """Probabilities within 1e-5 (float32 convs summed in another order);
    u8 argmax labels equal except where JAX's top-2 byte gap is <= 1."""
    want = np.asarray(jax.jit(ju.forward)(tree, jnp.asarray(x)))
    model = params_from_numpy(tree).eval()
    with torch.no_grad():
        probs = model(torch.from_numpy(x))
    np.testing.assert_allclose(probs.numpy(), want, atol=1e-5, rtol=0)
    q = np.asarray(quantize_u8_jax(jnp.asarray(want))).astype(np.int16)
    top2 = np.sort(q, axis=-1)[..., -2:]
    close = (top2[..., 1] - top2[..., 0]) <= 1
    diff = patch_labels(probs).numpy() != q.argmax(-1)
    assert not (diff & ~close).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_tiny_widths(seed):
    tree = numpy_metaseg_tree((8, 16), 32, seed=seed)
    x = (np.random.default_rng(seed).random((2, 256, 256, 1)) * 255).astype(np.uint8)
    _check_forward(tree, x)


def test_forward_default_widths_one_patch():
    tree = numpy_metaseg_tree(seed=3)
    x = (np.random.default_rng(3).random((1, 256, 256, 1)) * 255).astype(np.uint8)
    _check_forward(tree, x)


def test_bridge_round_trip_through_npz(tmp_path):
    ref = numpy_metaseg_tree((8, 16), 32, seed=4)
    path = str(tmp_path / "metaseg.npz")
    save_npz_pytree(path, ref)
    tree = load_npz(path)
    back = params_to_numpy(params_from_numpy(tree))
    assert set(back) == set(ref)
    for name in ref:
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(back[name][k], ref[name][k])
    path2 = str(tmp_path / "again.npz")
    save_npz(path2, back)
    again = load_npz(path2)
    for name in ref:
        np.testing.assert_array_equal(again[name]["kernel"], ref[name]["kernel"])


@pytest.mark.parametrize("size", [8, 9])
def test_transpose_conv_matches_jax(rng, size):
    x = rng.standard_normal((1, size, size, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = np.asarray(jl.conv2d_transpose(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    layer = tl.TFConvTranspose2d(4, 6)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w).permute(2, 3, 0, 1))
        layer.bias.copy_(torch.from_numpy(b))
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [8, 9])
def test_max_pool_matches_jax(rng, size):
    x = rng.standard_normal((1, size, size, 2)).astype(np.float32)
    want = np.asarray(jl.max_pool(jnp.asarray(x)))
    got = tl.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_is_glorot_and_seeded():
    a = MetasegUNet((8, 16), 32, generator=torch.Generator().manual_seed(5))
    b = MetasegUNet((8, 16), 32, generator=torch.Generator().manual_seed(5))
    for (name, la), lb in zip(a.layers.items(), b.layers.values()):
        assert torch.equal(la.weight, lb.weight)
        assert not la.bias.any()
        tree = params_to_numpy(a)[name]["kernel"]
        kh, kw, cin, cout = tree.shape
        assert np.abs(tree).max() <= np.sqrt(6.0 / (kh * kw * (cin + cout)))


def test_demo_crafting_matches_jax_demo():
    from ecseg_tpu.models.demo import demo_metaseg_params as jax_demo

    want = _tree(jax_demo())
    got = params_to_numpy(demo_metaseg_params(torch.Generator().manual_seed(0)))
    for name in ("enc1_1", "enc1_2", "dec1_1", "dec1_2", "head"):
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(got[name][k], want[name][k])
    assert {n: v["kernel"].shape for n, v in got.items()} == {
        n: v["kernel"].shape for n, v in want.items()
    }
